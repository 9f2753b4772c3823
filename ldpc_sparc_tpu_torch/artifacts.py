"""Hold the port's Monte-Carlo results to the JAX package's committed ones.

`docs/artifacts/` holds what the JAX package measured: the SPARC sweeps
(`flagship_sweep.json`, `pa_sweep.json`, `sc_sweep.json`,
`modulated_sweep.json`, the `jax` side of `oracle_parity_mod*.json`) and
the LDPC waterfall campaign (`campaign_tpu.json`). A machine without JAX
can hold the port to those files alone:

* a sweep row: FER, and SER (LER and VER for modulated codes), within the
  two-sided 99.9 % two-sample bound 3.29 sqrt(p (1 - p) (1/n1 + 1/n2)),
  p the pooled rate, n1 and n2 the two rows' frame counts. For FER this is
  the binomial bound; for the section rates it is conservative, since a
  frame's section-error rate lies in [0, 1] and so varies by at most
  p (1 - p) however its errors cluster;
* a campaign point: BER within max(5 sigma, 0.02) of the artifact's point
  at the same SNR and of each reference point within 0.1 dB, sigma the
  binomial deviation of both with a burst factor of 8
  (tests/test_campaign_artifact.py's bound);
* a min-sum waterfall point (`minsum_campaign.json`): the block error rate
  within the two-sample bound above, blocks being independent draws (the
  campaign's 0.02 BER floor would pass any point there, whose BER is 2e-2 to
  1e-4); the whole waterfall's SNR at BER 1e-4, interpolated in log BER,
  within 0.15 dB of the artifact's;
* a semi-protected concatenated row (`concat_sweep_semi.jsonl`, matched by
  its store key): BER within the larger of a bit bound, the two-sample
  bound on bits with a section error counted as logM bit errors, and a frame
  bound from the two rows' own spread (`semi_bounds`).

`run_sweep_rows`, `run_campaign_point` and `run_semi_rows` run the port at
an artifact's configuration: `sparc_ber_sweep`, the campaign's per-point
counter (`_ldpc_block_counts`, one call a batch, through K4 on a card), and
`concat-sweep --semi-protected`.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

from .config import DecodeParams, LdpcParams, SparcParams

ARTIFACTS = Path(__file__).resolve().parent.parent / "docs" / "artifacts"
# the SparcParams fields an artifact's "config" may name
_PARAM_KEYS = ("P", "R", "L", "M", "is_complex", "modulated", "K", "power_allocated",
               "B", "R_PA_ratio", "spatially_coupled", "omega", "Lambda")
Z_999 = 3.29          # two-sided 99.9 % normal quantile
CAMPAIGN_BURST, CAMPAIGN_SIGMAS, CAMPAIGN_FLOOR = 8.0, 5.0, 0.02
# the K=1 sweep rows held on the card: one SNR on each file's cliff, one in
# its tail
K1_SWEEP_ROWS = {"flagship_sweep.json": (3.875, 4.5), "pa_sweep.json": (10.0, 15.0),
                 "sc_sweep.json": (9.5, 11.0)}
# campaign_tpu.json's 802.16 r=1/2 z=27 A, at its points near 2.0 and 2.4 dB
CAMPAIGN_SIM_ID, CAMPAIGN_SNRS = 7, (2.013853986772472, 2.3901275025040207)
# minsum_campaign.json: its three codes, the campaign's default block cap
# (the artifact's run left it so), and the hold on the SNR at BER 1e-4
MINSUM_ARTIFACT = "minsum_campaign.json"
MINSUM_CODES = (("802.16", "1/2"), ("802.11n", "1/2"), ("802.16", "3/4"))
MINSUM_MAX_BLOCKS, MINSUM_TARGET_BER, MINSUM_SNR_TOL_DB = 400000, 1e-4, 0.15
# concat_sweep_semi.jsonl: the three configurations at 25 runs a point, held
# at the sequential decoder's cliff and floor (linear SNR 3.333 and 6.0, the
# 4th and 10th of the sweep's linspace(2, 6, 10)); naive at the floor only
SEMI_ARTIFACT, SEMI_RUNS = "concat_sweep_semi.jsonl", 25
SEMI_PROTECTED = (0.9, 0.8, 0.7)
SEMI_SNRS = (10 / 3, 6.0)
SEMI_DECODERS = {SEMI_SNRS[0]: ("amp_only", "sequential"),
                 SEMI_SNRS[1]: ("amp_only", "sequential", "naive")}
# half the smallest gap between neighbouring sequential floors (0.0242):
# a larger bound at the floor could not tell 0.9 from 0.8
SEMI_FLOOR_BOUND = 0.012


def load(name: str) -> dict:
    """The JSON document `docs/artifacts/<name>`."""
    return json.loads((ARTIFACTS / name).read_text())


def two_sample_bound(p1: float, n1: int, p2: float, n2: int) -> float:
    """The largest |p1 - p2| the bound above allows."""
    p = (p1 * n1 + p2 * n2) / (n1 + n2)
    return Z_999 * math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))


def sweep_config(name: str) -> tuple[SparcParams, int, list[dict]]:
    """(params, t_max, rows) of a sweep artifact. Each row has snr,
    awgn_var, frames and its rates (ber, ser, fer; ler and ver where the
    file has them): `rows` of the sweep files, the `jax` side of the
    `points` of the oracle-parity files."""
    doc = load(name)
    cfg = doc["config"]
    params = SparcParams(**{k: cfg[k] for k in _PARAM_KEYS if k in cfg})
    if "rows" in doc:
        rows = [dict(r, frames=r.get("frames", cfg.get("trials_per_point")))
                for r in doc["rows"]]
    else:
        rows = [dict(p["jax"], snr=p["snr"], awgn_var=p["awgn_var"],
                     frames=p["jax"]["trials"]) for p in doc["points"]]
    return params, cfg["t_max"], rows


def compare_sweep(name: str, port_rows: list[dict], keys=("fer", "ser")) -> list[dict]:
    """Each port row (with snr and frames) against the artifact's row at
    the same SNR, for each rate in `keys`: a list of {snr, key, port,
    artifact, bound, ok}. Raises KeyError where the artifact has no row at a
    port row's SNR."""
    _, _, art = sweep_config(name)
    out = []
    for r in port_rows:
        match = [a for a in art if abs(a["snr"] - r["snr"]) < 1e-6]
        if not match:
            raise KeyError(f"{name} has no row at SNR {r['snr']}")
        a = match[0]
        for k in keys:
            bound = two_sample_bound(r[k], r["frames"], a[k], a["frames"])
            out.append({"snr": r["snr"], "key": k, "port": r[k], "artifact": a[k],
                        "bound": bound, "ok": abs(r[k] - a[k]) <= bound})
    return out


def campaign_config(sim_id: int) -> dict:
    """The configuration of `campaign_tpu.json` with this sim_id: standard,
    rate, z, ptype, protocol, points and reference_points."""
    [cfg] = [c for c in load("campaign_tpu.json")["configs"] if c["sim_id"] == sim_id]
    return cfg


def compare_campaign_point(cfg: dict, record) -> list[dict]:
    """A campaign record (standard, rate, z, ptype, snr, nblocks,
    nblockerrors, nbits, nbiterrors, niters) against the artifact's point at
    the same SNR and every reference point within 0.1 dB: a list of
    {against, snr, port, artifact, bound, ok}. Raises KeyError where the
    artifact has no point at the record's SNR."""
    snr, nbits, nbiterr = record[4], record[7], record[8]
    ber = nbiterr / nbits
    K = nbits // record[5]
    own = [p for p in cfg["points"] if abs(p["snr"] - snr) < 1e-6]
    if not own:
        raise KeyError(f"campaign sim {cfg['sim_id']} has no point at {snr} dB")
    others = [("points", own[0], own[0]["nbits"])]
    others += [("reference_points", p, p["nblocks"] * K) for p in cfg["reference_points"]
               if abs(p["snr"] - snr) <= 0.1]
    out = []
    for against, p, bits in others:
        sig = math.sqrt(CAMPAIGN_BURST * (ber * (1 - ber) / nbits
                                          + p["ber"] * (1 - p["ber"]) / bits))
        bound = max(CAMPAIGN_SIGMAS * sig, CAMPAIGN_FLOOR)
        out.append({"against": against, "snr": p["snr"], "port": ber,
                    "artifact": p["ber"], "bound": bound,
                    "ok": abs(ber - p["ber"]) < bound})
    return out


def run_sweep_rows(name: str, snrs, n_trials: int | None = None, seed=0,
                   device=None) -> list[dict]:
    """`sparc_ber_sweep` at the configuration of sweep artifact `name` and
    the awgn_var of its rows at `snrs`, n_trials a row (the artifact's
    frames by default); each row gains its snr."""
    from .parallel.montecarlo import sparc_ber_sweep
    params, t_max, art = sweep_config(name)
    rows = [a for s in snrs for a in art if abs(a["snr"] - s) < 1e-6]
    if len(rows) != len(snrs):
        raise KeyError(f"{name} has no row at some of the SNRs {snrs}")
    out = sparc_ber_sweep(params, DecodeParams(t_max=t_max), [a["awgn_var"] for a in rows],
                          seed, n_trials or rows[0]["frames"], device=device)
    for r, a in zip(out, rows):
        r["snr"] = a["snr"]
    return out


def run_campaign_point(cfg: dict, snr: float, seed=0, device=None,
                       bp_kernel: bool = True):
    """The port's waterfall campaign at one SNR (dB) under the protocol of
    campaign configuration `cfg`: batches of random codewords until
    min_errors block errors (or max_blocks), each batch one
    `_ldpc_block_counts` call. Returns the 10-field record."""
    from .parallel.montecarlo import ldpc_waterfall_campaign
    pr = cfg["protocol"]
    [rec] = ldpc_waterfall_campaign(
        LdpcParams(cfg["standard"], cfg["rate"], cfg["z"], cfg["ptype"]), seed=seed,
        n_measurements=1, start_snr=snr, min_errors=pr["min_errors"],
        max_blocks=pr["max_blocks"], batch=pr["batch"], dectype=pr["dectype"],
        max_iters=pr["max_iters"], pipelined=False, bp_kernel=bp_kernel, device=device)
    return rec


def minsum_config(standard: str, rate: str) -> dict:
    """The code of `minsum_campaign.json` with this standard and rate:
    standard, rate, z, ptype, its 22 `minsum_points` (snr, nblocks, nblkerr,
    nbits, nbiterr, ber), `snr_at_1e-4_minsum`, and the run's `protocol`
    (batch, dectype, corr_factor, max_iters, min_errors, max_blocks)."""
    doc = load(MINSUM_ARTIFACT)
    [cfg] = [c for c in doc["configs"] if (c["standard"], c["rate"]) == (standard, rate)]
    return dict(cfg, protocol=dict(doc["protocol"], max_blocks=MINSUM_MAX_BLOCKS))


def minsum_held_points(cfg: dict) -> tuple[dict, dict]:
    """The two points of a min-sum waterfall held on the card: its cliff (the
    last point of a single batch) and the point whose BER lies nearest 1e-4
    in log."""
    batch = cfg["protocol"]["batch"]
    cliff = [p for p in cfg["minsum_points"] if p["nblocks"] == batch][-1]
    near = min(cfg["minsum_points"],
               key=lambda p: abs(math.log10(max(p["ber"], 1e-300) / MINSUM_TARGET_BER)))
    return cliff, near


def compare_minsum_point(cfg: dict, record) -> dict:
    """A campaign record (the 10-field tuple) against the min-sum point of
    `cfg` at the same SNR: {snr, port, artifact, bound, ok, port_ber,
    artifact_ber}, port and artifact being block error rates. Raises
    KeyError where the artifact has no point at the record's SNR."""
    snr, nblocks, nblkerr = record[4], record[5], record[6]
    own = [p for p in cfg["minsum_points"] if abs(p["snr"] - snr) < 1e-6]
    if not own:
        raise KeyError(f"{cfg['standard']} r={cfg['rate']} has no min-sum point at {snr} dB")
    a = own[0]
    port, art = nblkerr / nblocks, a["nblkerr"] / a["nblocks"]
    bound = two_sample_bound(port, nblocks, art, a["nblocks"])
    return {"snr": snr, "port": port, "artifact": art, "bound": bound,
            "ok": abs(port - art) <= bound, "port_ber": record[8] / record[7],
            "artifact_ber": a["ber"]}


def snr_at_ber(points, target: float = MINSUM_TARGET_BER):
    """The SNR (dB) where a waterfall's BER crosses `target`, interpolated
    linearly in log BER; the last bracketing pair wins, and a point with no
    bit error counts a tenth of one (benchmarks/minsum_campaign.py's rule,
    which made the artifact's `snr_at_1e-4_minsum`). None if the waterfall
    never reaches the target. Points: dicts with snr, ber and nbits."""
    pts = sorted((p["snr"], max(p["ber"], 0.1 / max(p.get("nbits", 1), 1)))
                 for p in points)
    best = None
    for (s0, b0), (s1, b1) in zip(pts, pts[1:]):
        if b0 >= target >= b1:
            if b0 == b1:
                best = float(s0)
                continue
            f = (math.log10(b0) - math.log10(target)) / (math.log10(b0) - math.log10(b1))
            best = float(s0 + f * (s1 - s0))
    if best is not None:
        return best
    if pts and pts[-1][1] <= target:
        return float(pts[-1][0])
    return None


def record_point(record) -> dict:
    """A campaign record as a waterfall point (snr, nblocks, nblkerr, nbits,
    nbiterr, ber), the artifact's fields."""
    return {"snr": record[4], "nblocks": record[5], "nblkerr": record[6],
            "nbits": record[7], "nbiterr": record[8], "ber": record[8] / record[7]}


def semi_configs(runs: int = SEMI_RUNS) -> dict:
    """{percent_protected: (meta config, store key's hash, {row key: row})}
    of `concat_sweep_semi.jsonl`'s semi-protected configurations at `runs`
    runs a point."""
    lines = [json.loads(ln) for ln in (ARTIFACTS / SEMI_ARTIFACT).read_text().splitlines()
             if ln.strip()]
    out = {}
    for m in lines:
        cfg = m.get("config")
        if cfg is None or cfg.get("runs") != runs or not cfg.get("semi_protected"):
            continue
        h = m["key"].split(":", 1)[1]
        out[cfg["percent_protected"]] = (cfg, h, {r["key"]: r for r in lines
                                                  if r["key"].startswith(f"concat:{h}:")})
    return out


def semi_row_key(cfg_hash: str, decoder: str, snr: float, seed: int = 0) -> str:
    """The concat-sweep store key of one row (the JAX CLI's)."""
    return f"concat:{cfg_hash}:{decoder}:snr{snr:.3f}:s{seed}"


def semi_bounds(r1: dict, r2: dict, logM: int) -> tuple[float, float]:
    """(bit bound, frame bound) on |BER1 - BER2| of two concat-sweep rows:
    Z_999 sqrt(logM (p1 (1 - p1) / bits1 + p2 (1 - p2) / bits2)), a section
    error flipping up to logM bits; and Z_999 sqrt(((max1 - min1) / 2)^2 /
    frames1 + ((max2 - min2) / 2)^2 / frames2), from each row's spread of
    per-frame BER. The hold takes the larger."""
    bit = Z_999 * math.sqrt(logM * (r1["ber"] * (1 - r1["ber"]) / r1["bits"]
                                    + r2["ber"] * (1 - r2["ber"]) / r2["bits"]))
    frame = Z_999 * math.sqrt(((r1["ber_max"] - r1["ber_min"]) / 2) ** 2 / r1["frames"]
                              + ((r2["ber_max"] - r2["ber_min"]) / 2) ** 2 / r2["frames"])
    return bit, frame


def compare_semi_row(port: dict, art: dict, logM: int) -> dict:
    """A port row against the artifact's row of the same key: {key, port,
    artifact, bit_bound, frame_bound, bound, ok}."""
    bit, frame = semi_bounds(port, art, logM)
    bound = max(bit, frame)
    return {"key": art["key"], "port": port["ber"], "artifact": art["ber"],
            "bit_bound": bit, "frame_bound": frame, "bound": bound,
            "ok": abs(port["ber"] - art["ber"]) <= bound}


def semi_floor_law(floors: dict) -> list[str]:
    """What fails of the law tests/test_sweep_artifacts.py gates the artifact
    on: {percent_protected: {decoder: floor BER}} must have the sequential
    floor rise strictly as percent_protected falls, and naive's stay above
    0.1 (M=64: BP helps only at small error rates). Empty when it holds."""
    pps = sorted(floors, reverse=True)
    seq = [floors[pp]["sequential"] for pp in pps]
    bad = [] if all(a < b for a, b in zip(seq, seq[1:])) else [
        f"sequential floors {dict(zip(pps, seq))} do not rise as the protected share falls"]
    return bad + [f"naive floor {floors[pp]['naive']} <= 0.1 at {pp}" for pp in pps
                  if "naive" in floors[pp] and not floors[pp]["naive"] > 0.1]


def run_semi_rows(percent_protected: float, out, device=None,
                  runs: int = SEMI_RUNS) -> dict:
    """The port's `concat-sweep --semi-protected` at the artifact's
    configuration (802.11n r=5/6 z=81, M=64, R_sparc 0.8, mults 3, t_max 25,
    P 19.44, seed 0), the decoders of `SEMI_DECODERS` at each of `SEMI_SNRS`
    into the store under `out`; returns {row key: row} of the store."""
    import contextlib
    import io

    from . import cli
    dev = ["--device", str(device)] if device is not None else []
    with contextlib.redirect_stdout(io.StringIO()):
        for snr, decoders in SEMI_DECODERS.items():
            cli.main(["concat-sweep", "--semi-protected", "--percent-protected",
                      repr(percent_protected), "--standard", "802.11n", "--rate", "5/6",
                      "--z", "81", "--mults", "3", "--logM", "6", "--R-sparc", "0.8",
                      "--t-max", "25", "--P", "19.44", "--runs", str(runs), "--num-snrs", "1",
                      "--snr-start", repr(snr), "--snr-stop", repr(snr),
                      "--decoders", ",".join(decoders), "--seed", "0",
                      "--out", str(out), *dev])
    path = Path(out) / "concat_sweep_semi.jsonl"
    rows = [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]
    return {r["key"]: r for r in rows}
