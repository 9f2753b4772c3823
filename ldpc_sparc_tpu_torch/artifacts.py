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
  (tests/test_campaign_artifact.py's bound).

`run_sweep_rows` and `run_campaign_point` run the port at an artifact's
configuration: `sparc_ber_sweep`, and the campaign's per-point counter
(`_ldpc_block_counts`, one call a batch, through K4 on a card).
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
