"""The port's SPARC Monte Carlo (parallel/montecarlo.py), its results store
(io/results.py) and its `sparc-sweep` CLI against the JAX package's.

The two packages draw bits and noise from other generators, so their
counters agree statistically: at a small SC code near its threshold, over
256 trials each (the same 8 designs in both: the designs are bit-identical
from one seed), FER and SER must differ by less than the two-sided 99.9 %
bound of a two-sample test, 3.29 * sqrt(p (1 - p) (2 / n)) with the pooled
rate p over n = 256 frames. For FER that is the binomial bound; for SER it
is conservative, since a frame's section-error rate lies in [0, 1] and so
has a variance of at most p (1 - p), however its errors cluster. The seeds
are fixed, so the test is deterministic. Within the port the counters are
exact functions of (seed, trial): regrouping the trials changes nothing.
"""

import json
import math

import numpy as np
import pytest
import torch

from ldpc_sparc_tpu import cli as jcli
from ldpc_sparc_tpu.config import DecodeParams as JDecode
from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.io import results as jresults
from ldpc_sparc_tpu.parallel.montecarlo import sparc_mc_counts as jmc
from ldpc_sparc_tpu_torch import DecodeParams, SparcParams, cli
from ldpc_sparc_tpu_torch.io import results as tresults
from ldpc_sparc_tpu_torch.models.sparc import awgn_channel, decode_batch
from ldpc_sparc_tpu_torch.ops.transforms import stack_designs
from ldpc_sparc_tpu_torch.parallel import montecarlo as tmc
from ldpc_sparc_tpu_torch.utils import bits as bitops
from ldpc_sparc_tpu_torch.utils import rng as rngmod

SC = dict(P=15.0, R=1.2, L=64, M=16, spatially_coupled=True, omega=2, Lambda=4)
KEYS = {"bit_errs", "bits", "sec_errs", "sections", "frame_errs", "frames", "iters"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (the suite runs files in parallel);
    float32 matmuls at full precision (no TF32)."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _bound(k1, k2, n):
    p = (k1 + k2) / (2 * n)
    return 3.29 * math.sqrt(p * (1 - p) * 2 / n)


def test_counts_agree_with_jax_near_threshold():
    n = 256
    got = tmc.sparc_mc_counts(SparcParams(**SC), DecodeParams(t_max=20), 2.0, 0, n,
                              device="cpu")
    want = jmc(JParams(**SC), JDecode(t_max=20), 2.0, 0, n)
    assert set(got) == KEYS and {k: got[k] for k in ("bits", "sections", "frames")} \
        == {k: want[k] for k in ("bits", "sections", "frames")}
    assert 0.2 < got["frame_errs"] / n < 0.8          # near the threshold
    assert abs(got["frame_errs"] - want["frame_errs"]) / n <= _bound(
        got["frame_errs"], want["frame_errs"], n)
    m = got["sections"]
    p = (got["sec_errs"] + want["sec_errs"]) / (2 * m)
    assert abs(got["sec_errs"] - want["sec_errs"]) / m <= \
        3.29 * math.sqrt(p * (1 - p) * 2 / n)


@pytest.mark.parametrize("n_trials,n_designs", [(7, 1), (7, 2), (7, 3), (3, 9)])
def test_counts_do_not_depend_on_batching(n_trials, n_designs):
    """The counters equal the sums over the trials each decoded alone."""
    params, decode, var, seed = SparcParams(**SC), DecodeParams(t_max=15), 1.8, 4
    designs = stack_designs(params, var, seed, n_designs, device="cpu")
    want = dict.fromkeys(("bit_errs", "sec_errs", "frame_errs", "iters"), 0)
    for t in range(n_trials):
        design = designs[t % n_designs]
        gen = rngmod.root_generator(rngmod.derive(seed, t), "cpu")
        bits = bitops.random_bits(gen, params.bit_len)[None]
        beta0 = bitops.bits_to_msg_vector(bits, params.M)
        y = awgn_channel(design.ab(beta0)[0], var, gen)[None]
        beta, t_final = decode_batch(y, design, params, decode, var)
        be = int((bitops.msg_vector_to_bits(beta, params.M) != bits).sum())
        want["bit_errs"] += be
        want["sec_errs"] += int((beta != beta0).reshape(params.L, -1).any(-1).sum())
        want["frame_errs"] += be > 0
        want["iters"] += int(t_final.sum())
    got = tmc.sparc_mc_counts(params, decode, var, seed, n_trials, n_designs,
                              device="cpu")
    assert {k: got[k] for k in want} == want
    assert 0 < want["frame_errs"] or n_trials < 7     # errors are counted


def test_counts_with_2mm_and_errors():
    params = SparcParams(**SC)
    a = tmc.sparc_mc_counts(params, DecodeParams(t_max=15), 0.5, 1, 4,
                            device="cpu")
    b = tmc.sparc_mc_counts(params, DecodeParams(t_max=15), 0.5, 1, 4,
                            fwht_mode="2mm", device="cpu")
    # Mc = 256 < 2^14: "2mm" keeps the float32 transform, as the JAX package does
    assert a == b and a["bit_errs"] == 0 and a["frames"] == 4
    # modulated and complex codes, once refused, are counted (the modulated
    # split in tests/test_torch_modulated.py)
    mod = tmc.sparc_mc_counts(SparcParams(P=15.0, R=1.0, L=64, M=16, modulated=True,
                                          K=2), DecodeParams(t_max=5), 1.0, 0, 2,
                              device="cpu")
    assert set(mod) == KEYS | {"loc_errs", "val_errs"} and mod["bits"] == 2 * 64 * 5
    cx = tmc.sparc_mc_counts(SparcParams(P=15.0, R=1.0, L=64, M=16, is_complex=True),
                             DecodeParams(t_max=5), 1.0, 0, 2, device="cpu")
    assert set(cx) == KEYS and cx["frames"] == 2


def test_ber_sweep_rows_are_well_formed():
    rows = tmc.sparc_ber_sweep(SparcParams(**SC), DecodeParams(t_max=15),
                               [2.0, 0.5], 0, 6, device="cpu")
    assert [r["awgn_var"] for r in rows] == [2.0, 0.5]
    for r in rows:
        assert set(r) == KEYS | {"awgn_var", "ber", "ser", "fer", "avg_iters"}
        assert r["ber"] == r["bit_errs"] / r["bits"] and 0 <= r["fer"] <= 1
        assert r["avg_iters"] == r["iters"] / r["frames"]
    assert rows[1]["ber"] <= rows[0]["ber"]


def test_results_store_is_shared_with_jax(tmp_path):
    path = tmp_path / "store.jsonl"
    jstore = jresults.ResultsStore(path)
    jstore.append("a", {"ber": 0.5, "rows": [1, 2]})
    tstore = tresults.ResultsStore(path)
    assert tstore.get("a") == {"key": "a", "ber": 0.5, "rows": [1, 2]}
    tstore.append("b", {"ber": 0.25})
    tstore.append("a", {"ber": 0.125})
    again = jresults.ResultsStore(path)
    assert again.records() == tresults.ResultsStore(path).records()
    assert again.get("a")["ber"] == 0.125 and again.has("b")


def test_record_helpers_match_jax(tmp_path):
    recs = [("802.11n", "1/2", 27, 1.0, 128, 40, 1728, 300, 2000),
            ("802.16", "3/4", 54, "B", 2.5, 256, 3, 9720, 11, 1800)]
    for fn in ("normalize_record", "record_to_tuple_line", "waterfall_metrics"):
        for r in recs:
            assert getattr(tresults, fn)(r) == getattr(jresults, fn)(r)
    for style in ("reference", "named"):
        assert tresults.records_to_csv(recs, style=style) == \
            jresults.records_to_csv(recs, style=style)
    txt = tmp_path / "results.txt"
    txt.write_text("".join(jresults.record_to_tuple_line(r) + "\n" for r in recs))
    assert tresults.load_records(txt) == jresults.load_records(txt)
    csv = tmp_path / "results.csv"
    tresults.results_txt_to_csv(txt, csv)
    assert tresults.load_records(csv) == jresults.load_records(csv)


SWEEP = ["sparc-sweep", "--L", "64", "--M", "16", "--R", "1.2",
         "--spatially-coupled", "--omega", "2", "--Lambda", "4", "--t-max", "12",
         "--trials", "3", "--num-snrs", "2", "--snr-start", "8", "--snr-stop", "30",
         "--device", "cpu"]


def _parse(argv):
    ns = {}
    real = cli.cmd_sparc_sweep
    try:
        cli.cmd_sparc_sweep = lambda args: ns.setdefault("args", args)
        cli.main(argv)
    finally:
        cli.cmd_sparc_sweep = real
    return ns["args"]


@pytest.mark.parametrize("extra", [[], ["--power-allocated", "--B", "4"]])
def test_resume_key_matches_the_jax_cli(extra):
    args = _parse(SWEEP + extra)
    params = cli.sparc_params_from_args(args)
    jparams = JParams(**{f: getattr(params, f) for f in params.__dataclass_fields__})
    want = jcli._config_key(params=jparams, t_max=args.t_max, trials=args.trials)
    assert cli.sweep_config_key(args, params) == want
    args2 = _parse(SWEEP + extra + ["--fwht-mode", "2mm"])
    assert cli.sweep_config_key(args2, params) != want


def test_sweep_resumes_from_its_store(tmp_path, monkeypatch):
    calls = []
    real = tmc.sparc_ber_sweep

    def counting(*a, **k):
        calls.append(k.get("fwht_mode"))
        return real(*a, **k)

    monkeypatch.setattr(tmc, "sparc_ber_sweep", counting)
    argv = SWEEP + ["--out", str(tmp_path), "--fwht-mode", "2mm"]
    first = cli.main(argv)
    assert calls == ["2mm", "2mm"] and len(first) == 2
    lines = (tmp_path / "sparc_sweep.jsonl").read_text().splitlines()
    again = cli.main(argv)
    assert calls == ["2mm", "2mm"]             # nothing decoded the second time
    assert again == [json.loads(ln) for ln in lines] == first
    assert (tmp_path / "sparc_sweep.jsonl").read_text().splitlines() == lines
    for r in again:
        assert r["key"].startswith("sparc:") and r["snr"] in (8.0, 30.0)
        assert np.isclose(r["snr_db"], 10 * np.log10(r["snr"]))


def test_new_modules_import_no_jax(tmp_path):
    """The sweep's modules import neither JAX nor the JAX package."""
    import os
    import subprocess
    import sys
    code = (
        "import sys\n"
        "from ldpc_sparc_tpu_torch import cli, sparc_se, sparc_mc_counts\n"
        "from ldpc_sparc_tpu_torch.io import results\n"
        "cli.main(['sparc-sweep', '--L', '16', '--M', '32', '--R', '1.0',\n"
        "          '--t-max', '3', '--trials', '1', '--num-snrs', '1',\n"
        "          '--device', 'cpu', '--out', sys.argv[1]])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ldpc_sparc_tpu' or m.startswith('ldpc_sparc_tpu.')]\n"
        "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "sparc_sweep.jsonl").exists()


# ---- the entry points run on the card unless asked for the CPU ----------------

def _no_card_calls():
    from ldpc_sparc_tpu_torch import (LdpcParams, ldpc_waterfall_campaign, sparc_se,
                                      sparc_sim)
    from ldpc_sparc_tpu_torch.models import sparc as tsparc
    from ldpc_sparc_tpu_torch.models.ldpc import get_code
    from ldpc_sparc_tpu_torch.ops.transforms import SparcDesign
    p, d = SparcParams(P=15.0, R=1.0, L=16, M=32), DecodeParams(t_max=3)
    return {
        "sparc_sim": lambda **kw: sparc_sim(p, d, 1.0, seed=0, **kw),
        "sparc_encode": lambda **kw: tsparc.sparc_encode(p, 1.0, seed=0, **kw),
        "design_for_params": lambda **kw: tsparc.design_for_params(p, 1.0, 0, **kw),
        "sparc_mc_counts": lambda **kw: tmc.sparc_mc_counts(p, d, 1.0, 0, 2, **kw),
        "sparc_ber_sweep": lambda **kw: tmc.sparc_ber_sweep(p, d, [1.0], 0, 2, **kw),
        "_ldpc_block_counts": lambda **kw: tmc._ldpc_block_counts(
            get_code("802.16", "1/2", 3), 2.0, 0, 0, 4, 5, "sumprod2", **kw),
        "ldpc_waterfall_campaign": lambda **kw: ldpc_waterfall_campaign(
            LdpcParams(standard="802.16", rate="1/2", z=3), n_measurements=1,
            min_errors=1, max_blocks=8, batch=4, max_iters=5, **kw),
        "sparc_se": lambda **kw: sparc_se(1.0, p, 3, 50, **kw),
        "SparcDesign.for_params": lambda **kw: SparcDesign.for_params(p, 1.0, 0, **kw),
        "SparcDesign.build": lambda **kw: SparcDesign.build(np.ones((1, 1)), 16, 32,
                                                            80, 0, **kw),
        "stack_designs": lambda **kw: stack_designs(p, 1.0, 0, 2, **kw),
    }


@pytest.mark.parametrize("name", sorted(_no_card_calls()))
def test_entry_point_takes_the_card_unless_asked_for_the_cpu(name):
    """device=None means the CUDA device: without one the call raises, and
    says how to ask for the CPU; device="cpu" runs."""
    call = _no_card_calls()[name]
    assert call(device="cpu") is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cli_without_device_needs_a_card(tmp_path):
    argv = [a for a in SWEEP if a not in ("--device", "cpu")] + ["--out", str(tmp_path)]
    if torch.cuda.is_available():
        return   # a card is present: the CLI would run the sweep on it
    with pytest.raises(SystemExit) as err:
        cli.main(argv)
    assert "no CUDA device" in str(err.value) and "--device cpu" in str(err.value)
    assert not (tmp_path / "sparc_sweep.jsonl").exists()


# ---- fused_denoiser reaches amp_decode from every entry point -----------------

# tests/test_torch_families.py's "sc-m32": the fused tail takes M = 32, and
# `amp_decode(fused_denoiser=False)` is held equal to the JAX decode there
SC32 = dict(P=15.0, R=1.0, L=256, M=32, spatially_coupled=True, omega=3, Lambda=8)


def _sim_inputs(params, var, seed):
    """The design, beta0 and y that `sparc_sim(params, ., var, seed)` draws."""
    from ldpc_sparc_tpu_torch.models.sparc import design_for_params
    design = design_for_params(params, var, seed, device="cpu")
    bits = bitops.random_bits(
        rngmod.root_generator(rngmod.derive(seed, rngmod.BITS), "cpu"), params.bit_len)
    beta0 = bitops.bits_to_msg_vector(bits, params.M)
    y = awgn_channel(design.ab(beta0), var, rngmod.root_generator(
        rngmod.derive(seed, rngmod.CHANNEL), "cpu"))
    return design, beta0, y


@pytest.mark.parametrize("fused", [False, None])
def test_sparc_sim_passes_fused_denoiser_to_amp_decode(fused):
    from ldpc_sparc_tpu_torch.models import sparc as tsparc
    params, decode, var, seed = SparcParams(**SC32), DecodeParams(t_max=20), 1.0, 3
    sim = tsparc.sparc_sim(params, decode, var, seed, device="cpu", fused_denoiser=fused)
    design, beta0, y = _sim_inputs(params, var, seed)
    want = tsparc.amp_decode(y, design, params, decode, var, beta0, fused_denoiser=fused)
    assert int(sim["t_final"]) == int(want.t_final)
    assert torch.equal(sim["nmse"], want.nmse)
    err = (want.beta != beta0).reshape(params.L, -1).any(-1)
    np.testing.assert_array_equal(sim["loc_of_sec_errs"], np.flatnonzero(err.numpy()))
    # the two tails sum psi in other orders: the trajectories tell them apart
    other = tsparc.amp_decode(y, design, params, decode, var, beta0,
                              fused_denoiser=None if fused is False else False)
    assert not torch.equal(other.nmse, want.nmse)
    bits_out, res, _ = tsparc.sparc_decode(y, design, params, decode, var, beta0,
                                           fused_denoiser=fused)
    assert torch.equal(res.nmse, want.nmse)
    assert torch.equal(bits_out, bitops.msg_vector_to_bits(want.beta, params.M))


def test_mc_counts_pass_fused_denoiser_to_amp_decode():
    """`iters` is the sum of the trials' t_final under the same tail."""
    params, decode, var, seed, n = SparcParams(**SC32), DecodeParams(t_max=20), 1.0, 3, 3
    designs = stack_designs(params, var, seed, n, device="cpu")
    want = {False: 0, None: 0}
    for t in range(n):
        gen = rngmod.root_generator(rngmod.derive(seed, t), "cpu")
        bits = bitops.random_bits(gen, params.bit_len)[None]
        y = awgn_channel(designs[t].ab(bitops.bits_to_msg_vector(bits, params.M))[0],
                         var, gen)[None]
        for fused in want:
            want[fused] += int(decode_batch(y, designs[t], params, decode, var,
                                            fused_denoiser=fused)[1].sum())
    for fused, iters in want.items():
        got = tmc.sparc_mc_counts(params, decode, var, seed, n, device="cpu",
                                  fused_denoiser=fused)
        assert got["iters"] == iters and got["bit_errs"] == 0


def test_every_entry_point_hands_fused_denoiser_down(monkeypatch, tmp_path):
    """sparc_sim, sparc_decode, sparc_mc_counts, sparc_ber_sweep and the CLI
    each reach `amp_decode` with the caller's choice."""
    from ldpc_sparc_tpu_torch.models import sparc as tsparc
    seen = []
    real = tsparc.amp_decode

    def recording(*a, **k):
        seen.append(k.get("fused_denoiser", "absent"))
        return real(*a, **k)

    monkeypatch.setattr(tsparc, "amp_decode", recording)
    params, decode = SparcParams(**SC), DecodeParams(t_max=5)
    design, beta0, y = _sim_inputs(params, 1.0, 0)
    calls = {
        "sparc_sim": lambda f: tsparc.sparc_sim(params, decode, 1.0, 0, device="cpu",
                                                fused_denoiser=f),
        "sparc_decode": lambda f: tsparc.sparc_decode(y, design, params, decode, 1.0,
                                                      fused_denoiser=f),
        "sparc_mc_counts": lambda f: tmc.sparc_mc_counts(
            params, decode, 1.0, 0, 2, n_designs=1, device="cpu", fused_denoiser=f),
        "sparc_ber_sweep": lambda f: tmc.sparc_ber_sweep(
            params, decode, [1.0], 0, 2, device="cpu", fused_denoiser=f),
    }
    for name, call in calls.items():
        for f in (False, None):
            seen.clear()
            call(f)
            assert seen and all(s is f for s in seen), (name, f, seen)
    for flags, want in (([], None), (["--no-fused-denoiser"], False)):
        seen.clear()
        cli.main(SWEEP + flags + ["--out", str(tmp_path / f"o{len(flags)}")])
        assert seen and all(s is want for s in seen), (flags, seen)


def test_no_fused_denoiser_joins_the_resume_key_only_when_given():
    args = _parse(SWEEP)
    params = cli.sparc_params_from_args(args)
    base = cli.sweep_config_key(args, params)
    assert args.no_fused_denoiser is False
    off = _parse(SWEEP + ["--no-fused-denoiser"])
    assert off.no_fused_denoiser is True
    assert cli.sweep_config_key(off, params) != base
    both = _parse(SWEEP + ["--no-fused-denoiser", "--fwht-mode", "2mm"])
    assert len({base, cli.sweep_config_key(off, params),
                cli.sweep_config_key(both, params),
                cli.sweep_config_key(_parse(SWEEP + ["--fwht-mode", "2mm"]), params)}) == 4
