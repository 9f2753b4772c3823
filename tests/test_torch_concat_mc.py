"""The port's concatenated Monte Carlo (`concat_mc_trial_errors`,
`concat_ber_point`) and its `concat-sweep` CLI.

The two packages draw bits and noise from other generators, so the counts
are not compared with JAX here (tests/test_torch_concat.py holds every
decoder to JAX on equal inputs). Within the port a trial's count is an
exact function of (seed, trial index): it does not change with the number
of trials decoded beside it, and equals the trial decoded alone. The CLI's
store is the JAX CLI's: the same configuration key, meta record and row
keys from the same arguments. torch runs on one thread, float32 matmuls at
full precision (no TF32).
"""

import json

import numpy as np
import pytest
import torch

from ldpc_sparc_tpu import cli as jcli
from ldpc_sparc_tpu.io import results as jresults
from ldpc_sparc_tpu.parallel import montecarlo as jmc
from ldpc_sparc_tpu_torch import (ConcatCodec, DecodeParams, LdpcParams, SparcParams, cli,
                                  concat_ber_point, concat_mc_trial_errors, get_code,
                                  param_calc)
from ldpc_sparc_tpu_torch.models.sparc import awgn_channel
from ldpc_sparc_tpu_torch.parallel import montecarlo as tmc
from ldpc_sparc_tpu_torch.utils import rng as rngmod

P = 19.44
DECODE = DecodeParams(t_max=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _setup():
    """tests/test_concat.py's small code: 802.16 r=1/2 z=12, mults=2, M=4."""
    ldpc = LdpcParams("802.16", "1/2", 12)
    _, _, L, lengths = param_calc(2, 2, ldpc, 0.5, 1.0, get_code("802.16", "1/2", 12).K)
    return SparcParams(P=P, R=1.0, L=L, M=4), ldpc, lengths


def _errors(n_trials, decoder, n_designs=None, snr=3.0, seed=(4, 0), **kw):
    sp, ldpc, lengths = _setup()
    return concat_mc_trial_errors(sp, ldpc, lengths, True, DECODE, P / snr, seed,
                                  n_trials, decoder, n_designs=n_designs, device="cpu",
                                  **kw)


@pytest.mark.parametrize("n_designs", [1, 3, 8])
@pytest.mark.parametrize("decoder", ["sequential", "integrated"])
def test_trial_errors_depend_on_seed_and_trial_alone(decoder, n_designs):
    eight = _errors(8, decoder, n_designs)
    twelve = _errors(12, decoder, n_designs)
    assert eight.shape == (8,) and twelve.shape == (12,) and eight.dtype == np.int64
    np.testing.assert_array_equal(eight, twelve[:8])
    assert (twelve > 0).any()                       # errors are counted
    assert not np.array_equal(eight, _errors(8, decoder, n_designs, seed=(5, 0)))


@pytest.mark.parametrize("decoder", ["amp_only", "naive", "integrated_posteriors"])
def test_trial_errors_equal_the_trials_decoded_alone(decoder):
    """Trial t: user bits then noise from the generator of derive(seed, t),
    design (seed, t % n_designs), decoded by `decode` on its own."""
    sp, ldpc, lengths = _setup()
    protected = decoder != "amp_only"
    codec = ConcatCodec(sp, ldpc, lengths, protected)
    seed, n_trials, n_designs, var = (4, 0), 5, 3, P / 3.0
    want = []
    for t in range(n_trials):
        gen = rngmod.root_generator(rngmod.derive(seed, t), "cpu")
        user_bits, _, beta0 = codec.encode_message(gen)
        design = codec.build_design((seed, t % n_designs), device="cpu")
        y = awgn_channel(design.ab(beta0 / codec.c_amp), var, gen)
        want.append(int((codec.decode(y, design, DECODE, decoder) != user_bits).sum()))
    got = concat_mc_trial_errors(sp, ldpc, lengths, protected, DECODE, var, seed,
                                 n_trials, decoder, n_designs=n_designs, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert sum(want) > 0


def test_default_design_count():
    got = _errors(3, "sequential")
    np.testing.assert_array_equal(got, _errors(3, "sequential", n_designs=3))
    nine = _errors(9, "sequential")                 # min(8, n_trials) designs
    np.testing.assert_array_equal(nine, _errors(9, "sequential", n_designs=8))


def test_ber_point_keys_and_arithmetic():
    sp, ldpc, lengths = _setup()
    row = concat_ber_point(sp, ldpc, lengths, True, DECODE, P / 3.0, (4, 0), 6, "naive",
                           device="cpu")
    errs = _errors(6, "naive")
    ubits = ConcatCodec(sp, ldpc, lengths, True).user_bits_len
    assert set(row) == {"ber", "ber_min", "ber_max", "frame_errs", "frames", "bit_errs",
                        "bits"}
    assert row["bit_errs"] == int(errs.sum()) and row["bits"] == 6 * ubits
    assert row["frames"] == 6 and row["frame_errs"] == int((errs > 0).sum())
    assert row["ber"] == pytest.approx(errs.sum() / (6 * ubits), rel=1e-12)
    assert row["ber_min"] == errs.min() / ubits and row["ber_max"] == errs.max() / ubits
    assert all(type(v) in (int, float) for v in row.values())
    json.dumps(row)


def test_monte_carlo_takes_the_card_unless_asked_for_the_cpu():
    sp, ldpc, lengths = _setup()
    if not torch.cuda.is_available():
        for fn in (concat_mc_trial_errors, concat_ber_point):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(sp, ldpc, lengths, True, DECODE, 1.0, 0, 2, "sequential")


# ---- concat-sweep ---------------------------------------------------------------

SWEEP = ["concat-sweep", "--z", "12", "--mults", "2", "--logM", "2", "--t-max", "6",
         "--runs", "2", "--num-snrs", "2", "--snr-start", "3", "--snr-stop", "8",
         "--decoders", "amp_only,sequential,integrated", "--seed", "1"]


def _jax_store(argv, out, monkeypatch):
    """The JAX CLI's store for `argv`, with its decode and its figure
    replaced: the keys and the meta record are what is compared."""
    row = {"ber": 0.0, "ber_min": 0.0, "ber_max": 0.0, "frame_errs": 0, "frames": 2,
           "bit_errs": 0, "bits": 1}
    monkeypatch.setattr(jmc, "concat_ber_point", lambda *a, **k: dict(row))
    monkeypatch.setattr(jresults, "plot_ber_sweep", lambda *a, **k: None)
    monkeypatch.setattr(jcli, "_init_jax", lambda args: None)
    jcli.main(argv + ["--out", str(out)])
    stem = "concat_sweep_semi" if "--semi-protected" in argv else "concat_sweep"
    return [json.loads(ln) for ln in (out / f"{stem}.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("extra", [[], ["--semi-protected", "--percent-protected", "0.8",
                                        "--R-sparc", "0.8",
                                        "--decoders", "amp_only,sequential,naive"]])
def test_sweep_store_is_the_jax_clis(tmp_path, monkeypatch, extra):
    """Same arguments, same configuration key, meta record and row keys;
    a rerun decodes nothing; --save-npz holds the reference's four arrays."""
    calls = []
    real = tmc.concat_ber_point

    def counting(*a, **k):
        calls.append(k["decoder"])
        return real(*a, **k)

    monkeypatch.setattr(tmc, "concat_ber_point", counting)
    npz = tmp_path / "snap.npz"
    argv = SWEEP + extra + ["--device", "cpu", "--out", str(tmp_path / "t"),
                            "--save-npz", str(npz)]
    series = cli.main(argv)
    decoders = argv[argv.index("--decoders", len(SWEEP) if extra else 0) + 1].split(",")
    assert calls == decoders * 2 and list(series) == decoders
    stem = "concat_sweep_semi" if extra else "concat_sweep"
    path = tmp_path / "t" / f"{stem}.jsonl"
    lines = path.read_text().splitlines()
    got = [json.loads(ln) for ln in lines]
    want = _jax_store(SWEEP + extra, tmp_path / "j", monkeypatch)
    assert [r["key"] for r in got] == [r["key"] for r in want]
    assert got[0] == want[0] and got[0]["key"].startswith("meta:")
    assert got[0]["config"]["semi_protected"] is bool(extra)
    assert (got[0]["config"]["lengths"]["L_unprotected"] > 0) is bool(extra)
    for g, w in zip(got[1:], want[1:]):
        assert set(g) == set(w) | {"snr", "snr_db", "decoder"}
        assert g["snr"] in (3.0, 8.0) and np.isclose(g["snr_db"], 10 * np.log10(g["snr"]))
        assert g["frames"] == 2 and 0 <= g["ber_min"] <= g["ber"] <= g["ber_max"] <= 1
    by = {(r["decoder"], r["snr"]): r for r in got[1:]}
    assert by["sequential", 8.0]["bit_errs"] == 0 or extra
    # the rerun decodes nothing and returns the stored rows
    again = cli.main(argv)
    assert calls == decoders * 2 and path.read_text().splitlines() == lines
    assert [[r["ber"] for r in again[d]] for d in decoders] == \
        [[r["ber"] for r in series[d]] for d in decoders]
    snap = np.load(npz)
    assert set(snap.files) == {"ber_store_averages", "ber_store_max", "ber_store_min",
                               "snr_store"}
    np.testing.assert_array_equal(snap["snr_store"], [3.0, 8.0])
    for name, col in (("ber_store_averages", "ber"), ("ber_store_max", "ber_max"),
                      ("ber_store_min", "ber_min")):
        assert snap[name].shape == (len(decoders), 2)
        np.testing.assert_array_equal(
            snap[name], [[r[col] for r in series[d]] for d in decoders])


def test_sweep_key_changes_with_the_configuration():
    ns = {}

    def parse(argv):
        real = cli.cmd_concat_sweep
        try:
            cli.cmd_concat_sweep = lambda args: ns.setdefault("args", args)
            ns.clear()
            cli.main(argv)
        finally:
            cli.cmd_concat_sweep = real
        return ns["args"]

    def key(argv):
        args = parse(argv)
        ldpc, sp_plain, sp_ldpc, lengths, _, _ = cli.concat_setup(args)
        return cli.concat_config_key(args, ldpc, sp_plain, sp_ldpc, lengths)

    base = key(SWEEP)
    assert key(SWEEP + ["--device", "cpu", "--seed", "7"]) == base   # the seed is in the row key
    assert len({base, key(SWEEP + ["--runs", "3"]), key(SWEEP + ["--t-max", "7"]),
                key(SWEEP + ["--P", "15"]), key(SWEEP + ["--semi-protected"])}) == 5
    defaults = parse(["concat-sweep"])
    assert (defaults.z, defaults.mults, defaults.logM, defaults.P, defaults.runs) == \
        (150, 4, 1, 19.44, 5)


def test_sweep_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        return   # a card is present: the CLI would run the sweep on it
    with pytest.raises(SystemExit) as err:
        cli.main(SWEEP + ["--out", str(tmp_path)])
    assert "no CUDA device" in str(err.value) and "--device cpu" in str(err.value)
    assert not (tmp_path / "concat_sweep.jsonl").exists()
