"""The port's complex and K-PSK modulated SPARCs against the JAX package:
bit codecs, denoisers, error metrics, state evolution, the AMP decode, the
Monte Carlo and the `sparc-sweep` CLI, on the same numpy inputs.

Tolerances:

* bit codecs, tables, MAP estimates and error indicators: exact (integer
  arithmetic, and argmax over the same float32 values).
* `mmse_denoise`: rtol 1e-5 / atol 1e-6 (complex products, exp and a sum
  of M*K terms in float32, reassociated).
* `se_expectation` on the same samples: 1e-5 relative; `sparc_se` psi
  within Monte-Carlo error (0.05, as tests/test_torch_state_evolution.py
  reasons: other generators, 4000 samples).
* `amp_decode` on the same y and design (the plain tail in both packages;
  TF32 off): decisions and t_final equal on every draw, all of which
  converge; beta_mmse within atol 1e-4 (two FWHT chains or FFTs sum float32
  terms in other orders).
* `sparc_mc_counts`: the packages draw bits and noise from other
  generators, so FER, SER, LER and VER agree within the two-sided 99.9 %
  two-sample bound 3.29 * sqrt(p (1 - p) (2 / n)) over n = 256 frames, as
  tests/test_torch_sparc_mc.py states (for the section rates it is
  conservative).
"""

import json
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu import cli as jcli
from ldpc_sparc_tpu.config import DecodeParams as JDecode
from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.models import sparc as jsparc
from ldpc_sparc_tpu.models import state_evolution as jse
from ldpc_sparc_tpu.ops import denoiser as jden
from ldpc_sparc_tpu.ops import transforms as jtr
from ldpc_sparc_tpu.parallel.montecarlo import sparc_mc_counts as jmc
from ldpc_sparc_tpu.utils import bits as jbits
from ldpc_sparc_tpu.utils import metrics as jmetrics
from ldpc_sparc_tpu_torch import DecodeParams, SparcParams, cli, sparc_se, sparc_sim
from ldpc_sparc_tpu_torch.models import sparc as tsparc
from ldpc_sparc_tpu_torch.models import state_evolution as tse
from ldpc_sparc_tpu_torch.ops import denoiser as tden
from ldpc_sparc_tpu_torch.parallel import montecarlo as tmc
from ldpc_sparc_tpu_torch.parity import design_from_jax_leaves, dft_design_from_numpy
from ldpc_sparc_tpu_torch.utils import bits as tbits
from ldpc_sparc_tpu_torch.utils import metrics as tmetrics
from ldpc_sparc_tpu_torch.utils import rng as rngmod

KS = (2, 4, 8)
# tests/test_amp.py's three configurations: name -> (kwargs, engine)
AMP = {
    "k4-complex-dft": (dict(P=15.0, R=2.6, L=256, M=8, modulated=True, K=4,
                            is_complex=True), "dft"),
    "k4-complex-srht": (dict(P=15.0, R=2.6, L=256, M=8, modulated=True, K=4,
                             is_complex=True), "srht"),
    "k1-complex": (dict(P=15.0, R=1.3, L=256, M=32, is_complex=True), "srht"),
    "k2-real": (dict(P=15.0, R=1.3, L=256, M=16, modulated=True, K=2), "srht"),
}
AMP_T_MAX, AMP_BATCH = 16, 3
# a small K=4 code near its threshold (FER about 0.5 at awgn_var 1.8)
MC = dict(P=15.0, R=2.6, L=64, M=8, modulated=True, K=4, is_complex=True)
MC_VAR, MC_T_MAX, MC_TRIALS = 1.8, 15, 256


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


def _cx(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


# ---- bit codecs ------------------------------------------------------------------

@pytest.mark.parametrize("K", KS)
def test_tables_bit_identical(K):
    n = np.arange(64)
    np.testing.assert_array_equal(tbits.bin2gray(n), jbits.bin2gray(n))
    np.testing.assert_array_equal(tbits.gray2bin(n), jbits.gray2bin(n))
    for f in ("psk_constel", "psk_mod_table", "psk_demod_table"):
        got, want = getattr(tbits, f)(K), getattr(jbits, f)(K)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    c = tbits.constel_tensor(K)
    assert c.dtype == (torch.complex64 if K > 2 else torch.float32)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jnp.asarray(jbits.psk_constel(K))))


@pytest.mark.parametrize("K", KS)
def test_msg_vector_matches_jax(K):
    L, M = 12, 8
    bits = np.random.default_rng(K).integers(0, 2, L * (3 + K.bit_length() - 1)).astype(bool)
    want = np.asarray(jbits.bits_to_msg_vector(jnp.asarray(bits), M, K))
    got = tbits.bits_to_msg_vector(torch.as_tensor(bits), M, K)
    assert got.dtype == (torch.complex64 if K > 2 else torch.float32)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # nearest point of a noisy vector with an amplitude: the same bits
    rng = np.random.default_rng(1)
    noisy = 2.5 * want + 0.4 * (_cx(rng, want.shape) if K > 2
                                else rng.normal(size=want.shape))
    noisy = noisy.astype(want.dtype)
    np.testing.assert_array_equal(
        tbits.msg_vector_to_bits(torch.as_tensor(noisy), M, K).numpy(),
        np.asarray(jbits.msg_vector_to_bits(jnp.asarray(noisy), M, K)))


@pytest.mark.parametrize("K", KS)
def test_round_trip_with_amplitude_batched(K):
    M, L = 16, 10
    sec = M.bit_length() - 1 + K.bit_length() - 1
    gen = torch.Generator().manual_seed(K)
    bits = tbits.random_bits(gen, 3 * L * sec).reshape(3, L * sec)
    msg = tbits.bits_to_msg_vector(bits, M, K, amplitude=2.5)
    assert msg.shape == (3, L * M)
    assert torch.equal(msg.reshape(3, L, M).count_nonzero(-1),
                       torch.ones(3, L, dtype=torch.int64))
    assert torch.allclose(msg.abs().sum(-1), torch.full((3,), 2.5 * L))
    assert torch.equal(tbits.msg_vector_to_bits(msg, M, K), bits)
    one = tbits.random_msg_vector(torch.Generator().manual_seed(0), L, M, K)
    assert one.shape == (L * M,) and int(one.count_nonzero()) == L


# ---- denoisers and metrics ----------------------------------------------------------

# (K, complex s): K=1 complex takes Re(s) with no factor 2
DENOISE = [(1, True), (2, False), (4, True), (8, True)]


@pytest.mark.parametrize("K,cx", DENOISE)
def test_mmse_denoise_matches_jax(K, cx):
    L, M = 6, 16
    rng = np.random.default_rng(K)
    s = 2.0 * (_cx(rng, (2, L * M)) if cx else rng.normal(size=(2, L * M)))
    s = s.astype(np.complex64 if cx else np.float32)
    inv_tau = rng.uniform(0.5, 4.0, (2, L * M)).astype(np.float32)
    want, want_p = jden.mmse_denoise(jnp.asarray(s), jnp.asarray(inv_tau), M, K,
                                     return_probs=True)
    got, got_p = tden.mmse_denoise(torch.as_tensor(s), torch.as_tensor(inv_tau), M, K,
                                   return_probs=True)
    assert got.numpy().dtype == np.asarray(want).dtype and got_p.shape == (2, L, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("K,cx", DENOISE)
def test_map_estimate_matches_jax(K, cx):
    L, M = 6, 16
    rng = np.random.default_rng(10 + K)
    s = (_cx(rng, (3, L * M)) if cx else rng.normal(size=(3, L * M)))
    s = s.astype(np.complex64 if cx else np.float32)
    s[0, :M] = 1.0        # a tie over a whole section: the first maximum
    want = np.asarray(jden.map_estimate(jnp.asarray(s), M, K))
    got = tden.map_estimate(torch.as_tensor(s), M, K).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_location_value_errors_match_jax():
    L, M, K = 8, 8, 4
    bits = np.random.default_rng(0).integers(0, 2, (2, L * 5)).astype(bool)
    b0 = np.stack([np.asarray(jbits.bits_to_msg_vector(jnp.asarray(b), M, K))
                   for b in bits])
    b = b0.copy()
    b[0, 0:8] = np.roll(b[0, 0:8], 1)                   # a location error
    b[0, 8:16] *= 1j                                    # a value error
    b[1, 16:24] = np.roll(b[1, 16:24], 2) * -1          # both
    (tr, ti), (jr, ji) = (
        tmetrics.location_value_errors(torch.as_tensor(b0), torch.as_tensor(b), L),
        jmetrics.location_value_errors(jnp.asarray(b0), jnp.asarray(b), L))
    for g, w in zip(ti, ji):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tr, jr):
        np.testing.assert_allclose(g.numpy(), np.asarray(w))
    assert ti[0].sum() == 2 and ti[1].sum() == 2 and ti[2].sum() == 3


# ---- state evolution ------------------------------------------------------------------

@pytest.mark.parametrize("K", KS)
def test_se_expectation_matches_jax(K):
    M = 8
    rng = np.random.default_rng(K)
    u = _cx(rng, (400, M)) if K > 2 else rng.normal(size=(400, M)).astype(np.float32)
    tau = np.array([0.005, 0.02, 0.1, 0.3, 1.0, 3.0], np.float32)
    want = np.asarray(jse.se_expectation(jnp.asarray(tau), K, jnp.asarray(u)))
    got = tse.se_expectation(torch.as_tensor(tau), K, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(np.isfinite(got)) and got[0] > 0.99


@pytest.mark.parametrize("kw", [AMP["k4-complex-srht"][0], AMP["k2-real"][0],
                                dict(P=15.0, R=2.0, L=256, M=8, modulated=True, K=8,
                                     is_complex=True)], ids=["K4", "K2", "K8"])
def test_sparc_se_matches_jax_within_monte_carlo_error(kw):
    for var in (1.0, 2.5):
        want, _ = jse.sparc_se(var, JParams(**kw), 20, 4000, seed=0)
        got, _ = sparc_se(var, SparcParams(**kw), 20, 4000, seed=0, device="cpu")
        assert got.shape == want.shape and np.all(got[0] == 1.0)
        assert np.abs(got - want).max() <= 0.05


# ---- the AMP decode on the same y and design ------------------------------------------

_AMP_CACHE = {}


def _amp_problem(name, seed=3):
    """(port design, beta0, y, JAX decode) as numpy; y = A beta0 + noise,
    complex noise of awgn_var/2 a part where the code is complex."""
    if name not in _AMP_CACHE:
        kw, engine = AMP[name]
        jp = JParams(**kw)
        jd = jsparc.design_for_params(jp, 1.0, seed, engine)
        leaves, aux = jd.tree_flatten()
        td = (dft_design_from_numpy(*leaves, aux) if engine == "dft"
              else design_from_jax_leaves(leaves, aux))
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, (AMP_BATCH, jp.bit_len)).astype(bool)
        beta0 = np.stack([np.asarray(jbits.bits_to_msg_vector(jnp.asarray(b), jp.M, jp.K))
                          for b in bits])
        x = np.stack([np.asarray(jd.ab(jnp.asarray(b))) for b in beta0])
        if jp.is_complex:
            y = (x + _cx(rng, x.shape) * np.float32(np.sqrt(0.5))).astype(np.complex64)
        else:
            y = (x + rng.normal(size=x.shape).astype(np.float32)).astype(np.float32)
        want = jax.vmap(lambda yy, b0: jsparc.amp_decode(
            yy, jd, jp, JDecode(t_max=AMP_T_MAX), 1.0, b0))(
                jnp.asarray(y), jnp.asarray(beta0))
        _AMP_CACHE[name] = (td, beta0, y, want)
    return _AMP_CACHE[name]


@pytest.mark.parametrize("name", sorted(AMP))
def test_amp_decode_matches_jax(name):
    td, beta0, y, want = _amp_problem(name)
    kw, _ = AMP[name]
    assert np.iscomplexobj(y) == kw.get("is_complex", False)
    got = tsparc.amp_decode(torch.as_tensor(y), td, SparcParams(**kw),
                            DecodeParams(t_max=AMP_T_MAX), 1.0,
                            beta0=torch.as_tensor(beta0))
    # every draw converges in JAX: the premise of exact equality
    np.testing.assert_array_equal(np.asarray(want.beta), beta0)
    assert int(np.asarray(want.t_final).max()) < AMP_T_MAX - 1
    assert got.beta.numpy().dtype == np.asarray(want.beta).dtype
    np.testing.assert_array_equal(got.beta.numpy(), np.asarray(want.beta))
    np.testing.assert_array_equal(got.t_final.numpy(), np.asarray(want.t_final))
    assert got.beta_mmse.numpy().dtype == np.asarray(want.beta_mmse).dtype
    np.testing.assert_allclose(got.beta_mmse.numpy(), np.asarray(want.beta_mmse),
                               atol=1e-4)
    np.testing.assert_allclose(got.nmse.numpy(), np.asarray(want.nmse), atol=1e-4)


@pytest.mark.parametrize("name", sorted(AMP))
def test_sparc_sim_decodes_exactly_at_high_snr(name):
    """tests/test_amp.py's high-SNR check through the port's sparc_sim, with
    the modulated keys of the reference's metric dict."""
    kw, engine = AMP[name]
    r = sparc_sim(SparcParams(**kw), DecodeParams(t_max=25), 1.0, seed=0,
                  engine=engine, device="cpu")
    assert float(r["ber"]) == 0.0 and float(r["ser"]) == 0.0
    assert int(r["t_final"]) < 25 and r["loc_of_sec_errs"].size == 0
    modulated = kw.get("modulated", False)
    assert ({"ler", "ver", "loc_of_loc_errs", "loc_of_val_errs"} <= set(r)) == modulated


def test_sparc_sim_modulated_error_locations():
    """Above capacity: the index arrays agree with the counts and rates."""
    p = SparcParams(P=15.0, R=2.5, L=64, M=8, K=4, modulated=True, is_complex=True)
    r = sparc_sim(p, DecodeParams(t_max=8), awgn_var=2.0, seed=1, device="cpu")
    assert r["loc_of_sec_errs"].size == int(r["num_of_sec_errs"]) > 0
    assert r["loc_of_loc_errs"].size == int(r["num_of_loc_errs"])
    assert r["loc_of_val_errs"].size == int(r["num_of_val_errs"])
    assert abs(float(r["ser"]) - r["loc_of_sec_errs"].size / p.L) < 1e-6
    assert set(r["loc_of_loc_errs"]) | set(r["loc_of_val_errs"]) == set(r["loc_of_sec_errs"])


def test_complex_channel_noise():
    """Circular noise of total variance awgn_var: awgn_var/2 a part, the
    real part drawn first from the generator."""
    x = torch.zeros(200_000, dtype=torch.complex64)
    y = tsparc.awgn_channel(x, 3.0, torch.Generator().manual_seed(0))
    assert y.dtype == torch.complex64
    assert abs(float(y.real.var()) - 1.5) < 0.03 and abs(float(y.imag.var()) - 1.5) < 0.03
    g = torch.Generator().manual_seed(0)
    re = torch.randn(200_000, generator=g)
    assert torch.equal(y.real, re * float(np.sqrt(1.5)))


# ---- the Monte Carlo and the CLI --------------------------------------------------------

def _bound(k1, k2, n):
    p = (k1 + k2) / (2 * n)
    return 3.29 * math.sqrt(p * (1 - p) * 2 / n)


@pytest.mark.parametrize("engine", ["srht", "dft"])
def test_counts_agree_with_jax_near_threshold(engine):
    n = MC_TRIALS
    got = tmc.sparc_mc_counts(SparcParams(**MC), DecodeParams(t_max=MC_T_MAX), MC_VAR,
                              0, n, engine=engine, device="cpu")
    want = jmc(JParams(**MC), JDecode(t_max=MC_T_MAX), MC_VAR, 0, n, engine=engine)
    assert set(got) == set(want)
    assert {k: got[k] for k in ("bits", "sections", "frames")} == \
        {k: want[k] for k in ("bits", "sections", "frames")}
    assert 0.2 < got["frame_errs"] / n < 0.8              # near the threshold
    assert abs(got["frame_errs"] - want["frame_errs"]) / n <= _bound(
        got["frame_errs"], want["frame_errs"], n)
    m = got["sections"]
    for k in ("sec_errs", "loc_errs", "val_errs"):
        p = (got[k] + want[k]) / (2 * m)
        assert abs(got[k] - want[k]) / m <= 3.29 * math.sqrt(p * (1 - p) * 2 / n), k


def test_modulated_counts_are_a_function_of_seed_and_trial():
    """The counters equal the sums over the trials each decoded alone."""
    params, decode, var, seed = SparcParams(**MC), DecodeParams(t_max=10), MC_VAR, 4
    n_trials, n_designs = 5, 2
    designs = tmc.stack_designs(params, var, seed, n_designs, device="cpu")
    want = dict.fromkeys(("bit_errs", "sec_errs", "loc_errs", "val_errs", "iters"), 0)
    for t in range(n_trials):
        gen = rngmod.root_generator(rngmod.derive(seed, t), "cpu")
        bits = tbits.random_bits(gen, params.bit_len)[None]
        beta0 = tbits.bits_to_msg_vector(bits, params.M, params.K)
        design = designs[t % n_designs]
        y = tsparc.awgn_channel(design.ab(beta0)[0], var, gen)[None]
        beta, t_final = tsparc.decode_batch(y, design, params, decode, var)
        want["bit_errs"] += int((tbits.msg_vector_to_bits(beta, params.M, params.K)
                                 != bits).sum())
        _, (le, ve, se) = tmetrics.location_value_errors(beta0, beta, params.L)
        want["sec_errs"] += int(se.sum())
        want["loc_errs"] += int(le.sum())
        want["val_errs"] += int(ve.sum())
        want["iters"] += int(t_final.sum())
    got = tmc.sparc_mc_counts(params, decode, var, seed, n_trials, n_designs,
                              device="cpu")
    assert {k: got[k] for k in want} == want and want["sec_errs"] > 0


def test_ber_sweep_has_ler_and_ver():
    rows = tmc.sparc_ber_sweep(SparcParams(**MC), DecodeParams(t_max=10), [2.5, 1.0],
                               0, 4, engine="dft", device="cpu")
    for r in rows:
        assert r["ler"] == r["loc_errs"] / r["sections"]
        assert r["ver"] == r["val_errs"] / r["sections"]
        assert max(r["ler"], r["ver"]) <= r["ser"] <= r["ler"] + r["ver"]
    assert rows[1]["ser"] <= rows[0]["ser"]


SWEEP = ["sparc-sweep", "--L", "64", "--M", "8", "--R", "2.6", "--modulated", "--K", "4",
         "--trials", "3", "--t-max", "6", "--num-snrs", "2", "--snr-start", "8",
         "--snr-stop", "15", "--device", "cpu"]


def test_cli_modulated_and_dft_stores(tmp_path, monkeypatch, capsys):
    """Both engines into one --out: keys equal to the JAX CLI's, never
    colliding; ler and ver printed and stored; a rerun decodes nothing."""
    calls = []
    real = tmc.sparc_ber_sweep
    monkeypatch.setattr(tmc, "sparc_ber_sweep",
                        lambda *a, **k: calls.append(k["engine"]) or real(*a, **k))
    out = ["--out", str(tmp_path)]
    rows = {e: cli.main(SWEEP + out + ["--design-engine", e]) for e in ("srht", "dft")}
    assert calls == ["srht", "srht", "dft", "dft"]
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(printed) == 4 and all({"ler", "ver"} <= set(p) for p in printed)
    store = [json.loads(ln) for ln in (tmp_path / "sparc_sweep.jsonl").read_text()
             .splitlines()]
    jp = JParams(P=15.0, R=2.6, L=64, M=8, modulated=True, K=4, is_complex=True)
    for e in ("srht", "dft"):
        extra = {} if e == "srht" else {"engine": e}
        cfg = jcli._config_key(params=jp, t_max=6, trials=3, **extra)
        want = [f"sparc:{cfg}:snr{snr:.3f}:s0" for snr in (8.0, 15.0)]
        assert [r["key"] for r in rows[e]] == want
    assert len({r["key"] for r in store}) == 4 and len(store) == 4
    for r in store:
        assert {"ler", "ver", "loc_errs", "val_errs"} <= set(r)
    again = {e: cli.main(SWEEP + out + ["--design-engine", e]) for e in ("srht", "dft")}
    assert len(calls) == 4 and again == {e: store[2 * i:2 * i + 2]
                                         for i, e in enumerate(("srht", "dft"))}
    assert not capsys.readouterr().out
