"""The torch port's denoisers (ops/denoiser.py) and fused tail
(ops/denoiser_cuda.py) against the JAX package, on the same numpy inputs.

Tolerances are those of tests/test_denoiser_pallas.py: s within rtol 1e-6
(one float32 multiply-add, equal up to rounding), the softmax and the
section energies within rtol 1e-5 (exp and a sum of M terms, reassociated).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.ops import denoiser as jden
from ldpc_sparc_tpu.ops import denoiser_pallas
from ldpc_sparc_tpu_torch.ops import denoiser as tden
from ldpc_sparc_tpu_torch.ops import denoiser_cuda
from ldpc_sparc_tpu_torch.utils.tracing import counters

from freeze_checks import check_freeze_step


def _inputs(L, M, seed):
    rng = np.random.default_rng(seed)
    beta = rng.normal(size=L * M).astype(np.float32)
    azo = rng.normal(size=L * M).astype(np.float32)
    tau = rng.uniform(0.5, 2.0, L).astype(np.float32)
    return beta, azo, tau


@pytest.mark.parametrize("L,M", [(8, 32), (4, 512)])
def test_mmse_denoise_matches_jax(L, M):
    rng = np.random.default_rng(M)
    s = (3.0 * rng.normal(size=(2, L * M))).astype(np.float32)
    inv_tau = rng.uniform(0.5, 2.0, (2, L * M)).astype(np.float32)
    want, want_p = jden.mmse_denoise(jnp.asarray(s), jnp.asarray(inv_tau), M,
                                     return_probs=True)
    got, got_p = tden.mmse_denoise(torch.as_tensor(s), torch.as_tensor(inv_tau),
                                   M, return_probs=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("L,M", [(8, 32), (4, 512)])
def test_map_estimate_matches_jax(L, M):
    s = np.random.default_rng(L).normal(size=(3, L * M)).astype(np.float32)
    s[0, :M] = 1.0   # a tie: both take the first maximum
    want = np.asarray(jden.map_estimate(jnp.asarray(s), M))
    got = tden.map_estimate(torch.as_tensor(s), M).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1.0


def test_modulated_codes_are_not_ported():
    """Once refused, the K-PSK denoisers are ported: the cases that raised
    give the JAX package's results (tests/test_torch_modulated.py holds
    them at K = 1 complex, 2, 4, 8)."""
    s = np.linspace(-2, 2, 16).astype(np.float32)
    np.testing.assert_allclose(
        tden.mmse_denoise(torch.as_tensor(s), 1.0, 8, K=2).numpy(),
        np.asarray(jden.mmse_denoise(jnp.asarray(s), jnp.float32(1.0), 8, K=2)),
        rtol=1e-5, atol=1e-6)
    sc = (s + 1j * s[::-1]).astype(np.complex64)
    np.testing.assert_array_equal(
        tden.map_estimate(torch.as_tensor(sc), 8, K=4).numpy(),
        np.asarray(jden.map_estimate(jnp.asarray(sc), 8, K=4)))


@pytest.mark.parametrize("L,M", [(8, 128), (4, 256)])
def test_fused_ref_matches_jax_kernel(L, M):
    """The plain version against the Pallas kernel in interpret mode."""
    beta, azo, tau = _inputs(L, M, L * M)
    want = denoiser_pallas.fused_denoise_update(
        jnp.asarray(beta), jnp.asarray(azo), jnp.asarray(tau), M,
        interpret=True)
    got = denoiser_cuda.fused_denoise_update_ref(
        torch.as_tensor(beta), torch.as_tensor(azo), torch.as_tensor(tau), M)
    for g, w, rtol in zip(got, want, (1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=1e-6 if rtol == 1e-6 else 1e-7)


def test_fused_ref_matches_plain_tail():
    """Division by tau (fused) against the plain tail's multiplication by
    1/tau: equal to float32 rounding of the logits."""
    L, M = 4, 64
    beta, azo, tau = (torch.as_tensor(a) for a in _inputs(L, M, 0))
    s, p, en = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    rep = tau.repeat_interleave(M)
    torch.testing.assert_close(s, beta + rep * azo, rtol=1e-6, atol=1e-6)
    want = tden.mmse_denoise(s, 1.0 / rep, M)
    torch.testing.assert_close(p, want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(en, (want.reshape(L, M) ** 2).sum(-1),
                               rtol=1e-5, atol=1e-7)


def test_fused_ref_batched_rows_independent():
    L, M = 2, 32
    parts = [_inputs(L, M, k) for k in range(3)]
    beta, azo, tau = (torch.as_tensor(np.stack(a)) for a in zip(*parts))
    s, p, en = denoiser_cuda.fused_denoise_update(beta, azo, tau, M)
    assert s.shape == p.shape == (3, L * M) and en.shape == (3, L)
    s1, p1, en1 = denoiser_cuda.fused_denoise_update(beta[1], azo[1], tau[1], M)
    torch.testing.assert_close(p[1], p1, rtol=0, atol=0)
    torch.testing.assert_close(en[1], en1, rtol=0, atol=0)


@pytest.mark.parametrize("M,K,cx,ok", [
    (512, 1, False, True), (32, 1, False, True), (4096, 1, False, True),
    (16, 1, False, False), (8192, 1, False, True), (1 << 22, 1, False, True),
    (1 << 23, 1, False, False), (512, 2, False, False), (512, 1, True, False),
])
def test_eligibility(M, K, cx, ok):
    assert denoiser_cuda.fused_eligible(M, K, cx) is ok


def test_kernel_argument_checks():
    z = torch.zeros(2, 64)
    denoiser_cuda._check(z, z, torch.zeros(2, 2), 32)
    with pytest.raises(ValueError):
        denoiser_cuda._check(z, z, torch.zeros(2, 4), 32)       # L*M != 64
    with pytest.raises(ValueError):
        denoiser_cuda._check(z, z, torch.zeros(2, 4), 16)       # M < 32
    with pytest.raises(ValueError):
        denoiser_cuda._check(z.double(), z, torch.zeros(2, 2), 32)


def test_cpu_tensors_never_launch():
    before = counters()["k3.launches"]
    beta, azo, tau = (torch.as_tensor(a) for a in _inputs(2, 32, 1))
    denoiser_cuda.fused_denoise_update(beta, azo, tau, 32)
    assert counters()["k3.launches"] == before



# ---- the AMP loop's freeze inside the fused tail (`stopped`, `s_prev`, `out`) ----

@pytest.mark.parametrize("mask", ["none", "some", "all"])
def test_fused_ref_freeze_copies_stopped_rows(mask):
    """Stopped rows keep beta and s bit for bit and their energies sum beta's
    squares, the step's own energies where that step wrote beta; live rows
    equal the call without a mask."""
    B, L, M = 5, 4, 64
    stopped = torch.tensor({"none": [0] * B, "some": [0, 1, 1, 0, 1],
                            "all": [1] * B}[mask], dtype=torch.bool)
    check_freeze_step("cpu", B, L, M, stopped=stopped)
    beta, azo, tau = (torch.as_tensor(np.stack(a))
                      for a in zip(*[_inputs(L, M, k) for k in range(B)]))
    s_prev = torch.randn(B, L * M, generator=torch.Generator().manual_seed(1))
    s, p, en = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M, stopped, s_prev)
    live = ~stopped
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    assert all(torch.equal(g[live], w[live]) for g, w in zip((s, p, en), want))
    assert torch.equal(s[stopped], s_prev[stopped]) and torch.equal(p[stopped], beta[stopped])
    assert torch.equal(en[stopped], (beta[stopped].reshape(-1, L, M) ** 2).sum(-1))


def test_fused_freeze_writes_out():
    L, M = 2, 32
    beta, azo, tau = (torch.as_tensor(a) for a in _inputs(L, M, 3))
    out = (torch.full_like(beta, 7.0), torch.full_like(beta, 7.0))
    got = denoiser_cuda.fused_denoise_update(beta, azo, tau, M, stopped=torch.tensor(False),
                                             s_prev=torch.zeros_like(beta), out=out)
    assert got[0] is out[0] and got[1] is out[1]
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _freeze_args(case):
    z, st = torch.zeros(2, 64), torch.zeros(2, dtype=torch.bool)
    return {"stopped alone": dict(stopped=st),
            "s_prev alone": dict(s_prev=z),
            "stopped not bool": dict(stopped=st.float(), s_prev=z),
            "stopped a row short": dict(stopped=st[:1], s_prev=z),
            "s_prev misshapen": dict(stopped=st, s_prev=z[:, :32]),
            "one out buffer": dict(out=(z,)),
            "out misshapen": dict(out=(z, z[:1]))}[case]


@pytest.mark.parametrize("case", ["stopped alone", "s_prev alone", "stopped not bool",
                                  "stopped a row short", "s_prev misshapen",
                                  "one out buffer", "out misshapen"])
def test_freeze_argument_checks(case):
    """Checked on every device, before the CPU's plain version runs."""
    z = torch.zeros(2, 64)
    with pytest.raises(ValueError):
        denoiser_cuda.fused_denoise_update(z, z, torch.ones(2, 2), 32, **_freeze_args(case))


def test_kernel_freeze_argument_checks():
    """The card's own checks, on CPU tensors: out apart from what the step
    reads and from each other, everything contiguous."""
    z, st = torch.zeros(2, 64), torch.zeros(2, dtype=torch.bool)
    tau, a, b = torch.zeros(2, 2), torch.zeros(2, 64), torch.zeros(2, 64)
    denoiser_cuda._check(z, z, tau, 32, st, a, (b, torch.zeros(2, 64)))
    for out in ((z, b), (b, b), (a, b), (b, z)):
        with pytest.raises(ValueError, match="apart"):
            denoiser_cuda._check(z, torch.zeros(2, 64), tau, 32, st, a, out)
    with pytest.raises(ValueError):
        denoiser_cuda._check(z, z, tau, 32, st, a, (b, torch.zeros(64, 2).T))
    with pytest.raises(ValueError):
        denoiser_cuda._check(z, z, tau, 32, torch.zeros(4, dtype=torch.bool)[::2], a)


def test_cpu_freeze_never_counts():
    before = counters()
    beta, azo, tau = (torch.as_tensor(a) for a in _inputs(2, 32, 1))
    denoiser_cuda.fused_denoise_update(beta, azo, tau, 32, stopped=torch.tensor(True),
                                       s_prev=azo.clone())
    after = counters()
    assert [after[k] - before[k] for k in ("k3.launches", "k3.freeze_launches")] == [0, 0]
