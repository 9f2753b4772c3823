"""The port's AMP <-> BP bridges (ops/bridges.py) against the JAX package's.

The same numpy inputs, made from a seed and carrying a leading batch axis,
go through both packages at M in {2, 4, 16}. The mask and the S_k sets are
identical; every function agrees to rtol 1e-6 / atol 1e-7 (float32
products with a 0/1 mask and log / exp, summed in other orders), the
Onsager derivative to 1e-6 of its row's largest entry: its k-sum cancels,
so at M = 16 a small entry differs by 4e-6 of itself. The JAX
functions take one trial's tau_sqr, so they are vmapped over the batch.
torch runs on one thread with float32 matmuls at full precision (no TF32).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.ops import bridges as jbr
from ldpc_sparc_tpu_torch.ops import bridges as tbr

MS = (2, 4, 16)
L, BATCH = 24, 3
TOL = dict(rtol=1e-6, atol=1e-7)


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


def _section_probs(rng, M, sharp):
    """(BATCH, L*M) section posteriors; `sharp` scales the logits, so that
    large values put entries at the float32 clips."""
    logits = sharp * rng.normal(size=(BATCH, L, M))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).reshape(BATCH, L * M).astype(np.float32)


def _bit_probs(rng, M, edge):
    logM = M.bit_length() - 1
    p = rng.uniform(0, 1, size=(BATCH, L * logM))
    if edge:  # exact 0 and 1 and values inside the clips' reach
        p[:, ::5], p[:, 1::5], p[:, 2::5] = 0.0, 1.0, 1e-9
    return p.astype(np.float32)


@pytest.mark.parametrize("M", MS + (512,))
def test_mask_and_index_sets_are_identical(M):
    np.testing.assert_array_equal(tbr.bit0_mask_np(M), jbr.bit0_mask_np(M))
    assert tbr.bit0_mask_np(M).dtype == jbr.bit0_mask_np(M).dtype
    got, want = tbr.s_k_mapping(M), jbr.s_k_mapping(M)
    assert [[int(q) for q in s] for s in got] == [[int(q) for q in s] for s in want]


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("sharp", [1.0, 30.0])
def test_section_probs_to_bit_probs(M, sharp):
    probs = _section_probs(np.random.default_rng(M), M, sharp)
    got = tbr.section_probs_to_bit_probs(torch.as_tensor(probs), M)
    want = jbr.section_probs_to_bit_probs(jnp.asarray(probs), M)
    assert got.shape == (BATCH, L * (M.bit_length() - 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("edge", [False, True])
def test_bit_probs_to_section_probs(M, edge):
    p0 = _bit_probs(np.random.default_rng(10 + M), M, edge)
    got = tbr.bit_probs_to_section_probs(torch.as_tensor(p0), M)
    want = jbr.bit_probs_to_section_probs(jnp.asarray(p0), M)
    assert got.shape == (BATCH, L * M) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("M", MS)
def test_round_trip_recovers_a_product_posterior(M):
    """Bit probabilities -> sections -> bit probabilities is the identity
    (a product posterior's marginals are its factors)."""
    p0 = np.clip(_bit_probs(np.random.default_rng(20 + M), M, False), 0.01, 0.99)
    back = tbr.section_probs_to_bit_probs(
        tbr.bit_probs_to_section_probs(torch.as_tensor(p0), M), M)
    np.testing.assert_allclose(back.numpy(), p0, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("sharp", [1.0, 30.0])
def test_combine_posteriors(M, sharp):
    rng = np.random.default_rng(30 + M)
    a, g = _section_probs(rng, M, sharp), _section_probs(rng, M, sharp)
    got = tbr.combine_posteriors(torch.as_tensor(a), torch.as_tensor(g), M)
    want = jbr.combine_posteriors(jnp.asarray(a), jnp.asarray(g), M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("edge", [False, True])
def test_integrated_onsager_derivative(M, edge):
    """Batched, with one tau_sqr per row; the JAX function is vmapped. The
    terms reach 1e6 / tau_sqr where vk0 sits at its 1e-6 clip, so the
    tolerance is relative to the largest entry of the row."""
    rng = np.random.default_rng(40 + M)
    alpha, gamma = _section_probs(rng, M, 2.0), _section_probs(rng, M, 2.0)
    vk, vk0 = _bit_probs(rng, M, False), _bit_probs(rng, M, edge)
    tau = rng.uniform(0.5, 3.0, size=BATCH).astype(np.float32)
    c = 4.41
    got = tbr.integrated_onsager_derivative(
        *(torch.as_tensor(v) for v in (alpha, vk, vk0, gamma, tau)), M, c).numpy()
    want = np.asarray(jax.vmap(
        lambda a, v, v0, g, t: jbr.integrated_onsager_derivative(a, v, v0, g, t, M, c))(
            *(jnp.asarray(v) for v in (alpha, vk, vk0, gamma, tau))))
    assert got.shape == (BATCH, L * M)
    scale = np.abs(want).max(-1, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-6, atol=1e-6)
    # a scalar tau_sqr serves one trial without a batch axis
    one = tbr.integrated_onsager_derivative(
        *(torch.as_tensor(v[0]) for v in (alpha, vk, vk0, gamma)), float(tau[0]), M, c)
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_mask_is_made_once_per_device():
    assert tbr._bit0_mask(4, torch.device("cpu")) is tbr._bit0_mask(4, torch.device("cpu"))
