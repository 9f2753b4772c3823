"""The torch port's bit codecs, metrics and generator derivation against
the JAX package, on the same numpy bits (exact: integer arithmetic)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.utils import bits as jbits
from ldpc_sparc_tpu.utils import metrics as jmetrics
from ldpc_sparc_tpu_torch.utils import bits as tbits
from ldpc_sparc_tpu_torch.utils import metrics as tmetrics
from ldpc_sparc_tpu_torch.utils import rng as trng


@pytest.mark.parametrize("L,M", [(16, 2), (8, 32), (4, 512)])
def test_msg_vector_matches_jax(L, M):
    logM = M.bit_length() - 1
    bits = np.random.default_rng(M).integers(0, 2, L * logM).astype(bool)
    want = np.asarray(jbits.bits_to_msg_vector(jnp.asarray(bits), M))
    got = tbits.bits_to_msg_vector(torch.as_tensor(bits), M)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # decode a noisy vector: same locations in both packages
    noisy = want + 0.3 * np.random.default_rng(1).normal(size=want.shape)
    noisy = noisy.astype(np.float32)
    np.testing.assert_array_equal(
        tbits.msg_vector_to_bits(torch.as_tensor(noisy), M).numpy(),
        np.asarray(jbits.msg_vector_to_bits(jnp.asarray(noisy), M)))


@pytest.mark.parametrize("M", [2, 64])
def test_round_trip_batched(M):
    logM = M.bit_length() - 1
    gen = torch.Generator().manual_seed(M)
    bits = tbits.random_bits(gen, 3 * 10 * logM).reshape(3, 10 * logM)
    msg = tbits.bits_to_msg_vector(bits, M, amplitude=2.5)
    assert msg.shape == (3, 10 * M)
    assert torch.equal(msg.reshape(3, 10, M).count_nonzero(-1),
                       torch.ones(3, 10, dtype=torch.int64))
    assert torch.equal(tbits.msg_vector_to_bits(msg, M), bits)


def test_ints_bits_match_jax():
    idx = np.arange(32, dtype=np.int32)
    want = np.asarray(jbits.ints_to_bits(jnp.asarray(idx), 5))
    got = tbits.ints_to_bits(torch.as_tensor(idx, dtype=torch.int64), 5)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tbits.bits_to_ints(got, 5).numpy(), idx)


def test_modulated_codes_are_not_ported():
    """Once refused, the K-PSK codecs are ported: the cases that raised
    give the JAX package's results (tests/test_torch_modulated.py holds
    them at K = 2, 4, 8)."""
    zeros = np.zeros(8, dtype=bool)             # 2 sections of log2(4) + 2 bits
    got = tbits.bits_to_msg_vector(torch.as_tensor(zeros[:6]), 4, K=2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbits.bits_to_msg_vector(jnp.asarray(zeros[:6]), 4, K=2)))
    v = np.zeros(8, np.complex64)
    v[[1, 6]] = [1j, -1.0]
    np.testing.assert_array_equal(
        tbits.msg_vector_to_bits(torch.as_tensor(v), 4, K=4).numpy(),
        np.asarray(jbits.msg_vector_to_bits(jnp.asarray(v), 4, K=4)))


def test_random_bits_are_seeded():
    a = tbits.random_bits(trng.root_generator(3), 1000)
    b = tbits.random_bits(trng.root_generator(3), 1000)
    c = tbits.random_bits(trng.root_generator(4), 1000)
    assert a.dtype == torch.bool and a.shape == (1000,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 400 < int(a.sum()) < 600


def test_derive_gives_distinct_nested_streams():
    assert trng.derive(5, trng.BITS) == (5, 0xB1)
    seeds = [trng.derive(5, trng.BITS), trng.derive(5, trng.CHANNEL),
             trng.derive((5, 1), trng.BITS)]
    draws = [torch.randn(4, generator=trng.root_generator(s)) for s in seeds]
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    again = torch.randn(4, generator=trng.root_generator(((5,), 0xB1)))
    assert torch.equal(draws[0], again)   # nesting does not matter


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, (3, 40)).astype(bool)
    b = a.copy()
    b[1, :7] ^= True
    np.testing.assert_allclose(
        tmetrics.bit_error_rate(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jmetrics.bit_error_rate(jnp.asarray(a), jnp.asarray(b))))
    beta0 = np.zeros((2, 32), np.float32)
    beta0[:, ::8] = 1.0
    beta = beta0.copy()
    beta[1, 8:16] = np.eye(8, dtype=np.float32)[3]
    (te, tr), (je, jr) = (
        tmetrics.section_errors(torch.as_tensor(beta0), torch.as_tensor(beta), 4),
        jmetrics.section_errors(jnp.asarray(beta0), jnp.asarray(beta), 4))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr))
    with pytest.raises(ValueError):
        tmetrics.bit_error_rate(torch.zeros(3), torch.zeros(4))
