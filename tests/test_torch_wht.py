"""The torch port's FWHT (ops/wht.py) and signed FWHT (ops/wht_cuda.py)
against the JAX package, on the same numpy inputs.

Tolerances: the two chains sum the same float32 terms in a different order
(XLA and torch reassociate differently), so values agree to rtol 1e-5 with
atol 1e-3 for entries that cancel towards 0 (entries reach ~sqrt(w) * 4).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.ops import wht as jwht
from ldpc_sparc_tpu.ops import wht_pallas
from ldpc_sparc_tpu_torch.ops import wht as twht
from ldpc_sparc_tpu_torch.ops import wht_cuda


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


@pytest.fixture
def f32_pallas():
    """The JAX kernel in float32 (its default operands are bf16)."""
    old = wht_pallas._FWHT_PALLAS_DTYPE
    wht_pallas.set_fwht_backend(dtype="float32")
    yield
    wht_pallas.set_fwht_backend(dtype=old)


@pytest.mark.parametrize("w", [2, 1 << 5, 1 << 10, 1 << 13])
def test_fwht_matches_jax(w):
    x = np.random.default_rng(w).normal(size=(3, w)).astype(np.float32)
    got = twht.fwht(torch.as_tensor(x)).numpy()
    want = np.asarray(jwht.fwht(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("w", [1 << 4, 1 << 9])
def test_fwht_rows_match_closed_form(w):
    """Transforming unit vectors gives the rows of H_w, which equal the
    popcount closed form of both packages (exact: sums of +-1)."""
    rows = twht.fwht(torch.eye(w)).numpy()
    for r in (0, 1, w // 2 + 1, w - 1):
        np.testing.assert_array_equal(twht.fwht_matrix_row(w, r),
                                      jwht.fwht_matrix_row(w, r))
        np.testing.assert_array_equal(rows[r], twht.fwht_matrix_row(w, r))


@pytest.mark.parametrize("w", [8, 256])
def test_fwht_involution(w):
    """H H = w I exactly for small w (integer-valued float32 sums)."""
    H = twht.fwht(torch.eye(w))
    np.testing.assert_array_equal((H @ H).numpy(), w * np.eye(w))


def test_factorize_matches_jax():
    for log_w in range(1, 24):
        assert twht._factorize(log_w, None) == jwht._factorize(log_w, None)
    for mlf in (3, 8):
        assert twht._factorize(17, mlf) == jwht._factorize(17, mlf)


def test_fwht_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        twht.fwht(torch.zeros(2, 12))


@pytest.mark.parametrize("w", [1 << 10, 1 << 13])
@pytest.mark.parametrize("apply_pre", [True, False])
def test_fwht_signed_ref_matches_jax_kernel(f32_pallas, w, apply_pre):
    """The plain version against the Pallas kernel (interpret mode, f32)."""
    rng = np.random.default_rng(w + apply_pre)
    x = rng.normal(size=(2, w)).astype(np.float32)
    signs = (rng.integers(0, 2, (2, w)) * 2 - 1).astype(np.float32)
    want = wht_pallas.fwht_signed(jnp.asarray(x), jnp.asarray(signs), w,
                                  apply_pre, interpret=True)
    got = wht_cuda.fwht_signed_ref(torch.as_tensor(x), torch.as_tensor(signs),
                                   apply_pre)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-3)


def test_fwht_signed_shares_signs_across_batch():
    """Row r uses sign row r % E; signs=None is the bare transform."""
    rng = np.random.default_rng(0)
    E, B, w = 3, 2, 64
    x = torch.as_tensor(rng.normal(size=(B * E, w)).astype(np.float32))
    signs = torch.as_tensor((rng.integers(0, 2, (E, w)) * 2 - 1)
                            .astype(np.float32))
    pre = wht_cuda.fwht_signed(x, signs, apply_pre=True)
    post = wht_cuda.fwht_signed(x, signs, apply_pre=False)
    for r in range(B * E):
        s = signs[r % E]
        torch.testing.assert_close(pre[r], twht.fwht(x[r] * s))
        torch.testing.assert_close(post[r], twht.fwht(x[r]) * s)
    torch.testing.assert_close(wht_cuda.fwht_signed(x, None, True), twht.fwht(x))


def test_cpu_tensors_never_launch():
    before = wht_cuda.LAUNCHES
    wht_cuda.fwht_signed(torch.ones(2, 16), None, apply_pre=False)
    assert wht_cuda.LAUNCHES == before


@pytest.mark.parametrize("shape,signs_shape", [
    ((4, 12), None),                 # width not a power of two
    ((4, 16), (3, 16)),              # rows do not split into sign rows
    ((4, 16), (1, 8)),               # sign width differs
    ((16,), None),                   # not 2-D
])
def test_kernel_argument_checks(shape, signs_shape):
    x = torch.zeros(shape)
    signs = None if signs_shape is None else torch.ones(signs_shape)
    with pytest.raises(ValueError):
        wht_cuda._check(x, signs)


def test_kernel_argument_checks_dtype_and_width():
    with pytest.raises(ValueError):
        wht_cuda._check(torch.zeros(2, 16, dtype=torch.float64), None)
    with pytest.raises(ValueError):
        wht_cuda._check(torch.zeros(1, 1 << (wht_cuda.MAX_LOG_W + 1)), None)
    wht_cuda._check(torch.zeros(2, 16), torch.ones(2, 16))



# ---- K2: the two-sided form H_a . X . H_b (wht_pallas._kernel) ---------------
# Against the Pallas kernel in interpret mode on the same numpy rows: in
# float32 within 1e-5 of the largest entry (both sum float32 products, in
# another order); with bf16 operands within the relative Frobenius bound of
# chip_smoke.py phase 9, 1e-3 (a T entry whose float32 sum lands near a
# bf16 rounding boundary may round the other way in one package); on rows
# with entries in {-1, 0, 1} bit-equal, since every T entry is then an
# integer of magnitude <= b, which bf16 holds exactly.

@pytest.fixture
def pallas_dtype():
    old = wht_pallas._FWHT_PALLAS_DTYPE
    yield lambda dtype: wht_pallas.set_fwht_backend(dtype=dtype)
    wht_pallas.set_fwht_backend(dtype=old)


def _rows_2mm(w, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "ternary":
        x = rng.integers(-1, 2, (4, w)).astype(np.float32)
    else:
        x = rng.normal(size=(4, w)).astype(np.float32)
    signs = (rng.integers(0, 2, (2, w)) * 2 - 1).astype(np.float32)
    return x, signs


@pytest.mark.parametrize("w", [1 << 8, 1 << 10])
@pytest.mark.parametrize("apply_pre", [True, False])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("dtype,kind", [("float32", "gaussian"),
                                        ("bfloat16", "gaussian"),
                                        ("bfloat16", "ternary")])
def test_fwht_signed_2mm_ref_matches_jax_kernel(pallas_dtype, w, apply_pre, signed,
                                                dtype, kind):
    pallas_dtype(dtype)
    x, signs = _rows_2mm(w, kind, w + 2 * apply_pre + signed)
    if not signed:
        signs = np.ones_like(signs)
    # the JAX kernel takes one sign row per row: row r uses sign row r % 2
    want = np.asarray(wht_pallas._fwht_signed_2mm(
        jnp.asarray(x), jnp.asarray(np.tile(signs, (2, 1))), w, apply_pre,
        interpret=True))
    got = wht_cuda.fwht_signed_2mm_ref(
        torch.as_tensor(x), torch.as_tensor(signs) if signed else None, apply_pre,
        mm_dtype=dtype).numpy()
    if kind == "ternary":
        np.testing.assert_array_equal(got, want)
    elif dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


def test_fwht_signed_2mm_ref_equals_the_exact_transform_on_ternary_rows():
    """bf16 operands lose nothing on {-1, 0, 1} rows up to b = 256, so the
    plain version equals the float32 transform bit for bit."""
    x, signs = _rows_2mm(1 << 12, "ternary", 0)
    x, signs = torch.as_tensor(x), torch.as_tensor(signs)
    for sg, pre in ((signs, True), (signs, False), (None, True)):
        assert torch.equal(wht_cuda.fwht_signed_2mm_ref(x, sg, pre),
                           wht_cuda.fwht_signed_ref(x, sg, pre))


def test_split_ab_matches_jax():
    for log_w in range(0, 23):
        assert wht_cuda.split_ab(1 << log_w) == wht_pallas._split_ab(1 << log_w)


def test_cpu_tensors_never_launch_k2():
    before = (wht_cuda.LAUNCHES, wht_cuda.LAUNCHES_2MM)
    x = torch.ones(4, 1 << 9)
    wht_cuda.fwht_signed_2mm(x, torch.ones(2, 1 << 9), True)
    wht_cuda.fwht_signed_2mm(x, None, False, mm_dtype="float32")
    assert (wht_cuda.LAUNCHES, wht_cuda.LAUNCHES_2MM) == before


@pytest.mark.parametrize("shape,signs_shape,mm_dtype", [
    ((4, 128), None, "bfloat16"),              # below 2^8
    ((1, 1 << 21), None, "bfloat16"),          # above 2^20
    ((4, 384), None, "bfloat16"),              # not a power of two
    ((256,), None, "bfloat16"),                # not 2-D
    ((4, 256), None, "float16"),               # no such operand type
])
def test_k2_wrapper_rejects_bad_arguments(shape, signs_shape, mm_dtype):
    """The wrapper refuses these on any device, before a launch."""
    before = wht_cuda.LAUNCHES_2MM
    with pytest.raises(ValueError):
        wht_cuda.fwht_signed_2mm(torch.zeros(shape), None, True, mm_dtype)
    assert wht_cuda.LAUNCHES_2MM == before


def test_k2_kernel_argument_checks():
    """The checks a CUDA tensor passes before K2 launches (`_check`)."""
    with pytest.raises(ValueError):
        wht_cuda._check(torch.zeros(4, 256, dtype=torch.float64), None)
    with pytest.raises(ValueError):
        wht_cuda._check(torch.zeros(3, 256), torch.ones(2, 256))
    with pytest.raises(ValueError):
        wht_cuda._check(torch.zeros(256, 4).t(), None)
