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
from ldpc_sparc_tpu_torch.utils.tracing import counters


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
    before = counters()["k1.launches"]
    wht_cuda.fwht_signed(torch.ones(2, 16), None, apply_pre=False)
    assert counters()["k1.launches"] == before


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


@pytest.mark.parametrize("w", [1 << 14, 1 << 16])
@pytest.mark.parametrize("apply_pre", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fwht_signed_2mm_ref_matches_jax_kernel_at_k2_widths(pallas_dtype, w, apply_pre,
                                                            dtype):
    """The widths "2mm" sends to K2 (2^14 and up), one of each layout of the
    Hopper kernel (the intermediate on chip at 2^14, through device memory
    at 2^16), both operand types. float32: both sum exact float32 products
    in another order, so within 1e-5 of the largest entry (the bound the
    float32 transforms are held to). bf16: a T entry whose float32 sum lands
    near a rounding boundary may round the other way in one package, one
    bf16 ulp on about 2^-10 of the entries, a relative Frobenius error near
    1e-4; a wrong sign or index gives 5e-3 or more, so 1e-3 separates them."""
    pallas_dtype(dtype)
    x, signs = _rows_2mm(w, "gaussian", w + apply_pre)
    want = np.asarray(wht_pallas._fwht_signed_2mm(
        jnp.asarray(x), jnp.asarray(np.tile(signs, (2, 1))), w, apply_pre,
        interpret=True))
    got = wht_cuda.fwht_signed_2mm_ref(torch.as_tensor(x), torch.as_tensor(signs),
                                       apply_pre, mm_dtype=dtype).numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


@pytest.mark.parametrize("log_w", list(range(8, 21)))
def test_k2_layout_table(log_w):
    """K2's kernel and layout are a fixed function of the width: `mma.sync`
    below 2^12 (a Hadamard factor narrower than a 64-row wgmma tile), wgmma
    from there; the intermediate on chip up to 2^15, through device memory
    above."""
    kernel, layout = wht_cuda.k2_layout(log_w)
    assert kernel == ("mma" if log_w < 12 else "wgmma")
    assert layout == ("tile" if log_w <= 15 else "wide")
    a, b = wht_cuda.split_ab(1 << log_w)
    assert (kernel == "wgmma") == (a >= 64 and b >= 64)
    assert (layout == "tile") == (2 * a * b <= 1 << 16)   # the row's bf16 tile: 64 KB


@pytest.mark.parametrize("log_w", [0, 7, 21, 22])
def test_k2_layout_table_rejects_widths_outside(log_w):
    with pytest.raises(ValueError):
        wht_cuda.k2_layout(log_w)


def test_k2_kernel_and_passes_arguments():
    """`kernel` and `passes` are checked on any device, before a launch; a
    CPU tensor then runs the plain version whatever kernel is named."""
    x = torch.ones(2, 1 << 12)
    want = wht_cuda.fwht_signed_2mm_ref(x, None, True)
    for kernel in (None, "mma", "wgmma"):
        assert torch.equal(wht_cuda.fwht_signed_2mm(x, None, True, kernel=kernel), want)
    with pytest.raises(ValueError, match="kernel"):
        wht_cuda.fwht_signed_2mm(x, None, True, kernel="cublas")
    with pytest.raises(ValueError, match="wgmma"):
        wht_cuda.fwht_signed_2mm(torch.ones(2, 1 << 11), None, True, kernel="wgmma")
    with pytest.raises(ValueError, match="passes"):
        wht_cuda.fwht_signed_2mm(x, None, True, passes=1)
    with pytest.raises(ValueError, match="passes"):
        wht_cuda.fwht_signed_2mm(torch.ones(1, 1 << 16), None, True, passes=0)
    assert wht_cuda.fwht_signed_2mm(torch.ones(1, 1 << 16), None, True,
                                    passes=2).shape == (1, 1 << 16)


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
    before = (counters()["k1.launches"], counters()["k2.launches"])
    x = torch.ones(4, 1 << 9)
    wht_cuda.fwht_signed_2mm(x, torch.ones(2, 1 << 9), True)
    wht_cuda.fwht_signed_2mm(x, None, False, mm_dtype="float32")
    assert (counters()["k1.launches"], counters()["k2.launches"]) == before


@pytest.mark.parametrize("shape,signs_shape,mm_dtype", [
    ((4, 128), None, "bfloat16"),              # below 2^8
    ((1, 1 << 21), None, "bfloat16"),          # above 2^20
    ((4, 384), None, "bfloat16"),              # not a power of two
    ((256,), None, "bfloat16"),                # not 2-D
    ((4, 256), None, "float16"),               # no such operand type
])
def test_k2_wrapper_rejects_bad_arguments(shape, signs_shape, mm_dtype):
    """The wrapper refuses these on any device, before a launch."""
    before = counters()["k2.launches"]
    with pytest.raises(ValueError):
        wht_cuda.fwht_signed_2mm(torch.zeros(shape), None, True, mm_dtype)
    assert counters()["k2.launches"] == before


def test_k2_kernel_argument_checks():
    """The checks a CUDA tensor passes before K2 launches (`_check`)."""
    with pytest.raises(ValueError):
        wht_cuda._check(torch.zeros(4, 256, dtype=torch.float64), None)
    with pytest.raises(ValueError):
        wht_cuda._check(torch.zeros(3, 256), torch.ones(2, 256))
    with pytest.raises(ValueError):
        wht_cuda._check(torch.zeros(256, 4).t(), None)


# ---- K1's routes and the SRHT products folded into it -------------------------
# The fused entry points run their plain versions on CPU tensors. Against
# the JAX package's srht_apply on the same numpy inputs (offset 0, no block
# scale) within 1e-5 of the largest entry: both are float32 throughout, with
# torch's matmul precision "highest" (the module fixture) and the JAX chain
# in float32; the two chains sum the same terms in another order.

def _srht_inputs(E, B, k, w, seed):
    rng = np.random.default_rng(seed)
    idx = np.stack([np.sort(rng.choice(w, k, replace=False)) for _ in range(E)])
    signs = (rng.integers(0, 2, (E, w)) * 2 - 1).astype(np.float32)
    vals = rng.normal(size=(B, E, k)).astype(np.float32)
    x = rng.normal(size=(B, E, w)).astype(np.float32)
    return idx.astype(np.int32), signs, vals, x


@pytest.mark.parametrize("E,B,k,w", [(1, 1, 9, 64), (1, 3, 40, 1 << 10),
                                     (3, 2, 17, 1 << 9), (2, 1, 256, 256),
                                     (2, 2, 1, 32)])
def test_fused_srht_products_match_jax_srht_apply(E, B, k, w):
    from ldpc_sparc_tpu.ops import transforms as jtr
    idx, signs, vals, x = _srht_inputs(E, B, k, w, seed=E + B + k)
    want_s = np.stack([np.asarray(jtr.srht_apply(
        jnp.asarray(vals[b]), jnp.asarray(idx), jnp.asarray(signs), w, k, w,
        idx_side_is_input=True, offset=0)) for b in range(B)])
    want_g = np.stack([np.asarray(jtr.srht_apply(
        jnp.asarray(x[b]), jnp.asarray(idx), jnp.asarray(signs), w, w, k,
        idx_side_is_input=False, offset=0)) for b in range(B)])
    for dtype in (torch.int32, torch.int64):
        ti = torch.as_tensor(idx).to(dtype)
        got_s = wht_cuda.srht_scatter_fwht(
            torch.as_tensor(vals).reshape(B * E, k), ti, torch.as_tensor(signs), w)
        got_g = wht_cuda.srht_fwht_gather(
            torch.as_tensor(x).reshape(B * E, w), torch.as_tensor(signs), ti)
        assert got_s.shape == (B * E, w) and got_g.shape == (B * E, k)
        assert np.abs(got_s.numpy().reshape(B, E, w) - want_s).max() \
            <= 1e-5 * np.abs(want_s).max()
        assert np.abs(got_g.numpy().reshape(B, E, k) - want_g).max() \
            <= 1e-5 * np.abs(want_g).max()


@pytest.mark.parametrize("apply_pre", [True, False])
@pytest.mark.parametrize("signed", [True, False])
def test_fused_srht_products_equal_the_composition_bit_for_bit(apply_pre, signed):
    """The zero fill, scatter_, transform, gather composition srht_apply was
    made of, written out here."""
    E, B, k, w = 3, 2, 21, 128
    idx, signs, vals, x = _srht_inputs(E, B, k, w, seed=7)
    ti = torch.as_tensor(idx).long()
    ts = torch.as_tensor(signs) if signed else None
    X = torch.zeros(B, E, w)
    X.scatter_(-1, ti.expand(B, E, -1), torch.as_tensor(vals))
    want_s = wht_cuda.fwht_signed_ref(X.reshape(B * E, w), ts, apply_pre)
    Y = wht_cuda.fwht_signed_ref(torch.as_tensor(x).reshape(B * E, w), ts, apply_pre)
    want_g = Y.reshape(B, E, w).gather(-1, ti.expand(B, E, -1)).reshape(B * E, k)
    tv, tx = torch.as_tensor(vals).reshape(B * E, k), torch.as_tensor(x).reshape(B * E, w)
    for fn_s, fn_g in ((wht_cuda.srht_scatter_fwht, wht_cuda.srht_fwht_gather),
                       (wht_cuda.srht_scatter_fwht_ref, wht_cuda.srht_fwht_gather_ref)):
        assert torch.equal(fn_s(tv, torch.as_tensor(idx), ts, w, apply_pre), want_s)
        assert torch.equal(fn_g(tx, ts, torch.as_tensor(idx), apply_pre), want_g)


def test_cpu_tensors_never_launch_the_fused_products():
    before = counters()["k1.launches"]
    idx = torch.tensor([[0, 3, 5]], dtype=torch.int32)
    wht_cuda.srht_scatter_fwht(torch.ones(2, 3), idx, None, 8)
    wht_cuda.srht_fwht_gather(torch.ones(2, 8), torch.ones(1, 8), idx)
    wht_cuda.fwht_signed(torch.ones(2, 1 << 10), None, False, route="two_pass")
    assert counters()["k1.launches"] == before


_IDX = torch.tensor([[0, 3, 5]], dtype=torch.int32)


@pytest.mark.parametrize("vals,idx,signs,w", [
    (torch.ones(2, 3, dtype=torch.float64), _IDX, None, 8),       # dtype
    (torch.ones(3), _IDX[0], None, 8),                            # not 2-D
    (torch.ones(3, 2).t(), _IDX, None, 8),                        # not contiguous
    (torch.ones(2, 3), _IDX, None, 12),                           # width
    (torch.ones(2, 3), _IDX.float(), None, 8),                    # idx dtype
    (torch.ones(2, 4), _IDX, None, 8),                            # k differs
    (torch.ones(3, 3), _IDX.repeat(2, 1), None, 8),               # rows % E
    (torch.ones(2, 3), torch.tensor([[0, 3, 8]]), None, 8),       # idx >= w
    (torch.ones(2, 3), torch.tensor([[-1, 3, 5]]), None, 8),      # idx < 0
    (torch.ones(2, 3), _IDX, torch.ones(2, 8), 8),                # E of signs
    (torch.ones(2, 3), _IDX, torch.ones(1, 4), 8),                # sign width
    (torch.ones(2, 3), _IDX.to("meta"), None, 8),                 # another device
])
def test_srht_scatter_fwht_rejects_bad_arguments(vals, idx, signs, w):
    before = counters()["k1.launches"]
    with pytest.raises(ValueError):
        wht_cuda.srht_scatter_fwht(vals, idx, signs, w)
    assert counters()["k1.launches"] == before


@pytest.mark.parametrize("x,signs,idx", [
    (torch.ones(2, 8, dtype=torch.float64), None, _IDX),          # dtype
    (torch.ones(8), None, _IDX),                                  # not 2-D
    (torch.ones(8, 2).t(), None, _IDX),                           # not contiguous
    (torch.ones(2, 12), None, _IDX),                              # width
    (torch.ones(2, 8), None, _IDX.double()),                      # idx dtype
    (torch.ones(3, 8), None, _IDX.repeat(2, 1)),                  # rows % E
    (torch.ones(2, 8), None, torch.tensor([[0, 3, 8]])),          # idx >= w
    (torch.ones(2, 8), torch.ones(2, 8), _IDX),                   # E of signs
    (torch.ones(2, 8), None, _IDX.to("meta")),                    # another device
    (torch.ones(2, 8), None, _IDX.repeat(1, 2)[:, ::2]),          # idx not contiguous
])
def test_srht_fwht_gather_rejects_bad_arguments(x, signs, idx):
    before = counters()["k1.launches"]
    with pytest.raises(ValueError):
        wht_cuda.srht_fwht_gather(x, signs, idx)
    assert counters()["k1.launches"] == before


def test_validate_false_skips_only_the_range_check():
    """validate=False leaves out the one check that reads the indices."""
    with pytest.raises(ValueError):
        wht_cuda.srht_scatter_fwht(torch.ones(2, 4), _IDX, None, 8, validate=False)
    got = wht_cuda.srht_fwht_gather(torch.ones(2, 8), None, _IDX, validate=False)
    assert got.shape == (2, 3)


@pytest.mark.parametrize("route,log_w", [("block", 16), ("cluster", 15),
                                         ("cluster", 20), ("two_pass", 9),
                                         ("rows", 10)])
def test_a_route_that_cannot_take_the_width_raises(route, log_w):
    with pytest.raises(ValueError):
        wht_cuda.fwht_signed(torch.zeros(1, 1 << log_w), None, False, route=route)
    if log_w <= 16:
        idx = torch.zeros(1, 1, dtype=torch.int32)
        with pytest.raises(ValueError):
            wht_cuda.srht_fwht_gather(torch.zeros(1, 1 << log_w), None, idx,
                                      route=route)
        with pytest.raises(ValueError):
            wht_cuda.srht_scatter_fwht(torch.zeros(1, 1), idx, None, 1 << log_w,
                                       route=route)


def test_fused_products_have_no_two_pass_route():
    idx = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="two_pass"):
        wht_cuda.srht_fwht_gather(torch.zeros(1, 1 << 10), None, idx,
                                  route="two_pass")
    with pytest.raises(ValueError, match="two_pass"):
        wht_cuda.srht_scatter_fwht(torch.zeros(1, 1), idx, None, 1 << 10,
                                   route="two_pass")


@pytest.mark.parametrize("log_w", range(0, 23))
def test_route_table(log_w):
    """The documented table: one block up to 2^15, a cluster of w / 2^15
    blocks up to 2^19, two passes above; every width has exactly the routes
    ROUTE_LOG_W lists."""
    want = (("block", 1) if log_w <= 15 else
            ("cluster", {16: 2, 17: 4, 18: 8, 19: 16}[log_w]) if log_w <= 19 else
            ("two_pass", 1))
    assert wht_cuda.fwht_route(log_w) == want
    lo, hi = wht_cuda.ROUTE_LOG_W[want[0]]
    assert lo <= log_w <= hi
    assert wht_cuda._route_code(None, log_w) == wht_cuda.ROUTES.index(want[0])
    takes = {r for r in wht_cuda.ROUTES
             if wht_cuda.ROUTE_LOG_W[r][0] <= log_w <= wht_cuda.ROUTE_LOG_W[r][1]}
    assert takes == {r for r, ok in (("block", log_w <= 15),
                                     ("cluster", 16 <= log_w <= 19),
                                     ("two_pass", log_w >= 10)) if ok}


def test_route_table_rejects_widths_outside():
    for log_w in (-1, 23):
        with pytest.raises(ValueError):
            wht_cuda.fwht_route(log_w)
