"""K2 with float32 operands on the wgmma kernels, checked on the CPU.

The kernels themselves run only on the card (tests/test_torch_kernels.py,
chip_smoke.py phase 20). What can be held here: `k2_layout`'s float32
table, the wrapper's argument checks (they run before the device branch),
the arithmetic the kernels rest on, and the products as the kernels order
them, emulated in plain torch in this file:

* split3: each float32 v is hi = bf16(v), mid = bf16(v - hi), lo =
  bf16(v - hi - mid), rounded to nearest; hi + mid + lo equals v exactly
  (each residual has at most 15, then 7 significant bits).
* a product runs its three planes into one float32 accumulator, lo first,
  then mid, then hi; a factor is H_RAD (x) H_base, the butterfly in
  float32 after the three-plane H_base products: base 64 up to 2^15 (a
  factor of 128 or 256 is H_2 or H_4 (x) H_64), base 256 above (a factor
  of 512 or 1024 is H_2 or H_4 (x) H_256). On rows with entries in
  {-1, 0, 1} every sum is an integer below 2^24, so the emulation equals
  the exact transform bit for bit; on Gaussian rows it stays within 2.5e-6
  of the largest entry of the JAX package's float32 Pallas K2 in interpret
  mode (chip_smoke.py's K2F32_ABS_BOUND: the card's kernels read at most
  1.81e-6, a control without the lo plane at least 3.25e-6).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldpc_sparc_tpu.ops import wht_pallas
from ldpc_sparc_tpu_torch.ops import wht_cuda
from ldpc_sparc_tpu_torch.ops.wht import hadamard_factor

ABS_BOUND = 2.5e-6   # max|d| / max|ref|, as K2F32_ABS_BOUND in chip_smoke.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (the suite runs files in parallel);
    float32 matmuls at full precision (no TF32)."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


@pytest.fixture
def jax_pallas_f32():
    """The JAX package's Pallas K2 with float32 operands, in interpret mode."""
    old = (wht_pallas._FWHT_BACKEND, wht_pallas._FWHT_PALLAS_DTYPE,
           wht_pallas._FWHT_PALLAS_MODE)
    wht_pallas.set_fwht_backend(backend="pallas", dtype="float32", mode="2mm")
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        wht_pallas.set_fwht_backend(*old)


# ---- the table and the wrapper's checks ------------------------------------------

@pytest.mark.parametrize("log_w", list(range(8, 21)))
def test_k2_layout_float32_table(log_w):
    """float32 operands: the mma.sync pass kernels below 2^12, the wgmma
    tile layout (T on chip, one launch) from 2^12 to 2^15, the wgmma wide
    layout (T through device memory in float32, two launches) above."""
    want = (("mma", "passes") if log_w < 12 else
            ("wgmma", "tile") if log_w <= 15 else ("wgmma", "wide"))
    assert wht_cuda.k2_layout(log_w, "float32") == want
    # the bf16 operands' table is what it was
    assert wht_cuda.k2_layout(log_w) == wht_cuda.k2_layout(log_w, "bfloat16")
    a, b = wht_cuda.split_ab(1 << log_w)
    if want[1] == "tile":   # X's three planes fit a block's 227 KB
        assert 3 * 2 * a * b <= 192 * 1024


def test_k2_layout_rejects_an_unknown_operand_type():
    with pytest.raises(ValueError, match="mm_dtype"):
        wht_cuda.k2_layout(15, "float16")


@pytest.mark.parametrize("log_w", [8, 9, 10, 11])
def test_float32_wgmma_refused_below_2_12(log_w):
    x = torch.ones(2, 1 << log_w)
    with pytest.raises(ValueError, match="wgmma"):
        wht_cuda.fwht_signed_2mm(x, None, True, "float32", kernel="wgmma")
    # the table's kernel there is the pass kernels, which take any passes
    assert wht_cuda.fwht_signed_2mm(x, None, True, "float32", passes=1).shape == x.shape


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("log_w", [12, 13, 14, 15])
@pytest.mark.parametrize("kernel", [None, "wgmma"])
def test_float32_tile_layout_refuses_passes(log_w, passes, kernel):
    """The tile layout is one launch: there is no first or second alone."""
    with pytest.raises(ValueError, match="passes"):
        wht_cuda.fwht_signed_2mm(torch.ones(2, 1 << log_w), None, True, "float32",
                                 kernel=kernel, passes=passes)


@pytest.mark.parametrize("kernel,log_w", [("mma", 8), ("mma", 12), ("mma", 15),
                                          ("mma", 20), ("wgmma", 16), ("wgmma", 20),
                                          (None, 19)])
def test_float32_two_launch_kernels_take_passes(kernel, log_w):
    """The pass kernels at every width, and the wide layout, make two
    launches; on a CPU tensor the plain version runs whatever is named."""
    x = torch.ones(1, 1 << log_w)
    want = wht_cuda.fwht_signed_2mm_ref(x, None, True, "float32")
    for passes in (1, 2, 3):
        got = wht_cuda.fwht_signed_2mm(x, None, True, "float32", kernel=kernel,
                                       passes=passes)
        assert torch.equal(got, want)


# ---- split3 ------------------------------------------------------------------

def _split3(v: torch.Tensor):
    """The kernels' split3 in plain torch: round to nearest at each cast,
    float32 residuals."""
    hi = v.to(torch.bfloat16).float()
    r = v - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split3_is_exact_over_exponents(sign):
    """hi + mid + lo == v for float32 values with exponents -100 to 100 and
    random 24-bit significands."""
    rng = np.random.default_rng(7)
    sig = 1.0 + rng.integers(0, 1 << 23, 20_000) / float(1 << 23)
    v = torch.as_tensor((sign * sig * 2.0 ** rng.integers(-100, 101, sig.size))
                        .astype(np.float32))
    hi, mid, lo = _split3(v)
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())
    # the residuals stay below half a bf16 ulp of what they follow
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())


def test_split3_is_exact_on_zeros_and_powers_of_two():
    """Signed zeros and powers of two are their own hi plane."""
    pw = 2.0 ** np.arange(-100, 101)
    v = torch.as_tensor(np.concatenate([[0.0, -0.0], pw, -pw]).astype(np.float32))
    hi, mid, lo = _split3(v)
    assert torch.equal(hi, v)
    assert torch.equal(torch.signbit(hi), torch.signbit(v))
    assert not bool(mid.any()) and not bool(lo.any())
    assert torch.equal(hi.double() + mid.double() + lo.double(), v.double())


# ---- the products as the wgmma kernels order them -------------------------------

def _radix_product(v: torch.Tensor, n: int, base: int) -> torch.Tensor:
    """H_n . v along the last axis of v, n <= 4 base: each of the three
    planes of v against H_min(n, base), block by block of base, summed lo,
    mid, hi into one float32 accumulator; then, for n = 2 base or 4 base,
    the H_2 or H_4 butterfly in float32."""
    m = min(n, base)
    h = hadamard_factor(m, torch.float32, v.device)
    hi, mid, lo = _split3(v)
    acc = []
    for kb in range(n // m):
        sl = slice(kb * m, (kb + 1) * m)
        a = lo[..., sl] @ h
        a = a + mid[..., sl] @ h
        acc.append(a + hi[..., sl] @ h)
    if len(acc) == 2:
        acc = [acc[0] + acc[1], acc[0] - acc[1]]
    elif len(acc) == 4:
        p0, p1 = acc[0] + acc[1], acc[0] - acc[1]
        p2, p3 = acc[2] + acc[3], acc[2] - acc[3]
        acc = [p0 + p2, p1 + p3, p0 - p2, p1 - p3]
    return torch.cat(acc, -1)


def _k2_f32_emulated(x: torch.Tensor, signs: torch.Tensor | None,
                     apply_pre: bool) -> torch.Tensor:
    """Y = H_a . (X . H_b) on the (a, b) view of each row, both products
    as `_radix_product` (base 64 in the tile layout, 256 in the wide one),
    T = X . H_b in float32 between them."""
    R, w = x.shape
    a, b = wht_cuda.split_ab(w)
    base = 64 if wht_cuda.k2_layout(w.bit_length() - 1, "float32")[1] == "tile" else 256
    E = 1 if signs is None else signs.shape[0]
    xv = x.reshape(R // E, E, a, b)
    sv = None if signs is None else signs.reshape(E, a, b)
    if sv is not None and apply_pre:
        xv = xv * sv
    t = _radix_product(xv, b, base)
    y = _radix_product(t.transpose(-1, -2), a, base).transpose(-1, -2)
    if sv is not None and not apply_pre:
        y = y * sv
    return y.reshape(R, w)


def _rows(log_w: int, kind: str, seed: int, rows: int = 2):
    rng = np.random.default_rng(seed)
    w = 1 << log_w
    if kind == "ternary":
        x = rng.integers(-1, 2, (rows, w)).astype(np.float32)
    else:
        x = rng.normal(size=(rows, w)).astype(np.float32)
    signs = (2 * rng.integers(0, 2, (rows, w)) - 1).astype(np.float32)
    return x, signs


@pytest.mark.parametrize("mode", ["pre", "post", "none"])
@pytest.mark.parametrize("log_w", [14, 15, 18, 19])
def test_emulated_products_are_exact_on_ternary_rows(log_w, mode):
    x, signs = _rows(log_w, "ternary", log_w)
    xt = torch.as_tensor(x)
    st = None if mode == "none" else torch.as_tensor(signs)
    got = _k2_f32_emulated(xt, st, mode == "pre")
    want = wht_cuda.fwht_signed_ref(xt, st, mode == "pre")
    assert torch.equal(got, want)


@pytest.mark.parametrize("apply_pre", [True, False])
@pytest.mark.parametrize("log_w", [14, 15, 18, 19])
def test_emulated_products_match_jax_pallas_f32(log_w, apply_pre, jax_pallas_f32):
    """Within 2.5e-6 of the largest entry of JAX's float32 Pallas K2, which
    runs two float32 dots: the same exact partial products, their float32
    sums in another order."""
    x, signs = _rows(log_w, "gaussian", 100 + log_w)
    want = np.asarray(wht_pallas._fwht_signed_2mm(
        jnp.asarray(x), jnp.asarray(signs), 1 << log_w, apply_pre, interpret=True))
    got = _k2_f32_emulated(torch.as_tensor(x), torch.as_tensor(signs), apply_pre).numpy()
    assert np.abs(got - want).max() <= ABS_BOUND * np.abs(want).max()
    # and the port's plain version, two float32 matmuls, agrees as closely
    plain = wht_cuda.fwht_signed_2mm_ref(torch.as_tensor(x), torch.as_tensor(signs),
                                         apply_pre, "float32").numpy()
    assert np.abs(got - plain).max() <= ABS_BOUND * np.abs(plain).max()
