"""The port's design products on complex data against the JAX package's:
the SRHT design (`SparcDesign`, `srht_apply` on stacked real and imaginary
rows) and the DFT design engine (`DftDesign`, `stack_designs(engine="dft")`).

* SRHT products: the JAX design carried over by `design_from_jax_leaves`,
  complex inputs from numpy, at an offset-0 and an offset-1 window; within
  1e-5 * max|ref|, the bound `chip_smoke.py` holds K1 to (the two FWHT
  chains sum float32 terms in other orders).
* DFT designs: rows and cols bit-identical to JAX's from an int and a tuple
  seed; `ab` and `az` within 1e-4 of max|ref| (two FFT libraries, float32).
* Both: the adjoint identity <A x, y> = <x, A^H y> to float32 rounding.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.ops import transforms as jtr
from ldpc_sparc_tpu_torch import SparcParams as TParams
from ldpc_sparc_tpu_torch.models.sparc import design_for_params
from ldpc_sparc_tpu_torch.ops import transforms as ttr
from ldpc_sparc_tpu_torch.ops import wht_cuda
from ldpc_sparc_tpu_torch.parity import design_from_jax_leaves, dft_design_from_numpy

# name -> SparcParams kwargs (awgn_var 1)
SRHT = {
    # LM = 2048 = w: an offset-0 window, n = 788 on the index side
    "k4-offset0": dict(P=15.0, R=2.6, L=256, M=8, modulated=True, K=4,
                       is_complex=True),
    # LM = 768: an offset-1 window of w = 1024
    "k1-offset1": dict(P=15.0, R=1.3, L=48, M=16, is_complex=True),
}
K4 = dict(P=15.0, R=2.6, L=128, M=8, modulated=True, K=4, is_complex=True)


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


def _within(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.complex64
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _vdot_rel(A_x, y, x, AH_y):
    lhs, rhs = np.vdot(y, A_x), np.vdot(AH_y, x)
    return abs(lhs - rhs) / abs(lhs)


# ---- the SRHT design on complex data -------------------------------------------

def _srht(name, seed=5):
    jd = jtr.SparcDesign.for_params(JParams(**SRHT[name]), 1.0, seed)
    return jd, design_from_jax_leaves(*jd.tree_flatten())


@pytest.mark.parametrize("name", sorted(SRHT))
def test_complex_srht_products_match_jax(name):
    jd, td = _srht(name)
    assert td.offset == (0 if name == "k4-offset0" else 1)
    rng = np.random.default_rng(1)
    beta, z = _cx(rng, (3, td.LM)), _cx(rng, (3, td.n))
    want_ab = np.stack([np.asarray(jd.ab(jnp.asarray(b))) for b in beta])
    want_az = np.stack([np.asarray(jd.az(jnp.asarray(v))) for v in z])
    _within(td.ab(torch.as_tensor(beta)).numpy(), want_ab, 1e-5)
    _within(td.az(torch.as_tensor(z)).numpy(), want_az, 1e-5)


@pytest.mark.parametrize("name", sorted(SRHT))
def test_complex_srht_is_its_parts_and_adjoint(name):
    """A (x + i y) = A x + i A y bit for bit (one stacked call against two
    real ones), and <A x, y> = <x, A^T y>."""
    _, td = _srht(name)
    rng = np.random.default_rng(2)
    x, y = torch.as_tensor(_cx(rng, (2, td.LM))), torch.as_tensor(_cx(rng, (2, td.n)))
    ax, ahy = td.ab(x), td.az(y)
    assert torch.equal(ax, torch.complex(td.ab(x.real.contiguous()),
                                         td.ab(x.imag.contiguous())))
    assert torch.equal(ahy, torch.complex(td.az(y.real.contiguous()),
                                          td.az(y.imag.contiguous())))
    for i in range(2):
        assert _vdot_rel(ax[i].numpy(), y[i].numpy(), x[i].numpy(),
                         ahy[i].numpy()) < 1e-5


def test_complex_srht_stacks_one_transform_call(monkeypatch):
    """One transform call a product, on 2B real rows: the real rows, then
    the imaginary ones."""
    _, td = _srht("k1-offset1")
    seen = []
    real = wht_cuda.srht_fwht_gather_ref

    def recording(x, *a, **k):
        seen.append(x.clone())
        return real(x, *a, **k)

    monkeypatch.setattr(ttr, "srht_fwht_gather_ref", recording)
    beta = torch.as_tensor(_cx(np.random.default_rng(3), (3, td.LM)))
    td.ab(beta)
    assert len(seen) == 1 and seen[0].shape == (2 * 3 * td.E, td.w)
    off, d = td.offset, td.Mc
    rows = seen[0].reshape(2, 3, td.w)[..., off:off + d]
    assert torch.equal(rows[0], beta.real * td.signs)
    assert torch.equal(rows[1], beta.imag * td.signs)


def test_complex_data_never_takes_k2(monkeypatch):
    """fwht_mode="2mm" on complex data is the float32 transform bit for bit,
    even on a full offset-0 window of 2^14 (where real data takes K2)."""
    kw = dict(P=15.0, R=2.6, L=2048, M=8, modulated=True, K=4, is_complex=True)
    td = ttr.SparcDesign.for_params(TParams(**kw), 1.0, 0, device="cpu")
    assert (td.offset, td.w) == (0, 1 << 14)
    called = []
    for name in ("fwht_signed_2mm", "fwht_signed_2mm_ref"):
        real = getattr(ttr, name)
        monkeypatch.setattr(ttr, name, lambda *a, _f=real, **k: called.append(1) or _f(*a, **k))
    b = torch.as_tensor(_cx(np.random.default_rng(4), (1, td.LM)))
    assert torch.equal(td.ab(b, fwht_mode="2mm"), td.ab(b))
    assert torch.equal(td.az(td.ab(b), fwht_mode="2mm"), td.az(td.ab(b)))
    assert not called
    td.ab(b.real.contiguous(), fwht_mode="2mm")      # real data: K2's plain version
    assert called


# ---- the DFT design engine ------------------------------------------------------

@pytest.mark.parametrize("seed", [3, (7, 2)])
def test_dft_design_rows_and_cols_bit_identical(seed):
    jd = jtr.DftDesign.for_params(JParams(**K4), 1.0, seed)
    td = ttr.DftDesign.for_params(TParams(**K4), 1.0, seed, device="cpu")
    np.testing.assert_array_equal(td.rows.numpy(), np.asarray(jd.rows))
    np.testing.assert_array_equal(td.cols.numpy(), np.asarray(jd.cols))
    assert (td.w, td.n, td.LM, td.scale) == jd.tree_flatten()[1]
    assert 0 not in td.rows and td.w // 2 not in td.rows
    assert 0 not in td.cols and td.w // 2 not in td.cols


def test_dft_products_match_jax_and_are_adjoint():
    jd = jtr.DftDesign.for_params(JParams(**K4), 1.0, 3)
    leaves, aux = jd.tree_flatten()
    td = dft_design_from_numpy(*leaves, aux)
    rng = np.random.default_rng(0)
    beta, z = _cx(rng, (2, td.LM)), _cx(rng, (2, td.n))
    got_ab, got_az = td.ab(torch.as_tensor(beta)), td.az(torch.as_tensor(z))
    _within(got_ab.numpy(), np.stack([np.asarray(jd.ab(jnp.asarray(b))) for b in beta]),
            1e-4)
    _within(got_az.numpy(), np.stack([np.asarray(jd.az(jnp.asarray(v))) for v in z]),
            1e-4)
    for i in range(2):
        assert _vdot_rel(got_ab[i].numpy(), z[i], beta[i], got_az[i].numpy()) < 1e-5
    # every entry of A is sqrt(P/L) in modulus
    A = td.dense()
    assert A.shape == (td.n, td.LM)
    np.testing.assert_allclose(np.abs(A), np.sqrt(K4["P"] / K4["L"]), rtol=1e-4)


def test_dft_stack_designs_matches_jax():
    jproto, (jrows, jcols) = jtr.stack_designs(JParams(**K4), 1.0, 7, 3, engine="dft")
    designs = ttr.stack_designs(TParams(**K4), 1.0, 7, 3, engine="dft", device="cpu")
    np.testing.assert_array_equal(torch.stack([d.rows for d in designs]).numpy(),
                                  np.asarray(jrows))
    np.testing.assert_array_equal(torch.stack([d.cols for d in designs]).numpy(),
                                  np.asarray(jcols))
    assert all(isinstance(d, ttr.DftDesign) and d.w == jproto.w for d in designs)


def test_dft_engine_takes_complex_plain_codes_only():
    assert isinstance(design_for_params(TParams(**K4), 1.0, 0, engine="dft",
                                        device="cpu"), ttr.DftDesign)
    with pytest.raises(ValueError, match="complex"):
        design_for_params(TParams(P=15.0, R=1.0, L=32, M=8), 1.0, 0, engine="dft",
                          device="cpu")
    with pytest.raises(ValueError, match="plain"):
        design_for_params(TParams(P=15.0, R=1.0, L=32, M=8, is_complex=True,
                                  power_allocated=True, B=4, R_PA_ratio=1.0),
                          1.0, 0, engine="dft", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        ttr.stack_designs(TParams(**K4), 1.0, 0, 2, engine="dct", device="cpu")
