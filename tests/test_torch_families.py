"""The port's AMP decode on power-allocated (PA) and spatially coupled (SC)
base matrices against the JAX package's, on the same design and y, and its
design stack against `stack_designs`.

y = A beta0 + noise is made once with the JAX design and numpy noise, and
both packages decode it with the design carried over by
`design_from_jax_leaves`. Every draw here converges. Tolerances:

* `fused_denoiser=False` (the plain tail in both packages): decisions and
  t_final equal; psi within rtol 1e-4 / atol 1e-6 and the NMSE trajectory
  within atol 1e-4 (the two FWHT chains and softmaxes sum float32 terms in
  other orders).
* the port's default tail: the port takes its fused tail at M = 32 and 64
  (M in [32, 4096]) where the JAX package keeps the plain one (it needs
  M % 128 == 0); the fused tail reassociates psi, which can move the
  rtol-1e-6 stop test by one iteration. Decisions equal, t_final within 1.
* `fwht_mode="2mm"`: K2 (its plain version on the CPU: bf16 operands)
  takes only the full offset-0 windows of width 2^14 to 2^20, where the
  JAX package routes its Pallas kernel; that is "sc-w14" here. Its
  rounding differs, so only the decisions are held to the JAX decode's,
  which here equal the transmitted message. On the other codes "2mm" is
  the float32 transform, bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.config import DecodeParams as JDecode
from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.models import sparc as jsparc
from ldpc_sparc_tpu.ops import transforms as jtr
from ldpc_sparc_tpu.utils import bits as jbits
from ldpc_sparc_tpu_torch import DecodeParams as TDecode
from ldpc_sparc_tpu_torch import SparcParams as TParams
from ldpc_sparc_tpu_torch.models import sparc as tsparc
from ldpc_sparc_tpu_torch.ops import transforms as ttr
from ldpc_sparc_tpu_torch.parity import design_from_jax_leaves

# name -> (SparcParams kwargs, awgn_var)
CODES = {
    "sc-m32": (dict(P=15.0, R=1.0, L=256, M=32, spatially_coupled=True, omega=3,
                    Lambda=8), 1.0),
    "sc-m64": (dict(P=15.0, R=1.0, L=256, M=64, spatially_coupled=True, omega=4,
                    Lambda=8), 1.6),
    "pa": (dict(P=15.0, R=1.4, L=256, M=32, power_allocated=True, B=32,
                R_PA_ratio=1.0), 1.0),
    # Mc = L*M/Lambda = 2^14: the smallest width at which "2mm" takes K2
    "sc-w14": (dict(P=15.0, R=1.0, L=256, M=512, spatially_coupled=True, omega=3,
                    Lambda=8), 1.0),
}
T_MAX = 20
BATCH = 3


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


def _problem(name, seed=3):
    """(jax design, port design, beta0, y) as numpy, y = A beta0 + noise."""
    kw, var = CODES[name]
    jp = JParams(**kw)
    jd = jtr.SparcDesign.for_params(jp, var, seed)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (BATCH, jp.bit_len)).astype(bool)
    beta0 = np.stack([np.asarray(jbits.bits_to_msg_vector(jnp.asarray(b), jp.M))
                      for b in bits])
    noise = rng.normal(size=(BATCH, jd.n)).astype(np.float32)
    x = np.asarray(jd.ab(jnp.asarray(beta0)))
    y = (x + noise * np.float32(np.sqrt(var))).astype(np.float32)
    return jd, design_from_jax_leaves(*jd.tree_flatten()), beta0, y


_JAX_CACHE = {}


def _jax_decode(name):
    if name not in _JAX_CACHE:
        kw, var = CODES[name]
        jd, td, beta0, y = _problem(name)
        want = jax.vmap(lambda yy, b0: jsparc.amp_decode(
            yy, jd, JParams(**kw), JDecode(t_max=T_MAX), var, b0))(
                jnp.asarray(y), jnp.asarray(beta0))
        _JAX_CACHE[name] = (td, beta0, y, want)
    return _JAX_CACHE[name]


def _port_decode(name, **kw):
    td, beta0, y, _ = _jax_decode(name)
    code, var = CODES[name]
    return tsparc.amp_decode(torch.as_tensor(y), td, TParams(**code),
                             TDecode(t_max=T_MAX), var,
                             beta0=torch.as_tensor(beta0), **kw)


@pytest.mark.parametrize("name", sorted(CODES))
def test_draws_converge(name):
    """The premise of the tolerances above: every codeword decodes."""
    _, beta0, _, want = _jax_decode(name)
    np.testing.assert_array_equal(np.asarray(want.beta), beta0)
    assert int(np.asarray(want.t_final).max()) < T_MAX - 1


@pytest.mark.parametrize("name", sorted(CODES))
def test_plain_tail_matches_jax(name):
    _, _, _, want = _jax_decode(name)
    got = _port_decode(name, fused_denoiser=False)
    np.testing.assert_array_equal(got.beta.numpy(), np.asarray(want.beta))
    np.testing.assert_array_equal(got.t_final.numpy(), np.asarray(want.t_final))
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.nmse.numpy(), np.asarray(want.nmse), atol=1e-4)
    Lc = TParams(**CODES[name][0]).base_matrix_shape()[1]
    assert got.nmse.shape == (BATCH, T_MAX, Lc)


@pytest.mark.parametrize("name", sorted(CODES))
def test_default_tail_matches_jax(name):
    _, _, _, want = _jax_decode(name)
    got = _port_decode(name)
    np.testing.assert_array_equal(got.beta.numpy(), np.asarray(want.beta))
    d = np.abs(got.t_final.numpy() - np.asarray(want.t_final))
    assert d.max() <= 1


@pytest.mark.parametrize("name", sorted(CODES))
def test_2mm_transform_decodes_like_jax(name):
    _, beta0, _, want = _jax_decode(name)
    got = _port_decode(name, fwht_mode="2mm")
    np.testing.assert_array_equal(got.beta.numpy(), np.asarray(want.beta))
    np.testing.assert_array_equal(got.beta.numpy(), beta0)


@pytest.mark.parametrize("name", sorted(CODES))
def test_2mm_takes_k2_only_where_jax_does(name):
    """K2 on full offset-0 windows of 2^14 to 2^20 (JAX's use_pallas_srht);
    elsewhere "2mm" gives the float32 products bit for bit. Complex data
    never takes K2 (use_pallas_srht refuses it): its "2mm" products are the
    float32 ones bit for bit on every code, "sc-w14" included."""
    td, beta0, y, _ = _jax_decode(name)
    # Gaussian inputs: beta0's 0/1 entries are exact in bf16
    b = torch.as_tensor(np.random.default_rng(0).normal(size=beta0.shape)
                        .astype(np.float32))
    z = torch.as_tensor(y)
    k2 = td.offset == 0 and 14 <= td.w.bit_length() - 1 <= 20
    assert k2 == (name == "sc-w14")
    assert torch.equal(td.ab(b, fwht_mode="2mm"), td.ab(b)) is not k2
    assert torch.equal(td.az(z, fwht_mode="2mm"), td.az(z)) is not k2
    bc, zc = torch.complex(b, b.flip(-1)), torch.complex(z, -z.flip(-1))
    assert torch.equal(td.ab(bc, fwht_mode="2mm"), td.ab(bc))
    assert torch.equal(td.az(zc, fwht_mode="2mm"), td.az(zc))


def test_design_shapes_cover_both_window_layouts():
    """The SC codes have offset-0 windows (w = Mc), the PA code an offset-1
    window on its tall blocks, so both srht_apply layouts are exercised."""
    assert [_jax_decode(n)[0].offset for n in ("sc-m32", "sc-m64", "sc-w14", "pa")
            ] == [0, 0, 0, 1]
    assert _jax_decode("sc-m32")[0].E > _jax_decode("sc-m32")[0].Lc


@pytest.mark.parametrize("name", ["pa", "sc-m32"])
def test_stack_designs_matches_jax(name):
    kw, var = CODES[name]
    jproto, jleaves = jtr.stack_designs(JParams(**kw), var, 7, 3)
    designs = ttr.stack_designs(TParams(**kw), var, 7, 3, device="cpu")
    assert len(designs) == 3
    for f, j in zip(("idx", "signs", "scale"), jleaves):
        t = torch.stack([getattr(d, f) for d in designs])
        assert t.shape == j.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for d in designs:
        assert (d.rows, d.cols, d.w, d.offset) == (
            jproto.rows, jproto.cols, jproto.w, jproto.offset)
    # the DFT engine serves complex plain codes only (tests/test_torch_dft.py)
    with pytest.raises(ValueError):
        ttr.stack_designs(TParams(**kw), var, 7, 3, engine="dft", device="cpu")


def test_fwht_mode_is_checked():
    td, _, y, _ = _jax_decode("sc-m32")
    with pytest.raises(ValueError):
        td.az(torch.as_tensor(y), fwht_mode="xla")
