"""The parts of the TPU kernels' range the port took last: K3 (the fused
denoiser tail) for sections of 8192 entries and more, and K2 with float32
operands (`fwht_mode="2mm_f32"`), against the JAX package on the same numpy
inputs. On the CPU the port's wrappers run their plain versions; the JAX
package runs its Pallas kernels in interpret mode.

Tolerances:

* K3: tests/test_torch_denoiser.py's (s within rtol 1e-6, the softmax and
  the section energies within rtol 1e-5: exp and a sum of M terms,
  reassociated). A decode through it: decisions equal, t_final within 1
  (the fused tail reassociates psi, which can move the stop test by one
  iteration; ROADMAP section 3).
* K2 with float32 operands: float32 in both packages, the sums in another
  order, so the design products agree within 1e-5 of the largest entry
  (tests/test_torch_wht.py's bound for float32 K2), and a decode through
  the plain denoiser tail gives equal decisions and t_final.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ldpc_sparc_tpu.config import DecodeParams as JDecode
from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.models import sparc as jsparc
from ldpc_sparc_tpu.ops import denoiser_pallas, wht_pallas
from ldpc_sparc_tpu.ops import transforms as jtr
from ldpc_sparc_tpu.utils import bits as jbits
from ldpc_sparc_tpu_torch import DecodeParams as TDecode
from ldpc_sparc_tpu_torch import SparcParams as TParams
from ldpc_sparc_tpu_torch import cli
from ldpc_sparc_tpu_torch.models import sparc as tsparc
from ldpc_sparc_tpu_torch.ops import denoiser_cuda
from ldpc_sparc_tpu_torch.ops import transforms as ttr
from ldpc_sparc_tpu_torch.parallel import montecarlo as tmc
from ldpc_sparc_tpu_torch.parity import design_from_jax_leaves
from ldpc_sparc_tpu_torch.utils.tracing import counters


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
    """The JAX package's srht_apply through its Pallas K2 with float32
    operands, in interpret mode."""
    old = (wht_pallas._FWHT_BACKEND, wht_pallas._FWHT_PALLAS_DTYPE,
           wht_pallas._FWHT_PALLAS_MODE)
    wht_pallas.set_fwht_backend(backend="pallas", dtype="float32", mode="2mm")
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        wht_pallas.set_fwht_backend(*old)


def _problem(kw, var, batch, seed):
    """(jax design, port design, beta0, y) as numpy, y = A beta0 + noise
    through the JAX package's default float32 products."""
    jp = JParams(**kw)
    jd = jtr.SparcDesign.for_params(jp, var, seed)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, jp.bit_len)).astype(bool)
    beta0 = np.stack([np.asarray(jbits.bits_to_msg_vector(jnp.asarray(b), jp.M))
                      for b in bits])
    noise = rng.normal(size=(batch, jd.n)).astype(np.float32)
    x = np.asarray(jd.ab(jnp.asarray(beta0)))
    y = (x + noise * np.float32(np.sqrt(var))).astype(np.float32)
    return jd, design_from_jax_leaves(*jd.tree_flatten()), beta0, y


def _jax_decode(jd, kw, var, t_max, y, beta0):
    return jax.vmap(lambda yy, b0: jsparc.amp_decode(
        yy, jd, JParams(**kw), JDecode(t_max=t_max), var, b0))(
            jnp.asarray(y), jnp.asarray(beta0))


# ---- K3 at sections of 8192 and more --------------------------------------------

@pytest.mark.parametrize("log_m", list(range(5, 23)))
def test_fused_eligible_takes_every_power_of_two_to_2_22(log_m):
    """The JAX kernel's range: every real K=1 code, M % 128 == 0 below its
    memory bound, and config.py keeps M a power of two; the port's kernel
    starts at 32 (one warp) and goes to 2^22."""
    M = 1 << log_m
    assert denoiser_cuda.fused_eligible(M, 1, False)
    assert not denoiser_cuda.fused_eligible(M, 2, False)
    assert not denoiser_cuda.fused_eligible(M, 1, True)


@pytest.mark.parametrize("M", [1 << 13, 1 << 14])
def test_fused_tail_matches_jax_kernel_at_long_sections(M):
    """The plain version (what the wrapper runs on a CPU tensor) against the
    Pallas kernel in interpret mode, L = 2 sections."""
    L = 2
    rng = np.random.default_rng(M)
    beta = rng.normal(size=L * M).astype(np.float32)
    azo = rng.normal(size=L * M).astype(np.float32)
    tau = rng.uniform(0.5, 2.0, L).astype(np.float32)
    want = denoiser_pallas.fused_denoise_update(
        jnp.asarray(beta), jnp.asarray(azo), jnp.asarray(tau), M, interpret=True)
    before = counters()["k3.launches"]
    got = denoiser_cuda.fused_denoise_update(
        torch.as_tensor(beta), torch.as_tensor(azo), torch.as_tensor(tau), M)
    assert counters()["k3.launches"] == before
    for g, w, rtol in zip(got, want, (1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=1e-6 if rtol == 1e-6 else 1e-7)


def test_amp_decode_through_k3_at_m8192_matches_jax_pallas():
    """amp_decode at L=4, M=8192 takes the fused tail by default in both
    packages (the JAX one under set_denoiser_backend("pallas"), interpret
    mode): decisions equal, t_final within 1."""
    kw, var, t_max = dict(P=15.0, R=1.0, L=4, M=8192), 0.5, 10
    jd, td, beta0, y = _problem(kw, var, 2, seed=1)
    old = denoiser_pallas._DENOISER_BACKEND
    denoiser_pallas.set_denoiser_backend("pallas")
    try:
        assert denoiser_pallas.use_fused_denoiser(M=kw["M"], K=1, LM=kw["L"] * kw["M"],
                                                  is_complex=False)
        with pltpu.force_tpu_interpret_mode():
            want = _jax_decode(jd, kw, var, t_max, y, beta0)
    finally:
        denoiser_pallas.set_denoiser_backend(old)
    calls = []
    real = tsparc.fused_denoise_update

    def counting(*a, **k):
        calls.append(a[-1])
        return real(*a, **k)

    tsparc.fused_denoise_update = counting
    try:
        got = tsparc.amp_decode(torch.as_tensor(y), td, TParams(**kw),
                                TDecode(t_max=t_max), var, beta0=torch.as_tensor(beta0))
    finally:
        tsparc.fused_denoise_update = real
    assert calls and set(calls) == {kw["M"]}
    np.testing.assert_array_equal(got.beta.numpy(), np.asarray(want.beta))
    np.testing.assert_array_equal(got.beta.numpy(), beta0)
    assert np.abs(got.t_final.numpy() - np.asarray(want.t_final)).max() <= 1


# ---- K2 with float32 operands: fwht_mode="2mm_f32" ---------------------------------

def test_2mm_f32_design_products_match_jax_pallas_f32(jax_pallas_f32):
    """A full offset-0 window of 2^14 (L=32, M=512): the port's "2mm_f32"
    products against JAX's float32 Pallas K2, within 1e-5 of the largest
    entry."""
    kw = dict(P=15.0, R=1.0, L=32, M=512)
    jd, td, _, y = _problem(kw, 1.0, 2, seed=4)
    assert td.offset == 0 and td.w == 1 << 14
    b = np.random.default_rng(0).normal(size=(2, td.LM)).astype(np.float32)
    for jfn, tfn, v in ((jd.ab, td.ab, b), (jd.az, td.az, y)):
        want = np.asarray(jax.vmap(jfn)(jnp.asarray(v)))
        got = tfn(torch.as_tensor(v), fwht_mode="2mm_f32").numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_2mm_f32_decode_matches_jax_pallas_f32(jax_pallas_f32):
    """L=32, M=512 decoded through K2 with float32 operands in both packages
    and the plain denoiser tail: decisions and t_final equal."""
    kw, var, t_max = dict(P=15.0, R=1.0, L=32, M=512), 1.0, 15
    jd, td, beta0, y = _problem(kw, var, 2, seed=4)
    want = _jax_decode(jd, kw, var, t_max, y, beta0)
    got = tsparc.amp_decode(torch.as_tensor(y), td, TParams(**kw), TDecode(t_max=t_max),
                            var, beta0=torch.as_tensor(beta0), fused_denoiser=False,
                            fwht_mode="2mm_f32")
    np.testing.assert_array_equal(got.beta.numpy(), np.asarray(want.beta))
    np.testing.assert_array_equal(got.t_final.numpy(), np.asarray(want.t_final))


ROUTING = {
    "plain-w14": dict(P=15.0, R=1.0, L=32, M=512),
    "sc-w14": dict(P=15.0, R=1.0, L=256, M=512, spatially_coupled=True, omega=3,
                   Lambda=8),
    "sc-w10": dict(P=15.0, R=1.0, L=256, M=32, spatially_coupled=True, omega=3,
                   Lambda=8),
    "pa": dict(P=15.0, R=1.4, L=256, M=32, power_allocated=True, B=32,
               R_PA_ratio=1.0),
    "complex-w14": dict(P=15.0, R=2.0, L=32, M=512, is_complex=True),
}


@pytest.mark.parametrize("name", sorted(ROUTING))
def test_2mm_f32_takes_k2_only_where_jax_does(name, monkeypatch):
    """K2 (with float32 operands) serves a product exactly where the JAX
    package's srht_apply takes its Pallas kernel (`use_pallas_srht` under
    backend "pallas"): a full offset-0 real window of 2^14 to 2^20."""
    kw = ROUTING[name]
    td = design_from_jax_leaves(
        *jtr.SparcDesign.for_params(JParams(**kw), 1.0, 2).tree_flatten())
    old = wht_pallas._FWHT_BACKEND
    wht_pallas.set_fwht_backend(backend="pallas")
    try:
        cx = bool(kw.get("is_complex"))
        Mr, Mc = td.n // td.Lr, td.LM // td.Lc
        jax_k2 = (wht_pallas.use_pallas_srht(td.w, td.offset, Mr == td.w, cx)
                  or wht_pallas.use_pallas_srht(td.w, td.offset, Mc == td.w, cx))
    finally:
        wht_pallas.set_fwht_backend(backend=old)
    dtypes = []
    real = ttr.fwht_signed_2mm

    def recording(*a, **k):
        dtypes.append(k.get("mm_dtype"))
        return real(*a, **k)

    monkeypatch.setattr(ttr, "fwht_signed_2mm", recording)
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.normal(size=(2, td.LM)).astype(np.float32))
    z = torch.as_tensor(rng.normal(size=(2, td.n)).astype(np.float32))
    if kw.get("is_complex"):
        b, z = torch.complex(b, b.flip(-1)), torch.complex(z, -z.flip(-1))
    td.ab(b, fwht_mode="2mm_f32")
    td.az(z, fwht_mode="2mm_f32")
    assert (len(dtypes) == 2) is jax_k2 and set(dtypes) <= {"float32"}
    assert jax_k2 is (name in ("plain-w14", "sc-w14"))


# ---- the sweep CLI ------------------------------------------------------------------

SWEEP = ["sparc-sweep", "--L", "32", "--M", "512", "--R", "1.0", "--t-max", "10",
         "--trials", "2", "--num-snrs", "2", "--snr-start", "15", "--snr-stop", "30",
         "--device", "cpu"]


def test_sweep_2mm_f32_keys_its_rows_apart_and_resumes(tmp_path, monkeypatch):
    calls = []
    real = tmc.sparc_ber_sweep

    def counting(*a, **k):
        calls.append(k.get("fwht_mode"))
        return real(*a, **k)

    monkeypatch.setattr(tmc, "sparc_ber_sweep", counting)
    rows = {}
    for mode in ("2mm", "2mm_f32"):
        rows[mode] = cli.main(SWEEP + ["--out", str(tmp_path), "--fwht-mode", mode])
    assert calls == ["2mm", "2mm", "2mm_f32", "2mm_f32"]
    store = (tmp_path / "sparc_sweep.jsonl").read_text().splitlines()
    assert len(store) == 4
    keys = {m: {r["key"] for r in v} for m, v in rows.items()}
    assert len(keys["2mm"]) == len(keys["2mm_f32"]) == 2
    assert not keys["2mm"] & keys["2mm_f32"]
    again = cli.main(SWEEP + ["--out", str(tmp_path), "--fwht-mode", "2mm_f32"])
    assert calls == ["2mm", "2mm", "2mm_f32", "2mm_f32"]   # nothing decoded again
    assert again == rows["2mm_f32"]
    assert [json.loads(ln) for ln in store[2:]] == rows["2mm_f32"]
    assert (tmp_path / "sparc_sweep.jsonl").read_text().splitlines() == store
