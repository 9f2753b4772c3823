"""The torch port's AMP decode (models/sparc.py) against the JAX package's,
end to end on the same y and the same design.

y is made once: y = A beta0 + noise with A the JAX design and the noise
from numpy, and both packages decode it with the design carried over by
`design_from_jax_leaves`. The decoders must agree in their hard decisions
and iteration counts exactly; psi within rtol 1e-4 / atol 1e-6 and the NMSE
trajectory within atol 1e-4, since the two FWHT chains and softmaxes round
float32 sums in different orders.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.config import DecodeParams as JDecode
from ldpc_sparc_tpu.models import sparc as jsparc
from ldpc_sparc_tpu.ops import denoiser_pallas
from ldpc_sparc_tpu.ops import transforms as jtr
from ldpc_sparc_tpu.utils import bits as jbits
from ldpc_sparc_tpu_torch import SparcParams as TParams
from ldpc_sparc_tpu_torch import DecodeParams as TDecode
from ldpc_sparc_tpu_torch.models import sparc as tsparc
from ldpc_sparc_tpu_torch.ops import denoiser_cuda
from ldpc_sparc_tpu_torch.parity import design_from_jax_leaves
from ldpc_sparc_tpu_torch.utils import bits as bitops
from ldpc_sparc_tpu_torch.utils.tracing import counters

from freeze_checks import where_freeze_decode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODES = {
    "eligible": dict(P=15.0, R=1.0, L=32, M=128),   # the fused tail takes M=128
    "offset1": dict(P=15.0, R=1.3, L=48, M=16),     # M=16: plain tail; w=1024
}
AWGN_VAR = 1.0
T_MAX = 8


def _problem(name, seed=3, batch=()):
    """(jax design, port design, beta0, y) as numpy, y = A beta0 + noise."""
    jp = JParams(**CODES[name])
    jd = jtr.SparcDesign.for_params(jp, AWGN_VAR, seed)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, batch + (jp.bit_len,)).astype(bool)
    beta0 = np.stack([np.asarray(jbits.bits_to_msg_vector(jnp.asarray(b), jp.M))
                      for b in bits.reshape(-1, jp.bit_len)]).reshape(
                          batch + (jp.L * jp.M,))
    noise = rng.normal(size=batch + (jd.n,)).astype(np.float32)
    x = np.asarray(jd.ab(jnp.asarray(beta0)))
    y = (x + noise * np.float32(np.sqrt(AWGN_VAR))).astype(np.float32)
    return jd, design_from_jax_leaves(*jd.tree_flatten()), beta0, y


def _jax_decode(name, jd, beta0, y, fused):
    from jax.experimental.pallas import tpu as pltpu
    args = (jnp.asarray(y), jd, JParams(**CODES[name]), JDecode(t_max=T_MAX),
            AWGN_VAR, jnp.asarray(beta0))
    if not fused:
        return jsparc.amp_decode(*args)
    old = denoiser_pallas._DENOISER_BACKEND
    denoiser_pallas.set_denoiser_backend("pallas")
    try:
        with pltpu.force_tpu_interpret_mode():
            return jsparc.amp_decode(*args)
    finally:
        denoiser_pallas.set_denoiser_backend(old)


@pytest.mark.parametrize("name,fused", [("eligible", True),
                                        ("eligible", False),
                                        ("offset1", False)])
def test_amp_decode_matches_jax(name, fused):
    jd, td, beta0, y = _problem(name)
    want = _jax_decode(name, jd, beta0, y, fused)
    got = tsparc.amp_decode(torch.as_tensor(y), td, TParams(**CODES[name]),
                            TDecode(t_max=T_MAX), AWGN_VAR,
                            beta0=torch.as_tensor(beta0),
                            fused_denoiser=None if fused else False)
    np.testing.assert_array_equal(got.beta.numpy(), np.asarray(want.beta))
    assert int(got.t_final) == int(want.t_final)
    np.testing.assert_allclose(got.psi.numpy(), np.asarray(want.psi),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.nmse.numpy(), np.asarray(want.nmse),
                               atol=1e-4)
    assert got.nmse.shape == (T_MAX, 1)


def test_offset1_shape_takes_the_plain_tail():
    _, td, _, y = _problem("offset1")
    assert td.offset == 1 and not denoiser_cuda.fused_eligible(16, 1, False)
    with pytest.raises(ValueError):
        tsparc.amp_decode(torch.as_tensor(y), td, TParams(**CODES["offset1"]),
                          TDecode(t_max=T_MAX), AWGN_VAR, fused_denoiser=True)


def test_fused_and_plain_tails_agree():
    _, td, _, y = _problem("eligible")
    args = (torch.as_tensor(y), td, TParams(**CODES["eligible"]),
            TDecode(t_max=T_MAX), AWGN_VAR)
    a = tsparc.amp_decode(*args, fused_denoiser=True)
    b = tsparc.amp_decode(*args, fused_denoiser=False)
    assert torch.equal(a.beta, b.beta) and int(a.t_final) == int(b.t_final)
    torch.testing.assert_close(a.psi, b.psi, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CODES))
def test_decode_batch_equals_single_decodes(name):
    _, td, _, y = _problem(name, seed=4, batch=(3,))
    params, decode = TParams(**CODES[name]), TDecode(t_max=T_MAX)
    beta, t_final = tsparc.decode_batch(torch.as_tensor(y), td, params, decode,
                                        AWGN_VAR)
    assert beta.shape == (3, params.L * params.M) and t_final.shape == (3,)
    for i in range(3):
        one = tsparc.amp_decode(torch.as_tensor(y[i]), td, params, decode,
                                AWGN_VAR)
        assert torch.equal(beta[i], one.beta)
        assert int(t_final[i]) == int(one.t_final)


# codes and channels at which a batch's rows stop at different iterations,
# some only at the cap (t_max - 1)
FREEZE_CODES = {
    "plain": (dict(P=15.0, R=1.0, L=64, M=64), 2.5),
    "plain_cap": (dict(P=15.0, R=1.2, L=64, M=64), 2.5),
    "sc": (dict(P=15.0, R=1.0, L=128, M=32, spatially_coupled=True, omega=3,
                Lambda=8), 1.0),
    "sc_cap": (dict(P=15.0, R=1.2, L=128, M=32, spatially_coupled=True, omega=3,
                    Lambda=8), 1.6),
}


@pytest.mark.parametrize("name", sorted(FREEZE_CODES))
def test_fused_freeze_matches_the_where_loop(name):
    """The fused path, whose freeze of beta and s is K3's (two pairs of
    buffers, swapped each step), against the loop that froze them by
    `torch.where`: every output equal bit for bit, with and without beta0."""
    kw, awgn_var = FREEZE_CODES[name]
    params, decode = TParams(**kw), TDecode(t_max=20)
    design = tsparc.design_for_params(params, awgn_var, 3, device="cpu")
    gen = torch.Generator().manual_seed(1)
    bits = bitops.random_bits(gen, 8 * params.bit_len).reshape(8, -1)
    beta0 = bitops.bits_to_msg_vector(bits, params.M)
    y = tsparc.awgn_channel(design.ab(beta0), awgn_var, gen)
    got = tsparc.amp_decode(y, design, params, decode, awgn_var, beta0)
    want = where_freeze_decode(y, design, params, decode, awgn_var, beta0)
    assert len(set(want[3].tolist())) > 2
    assert all(torch.equal(g, w) for g, w in zip(
        (got.beta, got.beta_mmse, got.s, got.t_final, got.nmse, got.psi), want))
    beta, t_final = tsparc.decode_batch(y, design, params, decode, awgn_var)
    assert torch.equal(beta, want[0]) and torch.equal(t_final, want[3])


def test_sparc_sim_decodes_at_the_verify_point():
    """P=15, R=1.3, L=256, M=32, awgn_var=1: far below capacity, BER 0 (for
    this seed; the port's random streams are not JAX's)."""
    r = tsparc.sparc_sim(TParams(P=15.0, R=1.3, L=256, M=32),
                         TDecode(t_max=25), awgn_var=1.0, seed=0, device="cpu")
    assert float(r["ber"]) == 0.0 and float(r["ser"]) == 0.0
    assert float(r["cer"]) == 0.0 and float(r["detect"]) == 1.0
    assert 1 < int(r["t_final"]) < 25
    assert r["nmse"].shape == (25, 1) and r["loc_of_sec_errs"].size == 0


def test_sparc_sim_above_capacity_fails_and_flags_it():
    r = tsparc.sparc_sim(TParams(P=15.0, R=2.5, L=64, M=32),
                         TDecode(t_max=10), awgn_var=1.0, seed=0, device="cpu")
    assert float(r["ber"]) > 0.05 and float(r["detect"]) == 1.0
    assert r["loc_of_sec_errs"].size == int(r["num_of_sec_errs"]) > 0


def test_encode_and_decode_round_trip():
    params = TParams(P=15.0, R=1.0, L=32, M=128)
    bits, beta0, x, design = tsparc.sparc_encode(params, AWGN_VAR, seed=1,
                                                     device="cpu")
    assert x.shape == (params.n,) and beta0.shape == (params.L * params.M,)
    assert abs(float((x ** 2).mean()) - params.P) < 0.25 * params.P
    y = tsparc.awgn_channel(x, AWGN_VAR, torch.Generator().manual_seed(2))
    bits_out, res, expect_err = tsparc.sparc_decode(y, design, params,
                                                    TDecode(t_max=10), AWGN_VAR)
    assert torch.equal(bits_out, bits) and not bool(expect_err)
    # the DFT engine is the complex codes' (tests/test_torch_dft.py)
    with pytest.raises(ValueError):
        tsparc.design_for_params(params, AWGN_VAR, 0, engine="dft", device="cpu")


def test_cpu_decode_never_launches_a_kernel():
    before = (counters()["k1.launches"], counters()["k3.launches"])
    _, td, _, y = _problem("eligible")
    tsparc.decode_batch(torch.as_tensor(y)[None], td, TParams(**CODES["eligible"]),
                        TDecode(t_max=T_MAX), AWGN_VAR)
    assert (counters()["k1.launches"], counters()["k3.launches"]) == before


def test_port_imports_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import ldpc_sparc_tpu_torch as P\n"
        "from ldpc_sparc_tpu_torch import parity, _build\n"
        "from ldpc_sparc_tpu_torch.ops import wht_cuda, denoiser_cuda\n"
        "r = P.sparc_sim(P.SparcParams(P=15.0, R=1.0, L=16, M=32),\n"
        "                P.DecodeParams(t_max=4), 1.0, seed=0, device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ldpc_sparc_tpu' or m.startswith('ldpc_sparc_tpu.')]\n"
        "assert not bad, bad\n"
        "assert _build._lib is None\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

