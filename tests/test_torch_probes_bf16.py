"""Why the two decoders of `docs/artifacts/concat_probes_tpu.json` part and
the port's do not.

In the artifact, made on a TPU, the naive and integrated decoders'
per-iteration probes part from AMP iteration 2 (after BP; 3 before it).
In the port, and in the JAX
package on a CPU in float32, they never part: the two Onsager terms differ
by float32 rounding that no decision feels. The JAX package has a knob
that rounds the operands of its FWHT chain to bf16, as the TPU's matrix
unit does under XLA's default precision (`ops/wht.py`,
`set_fwht_options(matmul_dtype="bfloat16")`). Under it the JAX package's
own `decode_instrumented` parts the two decoders from iteration 3 on the
artifact's trial 2, as the artifact does; in float32 it does not. So the artifact's parting is the
TPU's bf16 rounding, not a fault of the port, and these tests keep that
finding from regressing.

The knob is a trace-time constant: every jitted function already traced in
the process keeps float32. So the caches are cleared before the run and the
knob restored, and the caches cleared again, after it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldpc_sparc_tpu.config import DecodeParams as JDecode
from ldpc_sparc_tpu.config import LdpcParams as JLdpc
from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.config import param_calc
from ldpc_sparc_tpu.models.concat import ConcatCodec as JCodec
from ldpc_sparc_tpu.models.ldpc import get_code
from ldpc_sparc_tpu.models.sparc import awgn_channel
from ldpc_sparc_tpu.ops import wht
from ldpc_sparc_tpu.utils import rng as jrng
from ldpc_sparc_tpu_torch import artifacts

# the artifact's configuration: 802.16 r=1/2 z=150, mults 4, M=2, L=14,400,
# P=19.44, R=1.0, t_max 25, linear SNR 3.8; its trial 2 (seeds 0, 1, 2)
SEED, SNR, T_MAX = 2, 3.8, 25
# where the trial's decoders part under bf16 operands (JAX package on a CPU):
# from iteration 3 (1-based), on 209 of the 360,000 decisions (2 probes x 25
# iterations x 7,200 user bits: 178 before BP, 31 after); the band and the
# floor leave room for another CPU's rounding of the same arithmetic
BF16_FIRST_APART, BF16_MIN_APART = (2, 6), 100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probes(matmul_dtype):
    """decode_instrumented's probes of trial SEED for both decoders, with the
    FWHT chain's operands in `matmul_dtype`: ({decoder: {probe: (25, 7200)}},
    user bits)."""
    ldpc = JLdpc(standard="802.16", rate="1/2", z=150)
    _, _, L, lengths = param_calc(mults=4, logM=1, ldpc=ldpc, int_rate=ldpc.rate_float,
                                  R_sparc_ldpc=1.0, ldpc_K=get_code("802.16", "1/2", 150).K)
    codec = JCodec(JParams(P=19.44, R=1.0, L=L, M=2), ldpc, lengths, ldpc_protected=True)
    before = wht.get_fwht_options()[1]
    wht.set_fwht_options(matmul_dtype=matmul_dtype)
    jax.clear_caches()
    try:
        key = jrng.root_key(SEED)
        design = codec.build_design(SEED)
        ub, _, beta0 = codec.encode_message(key)
        y = awgn_channel(design.ab(beta0 / codec.c_amp), jnp.float32(codec.sparc.P / SNR),
                         jrng.derive(key, jrng.CHANNEL))
        out = {}
        for decoder in ("naive", "integrated"):
            got = jax.jit(lambda y, d=decoder: codec.decode_instrumented(
                y, design, JDecode(t_max=T_MAX), d))(y)
            out[decoder] = {k: np.asarray(v) for k, v in got.items()}
    finally:
        wht.set_fwht_options(matmul_dtype=before)
        jax.clear_caches()
    return out, np.asarray(ub)


def _apart(out):
    """Decisions on which the two decoders differ, per iteration, summed over
    the two probes."""
    return sum((out["naive"][p] != out["integrated"][p]).sum(-1) for p in ("pre_bp", "post_bp"))


def test_the_artifact_is_this_configuration():
    cfg = artifacts.load("concat_probes_tpu.json")["config"]
    assert (cfg["standard"], cfg["rate"], cfg["z"], cfg["mults"], cfg["logM"]) == (
        "802.16", "1/2", 150, 4, 1)
    assert (cfg["snr"], cfg["t_max"], cfg["seeds"]) == (SNR, T_MAX, 3) and SEED < cfg["seeds"]
    probes = artifacts.load("concat_probes_tpu.json")["probes"]
    # the artifact's two decoders: equal at iteration 1, apart from 2 after
    # BP and from 3 before it
    first = {p: next(i for i, (a, b) in enumerate(zip(probes["naive"][p],
                                                       probes["integrated"][p])) if a != b)
             for p in ("pre_bp", "post_bp")}
    assert first == {"pre_bp": 2, "post_bp": 1}


def test_in_float32_the_decoders_never_part():
    out, ub = _probes("float32")
    assert ub.size == 7200 and out["naive"]["pre_bp"].shape == (T_MAX, ub.size)
    assert int(_apart(out).sum()) == 0
    assert wht.get_fwht_options()[1] == "float32"


def test_with_bf16_operands_the_decoders_part_from_iteration_3():
    out, ub = _probes("bfloat16")
    assert wht.get_fwht_options()[1] == "float32"   # the knob is restored
    apart = _apart(out)
    first = int(np.flatnonzero(apart)[0]) + 1
    assert BF16_FIRST_APART[0] <= first <= BF16_FIRST_APART[1], apart.tolist()
    assert int(apart.sum()) >= BF16_MIN_APART, apart.tolist()
    # both decoders still decode: BP leaves a few of the 7,200 bits wrong
    for d in out:
        errs = (out[d]["post_bp"][-1] != ub).sum()
        assert 0 < errs < 0.05 * ub.size
