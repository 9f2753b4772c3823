"""The port's concatenated LDPC-SPARC codec (models/concat.py) against the
JAX package's, on the same user bits, designs and y.

The code is `tests/test_concat.py`'s small one (802.16 r=1/2 z=12, mults=2,
M=4, t_max=10). Inputs are made with numpy from a seed; a JAX-built design
is carried into the port by `parity.design_from_jax_leaves`. torch runs on
one thread with float32 matmuls at full precision (no TF32). The JAX side
is one jitted, vmapped call per decoder. Tolerances:

* `encode`: `total_bits` and `beta0` equal; x within 1e-5 of its largest
  entry (two float32 FWHT chains that add in other orders).
* one `_amp_step` + `_mmse` + bridge + 6-iteration BP round from the same
  (y, beta, z, tau_sqr), for each Onsager mode: z, s, tau_sqr, the
  bit probabilities before and after BP and the section estimate within
  rtol 1e-4 (atol 1e-5 of the largest entry).
* every decoder at linear SNR 8: the user-bit decisions of the two packages
  are identical (and, but for `sequential_rerun`, equal the bits sent).
* every decoder at linear SNR 3, where most decodes do not converge and 9
  feedback iterations amplify float32 rounding: six of the eight decoders
  still decide every bit alike; the posterior-combining ones differ in up
  to 18 of a trial's 288 bits. The bound is 10 % of a trial's bits, and
  where the decisions are identical the error counts are too.
* `decode_batch` over a `DesignStack` equals the per-trial `decode`, bit for
  bit, for every decoder, also with an unprotected prefix.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.config import DecodeParams as JDecode
from ldpc_sparc_tpu.config import LdpcParams as JLdpc
from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.config import param_calc as jparam_calc
from ldpc_sparc_tpu.config import param_calc_semi_protected as jparam_calc_semi
from ldpc_sparc_tpu.models import concat as jconcat
from ldpc_sparc_tpu.models.ldpc import get_code as jget_code
from ldpc_sparc_tpu.ops import bridges as jbr
from ldpc_sparc_tpu.utils import bits as jbits
from ldpc_sparc_tpu_torch import (ConcatCodec, ConcatLengths, DECODERS, DecodeParams,
                                  DesignStack, LdpcParams, SparcParams, concat_sim)
from ldpc_sparc_tpu_torch.models import concat as tconcat
from ldpc_sparc_tpu_torch.ops import bridges as tbr
from ldpc_sparc_tpu_torch.parity import design_from_jax_leaves

P, T_MAX, BI, BF = 19.44, 10, 6, 200
SNRS = (8.0, 8.0, 8.0, 3.0, 3.0, 3.0)   # linear SNR of the six trials
HIGH = slice(0, 3)
SEMI_DECODERS = ("sequential", "naive", "naive_posteriors", "no_onsager")


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


class _Problem:
    """Both packages' codecs, B trials' user bits and y (numpy), the JAX
    design stack and the port's designs carried over from it."""

    def __init__(self, semi: bool, seed: int, snrs):
        jl = JLdpc(standard="802.16", rate="1/2", z=12)
        K = jget_code("802.16", "1/2", 12).K
        if semi:
            _, R, L, lengths, _ = jparam_calc_semi(0.8, 2, 0.8, 4, jl, 0.5, K)
        else:
            _, _, L, lengths = jparam_calc(2, 2, jl, 0.5, 1.0, K)
            R = 1.0
        self.jcodec = jconcat.ConcatCodec(JParams(P=P, R=R, L=L, M=4), jl, lengths, True)
        self.tcodec = ConcatCodec(
            SparcParams(P=P, R=R, L=L, M=4), LdpcParams("802.16", "1/2", 12),
            ConcatLengths(lengths.k_ldpc, lengths.mults, lengths.L_unprotected), True)
        jc, B = self.jcodec, len(snrs)
        jds = [jc.build_design((seed, d)) for d in range(B)]
        self.jstack = jds[0].with_leaves(jnp.stack([d.idx for d in jds]),
                                         jnp.stack([d.signs for d in jds]))
        self.tdesigns = [design_from_jax_leaves(*d.tree_flatten()) for d in jds]
        rng = np.random.default_rng(seed)
        self.user_bits = rng.integers(0, 2, (B, jc.user_bits_len)).astype(np.int32)
        noise = rng.normal(size=(B, jc.n)).astype(np.float32)
        self.total_bits = np.stack([np.asarray(jc.encode_ldpc_bits(jnp.asarray(u)))
                                    for u in self.user_bits])
        self.beta0 = np.stack([np.asarray(jbits.bits_to_msg_vector(
            jnp.asarray(t.astype(bool)), 4, 1, amplitude=jc.c_amp))
            for t in self.total_bits])
        self.x = np.stack([np.asarray(d.ab(jnp.asarray(b) / jc.c_amp))
                           for d, b in zip(jds, self.beta0)])
        sigma = np.sqrt(P / np.asarray(snrs, np.float32))[:, None]
        self.y = (self.x + sigma * noise).astype(np.float32)
        self._jax_out, self._port_out = {}, {}

    def jax_decode(self, decoder):
        """The JAX package's decisions (B, bits): one jitted, vmapped call."""
        if decoder not in self._jax_out:
            jc, st = self.jcodec, self.jstack
            fn = jax.jit(jax.vmap(lambda y, i, g: jc.decode(
                y, st.with_leaves(i, g), JDecode(t_max=T_MAX), decoder, BI, BF)))
            self._jax_out[decoder] = np.asarray(fn(jnp.asarray(self.y), st.idx, st.signs))
        return self._jax_out[decoder]

    def port_decode(self, decoder):
        """The port's decisions, trial by trial through `decode`."""
        if decoder not in self._port_out:
            self._port_out[decoder] = np.stack([self.tcodec.decode(
                torch.as_tensor(y), d, DecodeParams(t_max=T_MAX), decoder, BI, BF).numpy()
                for y, d in zip(self.y, self.tdesigns)])
        return self._port_out[decoder]


@pytest.fixture(scope="module")
def full():
    return _Problem(semi=False, seed=9, snrs=SNRS)


@pytest.fixture(scope="module")
def semi():
    return _Problem(semi=True, seed=5, snrs=(12.0, 12.0, 6.0, 6.0))


def test_codec_lengths_match(full, semi):
    for pr in (full, semi):
        j, t = pr.jcodec, pr.tcodec
        for f in ("n", "c_amp", "logM", "user_bits_len", "encoded_bit_len",
                  "unprotected_bit_len"):
            assert getattr(t, f) == getattr(j, f), f
    assert semi.tcodec.lengths.L_unprotected > 0
    assert tconcat.DECODERS == jconcat.DECODERS == DECODERS


def test_build_design_is_identical(full):
    jd = full.jcodec.build_design((9, 1))
    td = full.tcodec.build_design((9, 1), device="cpu")
    np.testing.assert_array_equal(td.idx.numpy(), np.asarray(jd.idx))
    np.testing.assert_array_equal(td.signs.numpy(), np.asarray(jd.signs))
    np.testing.assert_array_equal(td.scale.numpy(), np.asarray(jd.scale))
    assert (td.w, td.n, td.LM, td.offset) == (jd.w, jd.n, jd.LM, jd.offset)


@pytest.mark.parametrize("which", ["full", "semi"])
def test_encode_matches_jax(which, request):
    pr = request.getfixturevalue(which)
    tc = pr.tcodec
    total, beta0 = tc.message_vector(torch.as_tensor(pr.user_bits))
    np.testing.assert_array_equal(total.numpy(), pr.total_bits)
    np.testing.assert_array_equal(beta0.numpy(), pr.beta0)
    x = torch.stack([d.ab(b / tc.c_amp) for d, b in zip(pr.tdesigns, beta0)])
    np.testing.assert_allclose(x.numpy(), pr.x, rtol=1e-5,
                               atol=1e-5 * np.abs(pr.x).max())
    # the batched product of the stack is the single designs' row by row
    xs = DesignStack.stack(pr.tdesigns).ab(beta0 / tc.c_amp)
    assert torch.equal(xs, x)


def test_encode_entry_point(full):
    tc = full.tcodec
    user, total, beta0, x, design = tc.encode(4, device="cpu")
    assert user.shape == (tc.user_bits_len,) and total.shape == (tc.encoded_bit_len,)
    blocks = total.reshape(tc.lengths.mults, tc.code.N).numpy()
    assert not ((blocks @ tc.code.pcmat().T) % 2).any()
    np.testing.assert_array_equal(blocks[:, :tc.code.K].reshape(-1), user.numpy())
    assert torch.equal(x, design.ab(beta0 / tc.c_amp)) and x.shape == (tc.n,)
    vals = beta0.reshape(tc.sparc.L, 4).max(-1).values
    np.testing.assert_allclose(vals.numpy(), tc.c_amp, rtol=1e-6)
    gen = torch.Generator().manual_seed(1)
    again = tc.encode(4, gen=gen, device="cpu")
    assert not torch.equal(again[0], user) and torch.equal(again[4].idx, design.idx)


@pytest.mark.parametrize("onsager", ["standard", "none", "deta"])
def test_one_round_matches_jax(full, onsager):
    """_amp_step, _mmse, the bridges and a 6-iteration soft BP on the same
    state, two rows at once in the port and one at a time in JAX."""
    jc, tc = full.jcodec, full.tcodec
    rng = np.random.default_rng(3)
    LM, c = jc.sparc.L * 4, jc.c_amp
    sec = rng.dirichlet(np.full(4, 0.3), size=(2, jc.sparc.L))
    beta = (c * sec.reshape(2, LM)).astype(np.float32)
    z = rng.normal(size=(2, jc.n)).astype(np.float32) * 2
    tau = np.array([3.1, 5.7], np.float32)
    deta = np.array([40.0, -15.0], np.float32)
    y = full.y[[0, 3]]

    def jround(d_idx, d_signs, y, beta, z, tau, deta):
        d = full.jstack.with_leaves(d_idx, d_signs)
        z, s, tau = jc._amp_step(d, y, beta, z, tau, onsager=onsager, deta_sum=deta)
        wa, probs = jc._mmse(s, tau, return_probs=True)
        vk0 = jbr.section_probs_to_bit_probs(wa / c, 4)
        vk = jc.ldpc_bp(vk0, BI, hard=False)
        return z, s, tau, wa, probs, vk0, vk, jbr.bit_probs_to_section_probs(vk, 4)

    st = full.jstack
    want = jax.jit(jax.vmap(jround))(st.idx[jnp.array([0, 3])], st.signs[jnp.array([0, 3])],
                                     *(jnp.asarray(v) for v in (y, beta, z, tau, deta)))
    designs = DesignStack.stack([full.tdesigns[0], full.tdesigns[3]])
    ty, tb, tz, tt, td = (torch.as_tensor(v) for v in (y, beta, z, tau, deta))
    z2, s2, tau2 = tc._amp_step(designs, ty, tb, tz, tt, onsager=onsager, deta_sum=td)
    wa, probs = tc._mmse(s2, tau2, return_probs=True)
    vk0 = tbr.section_probs_to_bit_probs(wa / c, 4)
    vk = tc.ldpc_bp(vk0, BI, False)
    got = (z2, s2, tau2, wa, probs, vk0, vk, tbr.bit_probs_to_section_probs(vk, 4))
    for name, g, w in zip(("z", "s", "tau_sqr", "beta", "probs", "vk0", "vk", "gamma"),
                          got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    assert torch.equal(probs * c, wa)


@pytest.mark.parametrize("decoder", DECODERS)
def test_decoder_matches_jax(full, decoder):
    want, got = full.jax_decode(decoder), full.port_decode(decoder)
    assert got.shape == want.shape and got.dtype == np.int32
    np.testing.assert_array_equal(got[HIGH], want[HIGH])
    sent = full.total_bits if decoder == "amp_only" else full.user_bits
    if decoder not in ("sequential_rerun", "amp_only"):
        np.testing.assert_array_equal(got[HIGH], sent[HIGH])
    # the trials at SNR 3: most do not converge
    differ = (got[3:] != want[3:]).mean(-1)
    assert (differ <= 0.1).all(), differ
    errs_got, errs_want = (got != sent).sum(-1), (want != sent).sum(-1)
    same = differ == 0
    np.testing.assert_array_equal(errs_got[3:][same], errs_want[3:][same])


@pytest.mark.parametrize("decoder", SEMI_DECODERS)
def test_semi_protected_decoder_matches_jax(semi, decoder):
    """BP runs on the protected suffix only; the prefix is MAP-decided. This
    code's SPARC rate is 1.44: at SNR 12 the protected suffix decodes (but
    for `no_onsager` on the first trial, in both packages), at SNR 6 it does
    not."""
    want, got = semi.jax_decode(decoder), semi.port_decode(decoder)
    u = semi.tcodec.unprotected_bit_len
    assert u > 0 and got.shape == (4, semi.tcodec.user_bits_len)
    np.testing.assert_array_equal(got[:2], want[:2])
    ok = slice(1, 2) if decoder == "no_onsager" else slice(0, 2)
    np.testing.assert_array_equal(got[ok, u:], semi.user_bits[ok, u:])
    assert ((got[2:] != want[2:]).mean(-1) <= 0.1).all()
    np.testing.assert_array_equal(got[2:, :u], want[2:, :u])


def test_semi_protected_message_needs_a_taking_decoder(semi):
    with pytest.raises(AssertionError, match="fully protected"):
        semi.tcodec.decode(torch.as_tensor(semi.y[0]), semi.tdesigns[0],
                           DecodeParams(t_max=3), "integrated")


@pytest.mark.parametrize("decoder", DECODERS)
def test_decode_batch_equals_per_trial_decode(full, decoder):
    """All six trials at once, through a stack with one design per row and
    every BP call packed across them, against each trial alone."""
    tc, dp = full.tcodec, DecodeParams(t_max=T_MAX)
    got = tc.decode_batch(torch.as_tensor(full.y), DesignStack.stack(full.tdesigns),
                          dp, decoder, BI, BF)
    np.testing.assert_array_equal(got.numpy(), full.port_decode(decoder))
    # three trials that share one design, as `decode` takes them
    y3 = torch.as_tensor(full.y[[0, 3, 4]])
    one = tc.decode(y3, full.tdesigns[0], dp, decoder, BI, BF)
    for row, y in zip(one, y3):
        assert torch.equal(row, tc.decode(y, full.tdesigns[0], dp, decoder, BI, BF))


@pytest.mark.parametrize("decoder", SEMI_DECODERS)
def test_decode_batch_equals_per_trial_decode_semi_protected(semi, decoder):
    got = semi.tcodec.decode_batch(torch.as_tensor(semi.y), DesignStack.stack(semi.tdesigns),
                                   DecodeParams(t_max=T_MAX), decoder, BI, BF)
    np.testing.assert_array_equal(got.numpy(), semi.port_decode(decoder))


def test_design_stack_rows_and_gather(full):
    """A stack's products equal the single designs' row by row, one design
    per row, also after `for_trials` gathered the designs to the rows."""
    ds = full.tdesigns[:3]
    stack = DesignStack.stack(ds)
    rng = np.random.default_rng(1)
    beta = torch.as_tensor(rng.normal(size=(6, stack.LM)).astype(np.float32))
    z = torch.as_tensor(rng.normal(size=(6, stack.n)).astype(np.float32))
    ab = torch.stack([ds[t % 3].ab(beta[t]) for t in range(6)])
    az = torch.stack([ds[t % 3].az(z[t]) for t in range(6)])
    assert torch.equal(stack.ab(beta[:3]), ab[:3]) and torch.equal(stack.az(z[:3]), az[:3])
    per_row = stack.for_trials(torch.arange(6) % 3)
    assert per_row.D == 6
    assert torch.equal(per_row.ab(beta), ab) and torch.equal(per_row.az(z), az)
    order = torch.tensor([2, 0, 0, 1, 2])         # any assignment, 5 rows of 3 designs
    mixed = stack.for_trials(order)
    assert torch.equal(mixed.ab(beta[:5]),
                       torch.stack([ds[int(d)].ab(beta[t]) for t, d in enumerate(order)]))
    with pytest.raises(ValueError, match="one per design"):
        stack.ab(beta)                            # 6 rows, 3 designs
    with pytest.raises(ValueError, match="one-block designs of one shape"):
        DesignStack.stack([ds[0], _other_shape_design()])


def _other_shape_design():
    from ldpc_sparc_tpu_torch import SparcDesign
    return SparcDesign.build(np.ones((1, 1)), 16, 4, 40, 0, device="cpu")


@pytest.mark.parametrize("decoder", ["naive", "no_onsager", "integrated"])
def test_decode_instrumented_matches_jax(full, decoder):
    jc, tc, t = full.jcodec, full.tcodec, 1
    jd = full.jstack.with_leaves(full.jstack.idx[t], full.jstack.signs[t])
    want = jax.jit(lambda y: jc.decode_instrumented(
        y, jd, JDecode(t_max=6), decoder, 4, trace_inner_bp=True))(jnp.asarray(full.y[t]))
    got = tc.decode_instrumented(torch.as_tensor(full.y[t]), full.tdesigns[t],
                                 DecodeParams(t_max=6), decoder, 4, trace_inner_bp=True)
    ubits = tc.user_bits_len
    assert set(got) == {"pre_bp", "post_bp", "inner_bp"}
    assert got["pre_bp"].shape == got["post_bp"].shape == (6, ubits)
    assert got["inner_bp"].shape == (6, 4, ubits)
    assert torch.equal(got["inner_bp"][:, -1], got["post_bp"])
    np.testing.assert_array_equal(got["post_bp"][-1].numpy(), np.asarray(want["post_bp"][-1]))
    np.testing.assert_array_equal(got["post_bp"][-1].numpy(), full.user_bits[t])
    plain = tc.decode_instrumented(torch.as_tensor(full.y[t]), full.tdesigns[t],
                                   DecodeParams(t_max=6), decoder, 4)
    assert set(plain) == {"pre_bp", "post_bp"}
    assert torch.equal(plain["post_bp"], got["post_bp"])
    assert torch.equal(plain["pre_bp"], got["pre_bp"])


def test_ldpc_bp_outputs(full):
    """hard=False is sigmoid(app) = P(bit = 0) shaped like the input,
    hard=True the first K decisions of each block; certain inputs are a
    fixed point; the traced form ends where the untraced one does."""
    tc = full.tcodec
    bits = torch.as_tensor(full.total_bits[:2])
    sure = 1.0 - bits.float()                        # P(bit = 0)
    soft = tc.ldpc_bp(sure, 6, False)
    assert soft.shape == sure.shape and bool(((soft < 0.5).int() == bits).all())
    hard = tc.ldpc_bp(sure, 6, True)
    np.testing.assert_array_equal(hard.numpy(), full.user_bits[:2])
    noisy = torch.as_tensor(np.random.default_rng(0).uniform(
        0.2, 0.8, size=sure.shape).astype(np.float32)) * 0.4 + sure * 0.6
    traj = tc.ldpc_bp_traced(noisy, 5)
    assert traj.shape == (5,) + noisy.shape
    torch.testing.assert_close(traj[-1], tc.ldpc_bp(noisy, 5, False), rtol=0, atol=0)
    assert torch.equal(tc.ldpc_bp(noisy[0], 5, False), tc.ldpc_bp(noisy, 5, False)[0])
    assert tc.ldpc_bp_batch.__func__ is tc.ldpc_bp.__func__


@pytest.mark.parametrize("decoder", [d for d in DECODERS if d != "amp_only"])
def test_concat_sim_decodes_at_high_snr(full, decoder):
    tc = full.tcodec
    r = concat_sim(tc.sparc, tc.ldpc_params, tc.lengths, True, DecodeParams(t_max=T_MAX),
                   P / 8.0, seed=2, decoder=decoder, device="cpu")
    assert r["bits_in"].shape == r["bits_out"].shape == (tc.user_bits_len,)
    if decoder == "sequential_rerun":      # the reference's known-weak decoder
        assert float(r["ber"]) <= 0.5
    else:
        assert float(r["ber"]) == 0.0


def test_concat_sim_takes_the_card_unless_asked_for_the_cpu(full):
    tc = full.tcodec
    if not torch.cuda.is_available():
        for call in (lambda: concat_sim(tc.sparc, tc.ldpc_params, tc.lengths, True,
                                        DecodeParams(t_max=3), 1.0, seed=0),
                     lambda: tc.encode(0), lambda: tc.build_design(0)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def test_concat_modules_import_no_jax():
    code = (
        "import sys\n"
        "import ldpc_sparc_tpu_torch as P\n"
        "from ldpc_sparc_tpu_torch.ops import bridges\n"
        "ldpc = P.LdpcParams('802.16', '1/2', 3)\n"
        "_, _, L, lengths = P.param_calc(1, 2, ldpc, 0.5, 1.0, P.get_code('802.16', '1/2', 3).K)\n"
        "r = P.concat_sim(P.SparcParams(P=19.44, R=1.0, L=L, M=4), ldpc, lengths, True,\n"
        "                 P.DecodeParams(t_max=4), 2.0, seed=0, decoder='integrated',\n"
        "                 device='cpu')\n"
        "assert r['bits_out'].shape == r['bits_in'].shape\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ldpc_sparc_tpu' or m.startswith('ldpc_sparc_tpu.')]\n"
        "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
