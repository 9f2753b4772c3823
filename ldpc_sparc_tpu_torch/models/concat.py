"""Concatenated LDPC-SPARC codec: encoder and the decoder family, in PyTorch.

Counterpart of `ldpc_sparc_tpu/models/concat.py` (the reference's L3 stack,
sparc_sophie/sparc_new.py). Four decoder families, each one implementation
with options:

  sequential            AMP to the end, then BP
  sequential_rerun      sequential, re-encode, a second AMP
  naive                 one AMP step and a few BP iterations per step
                        (no_onsager: without the Onsager term;
                        naive_posteriors: posteriors combined, not replaced)
  integrated            BP inside the AMP denoiser, the Onsager term from the
                        derivative of the BP-composed denoiser
                        (integrated_posteriors: combined posteriors)

and `amp_only`, the plain SPARC decode in the same amplitude convention.

The JAX package writes each decoder for one trial and vmaps it, with a
second, packed form for the Monte Carlo. Here every decoder is written once
over a leading trial axis: the iterations are a Python loop, `tau_sqr` and
`deta_sum` are (B,) and every BP call packs all trials' LDPC blocks into
one (B * mults, N) decode. `decode` takes one design for all rows,
`decode_batch` a `DesignStack` with one design per row; a row's result does
not depend on what else is in the batch.

Amplitude convention: beta carries c = sqrt(n P / L) and the Hadamard design
D of `ops/transforms.py` acts on unit-amplitude vectors, so A v = D(v) / c
and A^T z = D^T(z) / c.

Kernels on the path: every design product takes K1 (`ops/wht_cuda.py`) and
every BP call K4 (`ops/bp_cuda.py`) when the tensors lie on a card;
`fwht_kernel=False` / `bp_kernel=False` take their plain versions. The
denoiser is the plain `mmse_denoise` (BP is composed after it). The bridges'
mask products need float32 matmuls: keep
`torch.backends.cuda.matmul.allow_tf32` False (see `ops/bridges.py`).

Soft outputs: `decode_soft` returns, beside the decisions, each AMP step's
tau^2 and the iterations of every BP call, summed over a trial's LDPC
blocks (`ConcatDecode`). They stay on the device, one tensor a step or a
BP call, and are stacked once at the end of the decode: nothing is read
back inside the loop. Spans and counters (`utils/tracing.py`):
`concat.amp` around each AMP step; in the integrated decoder `concat.eta`
around the BP-composed denoiser and its derivative, `concat.bp_final`
around the last step's hard BP, and the counters `concat.iters` (t_max a
decode) and `concat.decodes`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ConcatLengths, DecodeParams, LdpcParams, SparcParams
from ..device import resolve_device
from ..ops.bp import bp_decode, bp_decode_trace
from ..ops.bridges import (bit_probs_to_section_probs, combine_posteriors,
                           integrated_onsager_derivative,
                           section_probs_to_bit_probs)
from ..ops.denoiser import map_estimate, mmse_denoise
from ..ops.transforms import DesignStack, SparcDesign
from ..utils import bits as bitops
from ..utils import rng as rngmod
from ..utils import tracing
from ..utils.metrics import bit_error_rate
from .ldpc import LdpcCode, get_code
from .sparc import awgn_channel

DECODERS = ("amp_only", "sequential", "sequential_rerun", "naive",
            "naive_posteriors", "no_onsager", "integrated",
            "integrated_posteriors")
# the decoders that take a message with an unprotected section prefix
SEMI_PROTECTED_DECODERS = ("amp_only", "sequential", "naive", "naive_posteriors",
                           "no_onsager")
_BP_EPS = 1e-7   # float32-safe clip of P(bit = 0): 1 - 1e-15 rounds to 1


def amp_steps(decoder: str, t_max: int) -> int:
    """The AMP steps a decode of `decoder` runs, each giving one tau^2:
    t_max, or 2 t_max for sequential_rerun, which runs AMP twice."""
    return 2 * t_max if decoder == "sequential_rerun" else t_max


class ConcatDecode(NamedTuple):
    """What `ConcatCodec.decode_soft` returns for B trials."""
    bits: torch.Tensor       # (B, user_bits_len) int32 user-bit decisions
    tau_sqr: torch.Tensor    # (B, amp_steps) float32 tau^2 of each AMP step
    bp_iters: torch.Tensor   # (B,) int64 iterations of every BP call, summed
    #                          over the trial's LDPC blocks


class _Soft:
    """A decode's soft outputs as they are made: each AMP step's (B,) tau^2
    and each BP call's (B, blocks) iterations, on the device until
    `result` stacks them."""

    def __init__(self):
        self.taus: list = []
        self.iters: list = []

    def result(self, bits: torch.Tensor) -> ConcatDecode:
        B = bits.shape[0]
        iters = (torch.cat(self.iters, -1).sum(-1, dtype=torch.int64) if self.iters
                 else torch.zeros(B, dtype=torch.int64, device=bits.device))
        return ConcatDecode(bits, torch.stack(self.taus, -1), iters)


class ConcatCodec:
    """Concatenated LDPC-SPARC code over a shared Hadamard design."""

    def __init__(self, sparc_params: SparcParams, ldpc_params: LdpcParams,
                 lengths: ConcatLengths, ldpc_protected: bool = True):
        self.sparc = sparc_params
        self.ldpc_params = ldpc_params
        self.lengths = lengths
        self.ldpc_protected = ldpc_protected
        self.code: LdpcCode = get_code(ldpc_params.standard, ldpc_params.rate,
                                       ldpc_params.z, ldpc_params.ptype)
        p = sparc_params
        self.logM = p.logM
        if ldpc_protected:
            self.unprotected_bit_len = lengths.L_unprotected * self.logM
            self.user_bits_len = lengths.k_ldpc + self.unprotected_bit_len
        else:
            self.unprotected_bit_len = 0
            self.user_bits_len = p.L * self.logM
        self.encoded_bit_len = p.L * self.logM
        # n = encoded_bits / R (sparc_new.py:44; no row rounding at L3)
        self.n = int(self.encoded_bit_len / p.R)
        self.c_amp = float(np.sqrt(self.n * p.P / p.L))

    # ------------------------------------------------------------------
    # encode (sparc_ldpc_encode, sparc_new.py:15-51)
    # ------------------------------------------------------------------
    def build_design(self, seed, device=None) -> SparcDesign:
        W = np.array([[self.sparc.P]])
        return SparcDesign.build(W, self.sparc.L, self.sparc.M, self.n, seed,
                                 device)

    def build_designs(self, seed, count: int, device=None) -> DesignStack:
        """The Monte Carlo's designs (seed, 0) .. (seed, count - 1), stacked."""
        return DesignStack.stack([self.build_design((seed, d), device)
                                  for d in range(count)])

    def encode_ldpc_bits(self, user_bits: torch.Tensor) -> torch.Tensor:
        """(..., user bits) -> (..., unprotected prefix || LDPC codewords),
        int32 (encode_ldpc, sparc_new.py:1343-1359)."""
        u = self.unprotected_bit_len
        lead = user_bits.shape[:-1]
        info = user_bits[..., u:].reshape(lead + (self.lengths.mults, self.code.K))
        coded = self.code.encode(info).reshape(lead + (-1,))
        return torch.cat([user_bits[..., :u].to(coded.dtype), coded], -1)

    def message_vector(self, user_bits: torch.Tensor):
        """(..., user bits) -> (total_bits, beta0): the LDPC-encoded bits and
        the message vector that carries them with amplitude c."""
        total_bits = (self.encode_ldpc_bits(user_bits) if self.ldpc_protected
                      else user_bits)
        assert total_bits.shape[-1] == self.encoded_bit_len
        beta0 = bitops.bits_to_msg_vector(total_bits.to(torch.bool), self.sparc.M,
                                          1, amplitude=self.c_amp)
        return total_bits, beta0

    def encode_message(self, gen: torch.Generator):
        """Random user bits from `gen` -> (user_bits, total_bits, beta0), on
        the generator's device."""
        user_bits = bitops.random_bits(gen, self.user_bits_len).to(torch.int32)
        return (user_bits,) + self.message_vector(user_bits)

    def encode(self, seed, gen: Optional[torch.Generator] = None, device=None):
        """Returns (user_bits, total_bits, beta0, x, design)."""
        device = resolve_device(device)
        if gen is None:
            gen = rngmod.root_generator(rngmod.derive(seed, rngmod.BITS), device)
        user_bits, total_bits, beta0 = self.encode_message(gen)
        design = self.build_design(seed, device)
        x = design.ab(beta0 / self.c_amp)  # A beta0 = D(beta0) / c
        return user_bits, total_bits, beta0, x, design

    # ------------------------------------------------------------------
    # shared decoder building blocks; y, z (..., n), beta, s (..., L*M),
    # tau_sqr and deta_sum (...,)
    # ------------------------------------------------------------------
    def _amp_step(self, design, y, beta, z, tau_sqr, onsager="standard",
                  deta_sum=None, fwht_kernel: bool = True):
        """One L3-convention AMP iteration (sparc_amp_single_it,
        sparc_new.py:975-990; the integrated z-update, :492-494).

        onsager: 'standard'  (z / tau^2)(P - |beta|^2 / n)
                 'none'      0
                 'deta'      (z / n) * deta_sum
        Returns (z, s, tau_sqr).
        """
        n, P = self.n, self.sparc.P
        with tracing.span("concat.amp"):
            Ab = design.ab(beta / self.c_amp, fwht_kernel)
            if onsager == "standard":
                corr = (z / tau_sqr[..., None]) * (P - (beta ** 2).sum(-1, keepdim=True) / n)
            elif onsager == "none":
                corr = 0.0
            else:  # 'deta'
                corr = (z / n) * deta_sum[..., None]
            z = y - Ab + corr
            s = design.az(z, fwht_kernel) / self.c_amp + beta
            tau_sqr = (z ** 2).sum(-1) / n
        return z, s, tau_sqr

    def _mmse(self, s, tau_sqr, return_probs: bool = False):
        """The amplitude-carrying MMSE estimate c * softmax(c s / tau^2) per
        section (msg_vector_mmse_estimator, sparc_new.py:1040-1066); with
        return_probs also the unit-amplitude posterior, shaped like s."""
        probs = mmse_denoise(s, (self.c_amp / tau_sqr)[..., None], self.sparc.M, 1)
        if return_probs:
            return self.c_amp * probs, probs
        return self.c_amp * probs

    def _map(self, s):
        return self.c_amp * map_estimate(s, self.sparc.M, 1)

    def _bit_llrs(self, bit_probs: torch.Tensor) -> torch.Tensor:
        """P(bit = 0) (..., nbits) -> LLRs (..., nblocks, N)."""
        p = torch.clamp(bit_probs, _BP_EPS, 1 - _BP_EPS)
        llr = torch.log(p) - torch.log1p(-p)
        return llr.reshape(bit_probs.shape[:-1] + (-1, self.code.N)).to(torch.float32)

    def ldpc_bp(self, bit_probs: torch.Tensor, num_its: int, hard: bool,
                bp_kernel: bool = True) -> torch.Tensor:
        """Blockwise BP over P(bit = 0) probabilities (..., mults * N), every
        leading index's blocks packed into one decode (ldpc_bp,
        sparc_new.py:1162-1193). Returns the posterior P(bit = 0), shaped
        like the input (hard=False), or the hard user-bit decisions, the
        first K of each block, (..., mults * K) int32 (hard=True). A block
        whose parity checks hold is frozen, so it may stop before num_its."""
        return self._bp(bit_probs, num_its, hard, bp_kernel, None)

    ldpc_bp_batch = ldpc_bp   # the JAX package's name for the packed form

    def _bp(self, bit_probs, num_its, hard, bp_kernel, soft: Optional[_Soft]):
        """`ldpc_bp`, keeping the blocks' iterations (..., blocks) in `soft`."""
        lead = bit_probs.shape[:-1]
        res = bp_decode(self._bit_llrs(bit_probs), self.code.graph,
                        max_iters=num_its, method="sumprod", bp_kernel=bp_kernel)
        if soft is not None:
            soft.iters.append(res.iterations)
        if hard:
            return (res.app[..., :self.code.K] < 0).to(torch.int32).reshape(lead + (-1,))
        return torch.sigmoid(res.app).reshape(lead + (-1,))

    def _split_protected(self, v, per_section):
        u = self.lengths.L_unprotected * per_section if self.ldpc_protected else 0
        return v[..., :u], v[..., u:]

    def _run_amp(self, y, design, t_max: int, fwht_kernel: bool, soft: _Soft):
        """Full L3 AMP (sparc_amp, sparc_new.py:885-912): t_max iterations,
        scalar tau per row, z = y in the first, each tau^2 kept in `soft`.
        Returns (beta_mmse, s)."""
        lead = y.shape[:-1]
        LM = self.sparc.L * self.sparc.M
        beta = y.new_zeros(lead + (LM,))
        z, tau_sqr, s = y, None, beta
        for t in range(t_max):
            if t:
                corr = (z / tau_sqr[..., None]) * (
                    self.sparc.P - (beta ** 2).sum(-1, keepdim=True) / self.n)
                z = y - design.ab(beta / self.c_amp, fwht_kernel) + corr
            s = design.az(z, fwht_kernel) / self.c_amp + beta
            tau_sqr = (z ** 2).sum(-1) / self.n
            soft.taus.append(tau_sqr)
            beta = self._mmse(s, tau_sqr)
        return beta, s

    def _unprotected_bits(self, s):
        """MAP bits of the unprotected section prefix of s, int32."""
        un_s, _ = self._split_protected(s, self.sparc.M)
        if not un_s.shape[-1]:
            return s.new_zeros(s.shape[:-1] + (0,), dtype=torch.int32)
        return bitops.msg_vector_to_bits(self._map(un_s), self.sparc.M).to(torch.int32)

    # ------------------------------------------------------------------
    # decoder family
    # ------------------------------------------------------------------
    def decode(self, y: torch.Tensor, design, decode_params: DecodeParams,
               decoder: str = "sequential", bp_inner_iters: int = 6,
               bp_final_iters: int = 200, fwht_kernel: bool = True,
               bp_kernel: bool = True) -> torch.Tensor:
        """Decode y (..., n) through `design` (one `SparcDesign` for every
        row) into user-bit decisions (..., user_bits_len) int32."""
        lead = y.shape[:-1]
        out = self.decode_soft(y.reshape(-1, y.shape[-1]), design, decode_params,
                               decoder, bp_inner_iters, bp_final_iters, fwht_kernel,
                               bp_kernel)
        return out.bits.reshape(lead + (-1,))

    def decode_soft(self, y: torch.Tensor, design, decode_params: DecodeParams,
                    decoder: str = "sequential", bp_inner_iters: int = 6,
                    bp_final_iters: int = 200, fwht_kernel: bool = True,
                    bp_kernel: bool = True) -> ConcatDecode:
        """Decode B trials y (B, n) through `design` (a `SparcDesign` for
        every row, or a `DesignStack` with one design a row): the decisions
        of `decode` and the soft outputs beside them (`ConcatDecode`)."""
        assert decoder in DECODERS and y.dim() == 2
        if self.ldpc_protected and self.lengths.L_unprotected:
            # the integrated and rerun families need a fully protected
            # message (they do in the reference too, sparc_new.py:66-71)
            assert decoder in SEMI_PROTECTED_DECODERS, (
                f"decoder {decoder!r} requires a fully protected message "
                f"(L_unprotected={self.lengths.L_unprotected})")
        y = y.to(torch.float32)
        dp, bi, bf = decode_params, bp_inner_iters, bp_final_iters
        soft = _Soft()
        kern = dict(fwht_kernel=fwht_kernel, bp_kernel=bp_kernel, soft=soft)
        if decoder == "amp_only":
            out = self._decode_amp_only(y, design, dp, **kern)
        elif decoder == "sequential":
            out = self._decode_sequential(y, design, dp, bf, **kern)
        elif decoder == "sequential_rerun":
            out = self._decode_sequential_rerun(y, design, dp, bf, **kern)
        elif decoder in ("naive", "naive_posteriors", "no_onsager"):
            out = self._decode_interleaved(
                y, design, dp, bi, bf,
                onsager="none" if decoder == "no_onsager" else "standard",
                posteriors=decoder == "naive_posteriors", **kern)
        else:
            out = self._decode_integrated(
                y, design, dp, bi, bf,
                posteriors=decoder == "integrated_posteriors", **kern)
        return soft.result(out)

    def decode_batch(self, ys: torch.Tensor, designs, decode_params: DecodeParams,
                     decoder: str = "sequential", bp_inner_iters: int = 6,
                     bp_final_iters: int = 200, fwht_kernel: bool = True,
                     bp_kernel: bool = True) -> torch.Tensor:
        """Decode B trials ys (B, n), row t through entry t of the
        `DesignStack` `designs` (B entries), with every BP call packed
        across the trials: (B, user_bits_len). Row t equals
        `decode(ys[t], <design t>, ...)`."""
        assert ys.dim() == 2
        return self.decode(ys, designs, decode_params, decoder, bp_inner_iters,
                           bp_final_iters, fwht_kernel, bp_kernel)

    def _decode_amp_only(self, y, design, dp, fwht_kernel, bp_kernel, soft):
        """Plain SPARC decode in the L3 convention (the ldpc_bool=False path
        of sparc_ldpc_decode, sparc_new.py:78-81)."""
        _, s = self._run_amp(y, design, dp.t_max, fwht_kernel, soft)
        return bitops.msg_vector_to_bits(self._map(s), self.sparc.M).to(torch.int32)

    def _decode_sequential(self, y, design, dp, bf, fwht_kernel, bp_kernel, soft):
        """AMP to completion, then BP (sparc_ldpc_decode, sparc_new.py:53-82)."""
        M = self.sparc.M
        beta, s = self._run_amp(y, design, dp.t_max, fwht_kernel, soft)
        _, prot_beta = self._split_protected(beta, M)
        bit_probs = section_probs_to_bit_probs(prot_beta / self.c_amp, M)
        prot_bits = self._bp(bit_probs, bf, True, bp_kernel, soft)
        return torch.cat([self._unprotected_bits(s), prot_bits], -1)

    def _decode_sequential_rerun(self, y, design, dp, bf, fwht_kernel, bp_kernel,
                                 soft):
        """AMP -> soft BP -> re-encode -> AMP -> MAP (sparc_ldpc_decode_loop,
        sparc_new.py:84-113, with its chunk[c.K] indexing fixed to
        chunk[:K])."""
        M = self.sparc.M
        beta, _ = self._run_amp(y, design, dp.t_max, fwht_kernel, soft)
        bit_probs = section_probs_to_bit_probs(beta / self.c_amp, M)
        post = self._bp(bit_probs, bf, False, bp_kernel, soft)
        beta_bp = self.c_amp * bit_probs_to_section_probs(post, M)
        new_y = design.ab(beta_bp / self.c_amp, fwht_kernel)
        _, s2 = self._run_amp(new_y, design, dp.t_max, fwht_kernel, soft)
        ldpc_bits = bitops.msg_vector_to_bits(self._map(s2), M).to(torch.int32)
        blocks = ldpc_bits.reshape(y.shape[:-1] + (-1, self.code.N))
        return blocks[..., :self.code.K].reshape(y.shape[:-1] + (-1,))

    def _decode_interleaved(self, y, design, dp, bi, bf, *, onsager, posteriors,
                            fwht_kernel, bp_kernel, soft):
        """One AMP step and `bi` BP iterations per step, then a `bf`-iteration
        hard BP (naively_integrated_decoder, sparc_new.py:257-282; posteriors
        :411-439; without Onsager :230-255). On a semi-protected message BP
        runs on the protected section suffix only; the prefix keeps its MMSE
        estimate per step and is MAP-decided at the end."""
        M = self.sparc.M
        B = y.shape[0]
        beta = y.new_zeros(B, self.sparc.L * M)
        z, tau_sqr = torch.zeros_like(y), y.new_ones(B)
        for _ in range(dp.t_max - 1):
            z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                           onsager=onsager, fwht_kernel=fwht_kernel)
            soft.taus.append(tau_sqr)
            un_beta, prot_beta = self._split_protected(self._mmse(s, tau_sqr), M)
            alpha = prot_beta / self.c_amp
            post = self._bp(section_probs_to_bit_probs(alpha, M), bi, False,
                            bp_kernel, soft)
            gamma = bit_probs_to_section_probs(post, M)
            if posteriors:
                gamma = combine_posteriors(alpha, gamma, M)
            beta = torch.cat([un_beta, self.c_amp * gamma], -1)
        # the last iteration: AMP step, then the bf-iteration hard BP
        z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                       onsager=onsager, fwht_kernel=fwht_kernel)
        soft.taus.append(tau_sqr)
        _, prot_beta = self._split_protected(self._mmse(s, tau_sqr), M)
        bit_probs = section_probs_to_bit_probs(prot_beta / self.c_amp, M)
        prot_bits = self._bp(bit_probs, bf, True, bp_kernel, soft)
        return torch.cat([self._unprotected_bits(s), prot_bits], -1)

    def _decode_integrated(self, y, design, dp, bi, bf, *, posteriors,
                           fwht_kernel, bp_kernel, soft):
        """BP inside the AMP denoiser, with the generalized Onsager term from
        the derivative of the BP-composed denoiser (integrated_decoder,
        sparc_new.py:472-502; eta :709-735; posteriors :675-705, :793-822,
        :843-869)."""
        M = self.sparc.M
        B = y.shape[0]
        beta = y.new_zeros(B, self.sparc.L * M)
        z, tau_sqr, deta_sum = torch.zeros_like(y), y.new_ones(B), y.new_zeros(B)
        for _ in range(dp.t_max - 1):
            z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                           onsager="deta", deta_sum=deta_sum,
                                           fwht_kernel=fwht_kernel)
            soft.taus.append(tau_sqr)
            with tracing.span("concat.eta"):
                # eta: MMSE -> bit probabilities -> BP -> section estimate
                alpha = self._mmse(s, tau_sqr) / self.c_amp
                vk0 = section_probs_to_bit_probs(alpha, M)
                vk = self._bp(vk0, bi, False, bp_kernel, soft)
                gamma = bit_probs_to_section_probs(vk, M)
                if posteriors:
                    beta = self.c_amp * combine_posteriors(alpha, gamma, M)
                    deta = self._deta_posteriors(alpha, gamma, vk, vk0, tau_sqr, M)
                else:
                    beta = self.c_amp * gamma
                    deta = self.c_amp * integrated_onsager_derivative(
                        alpha, vk, vk0, gamma, tau_sqr, M, self.c_amp)
                deta_sum = deta.sum(-1)
        # the last iteration: AMP step, MMSE, the bf-iteration hard BP
        z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr, onsager="deta",
                                       deta_sum=deta_sum, fwht_kernel=fwht_kernel)
        soft.taus.append(tau_sqr)
        with tracing.span("concat.bp_final"):
            vk0 = section_probs_to_bit_probs(self._mmse(s, tau_sqr) / self.c_amp, M)
            bits = self._bp(vk0, bf, True, bp_kernel, soft)
        tracing.count("concat.iters", dp.t_max)
        tracing.count("concat.decodes")
        return bits

    def _deta_posteriors(self, alpha, gamma, vk, vk0, tau_sqr, M):
        """Quotient-rule derivative of the posterior-combining eta
        (differentiated_eta_calc_posteriors, sparc_new.py:843-869)."""
        c = self.c_amp
        shape = alpha.shape[:-1] + (alpha.shape[-1] // M, M)
        main = integrated_onsager_derivative(
            alpha, vk, vk0, torch.ones_like(alpha), tau_sqr, M, c)
        alpha_dash = alpha * (c / tau_sqr)[..., None] * (1.0 - alpha)
        gamma_dash = gamma * main
        top = (alpha * gamma).reshape(shape)
        # a floor under the normalizer: in float32 a section mass near zero
        # would blow up the quotient (the reference ran in float64)
        bot = torch.clamp(top.sum(-1, keepdim=True), min=1e-12)
        top_dash = (alpha_dash * gamma + alpha * gamma_dash).reshape(shape)
        bot_dash = top_dash.sum(-1, keepdim=True)
        eta_dash = c * (top_dash * bot - top * bot_dash) / (bot ** 2)
        return eta_dash.reshape(alpha.shape)

    # ------------------------------------------------------------------
    # instrumentation (the reference's *_test decoder family)
    # ------------------------------------------------------------------
    def ldpc_bp_traced(self, bit_probs: torch.Tensor, num_its: int) -> torch.Tensor:
        """Blockwise BP returning the posterior P(bit = 0) after every BP
        iteration, (num_its, ..., nbits) (ldpc_bp_test,
        sparc_new.py:1195-1232). Always the plain decode."""
        traj, _ = bp_decode_trace(self._bit_llrs(bit_probs), self.code.graph,
                                  num_iters=num_its, method="sumprod")
        return torch.sigmoid(traj).reshape((num_its,) + bit_probs.shape)

    def decode_instrumented(self, y, design, decode_params: DecodeParams,
                            decoder: str = "naive", bp_inner_iters: int = 6,
                            trace_inner_bp: bool = False,
                            fwht_kernel: bool = True, bp_kernel: bool = True) -> dict:
        """Per-iteration user-bit probes of one trial y (n,): at every AMP
        iteration the hard user-bit decisions after the MMSE step ('pre_bp')
        and after the inner BP pass ('post_bp'), each (t_max, user_bits);
        with trace_inner_bp also after every BP iteration, 'inner_bp'
        (t_max, bp_inner_iters, user_bits) (the reference's
        naively_integrated_test_* / integrated_decoder_test*,
        sparc_new.py:314-409, 573-641)."""
        assert decoder in ("naive", "no_onsager", "integrated")
        M = self.sparc.M
        onsager = {"naive": "standard", "no_onsager": "none",
                   "integrated": "deta"}[decoder]
        y = y.reshape(1, -1).to(torch.float32)
        beta = y.new_zeros(1, self.sparc.L * M)
        z, tau_sqr, deta_sum = torch.zeros_like(y), y.new_ones(1), y.new_zeros(1)
        probes = {"pre_bp": [], "post_bp": [], "inner_bp": []}
        for _ in range(decode_params.t_max):
            z, s, tau_sqr = self._amp_step(design, y, beta, z, tau_sqr,
                                           onsager=onsager, deta_sum=deta_sum,
                                           fwht_kernel=fwht_kernel)
            alpha = self._mmse(s, tau_sqr) / self.c_amp
            vk0 = section_probs_to_bit_probs(alpha, M)
            probes["pre_bp"].append(self._hard_user_bits(vk0)[0])
            if trace_inner_bp:
                traj = self.ldpc_bp_traced(vk0, bp_inner_iters)
                vk = traj[-1]
                probes["inner_bp"].append(self._hard_user_bits(traj)[:, 0])
            else:
                vk = self.ldpc_bp(vk0, bp_inner_iters, False, bp_kernel)
            probes["post_bp"].append(self._hard_user_bits(vk)[0])
            gamma = bit_probs_to_section_probs(vk, M)
            beta = self.c_amp * gamma
            if decoder == "integrated":
                deta_sum = (self.c_amp * integrated_onsager_derivative(
                    alpha, vk, vk0, gamma, tau_sqr, M, self.c_amp)).sum(-1)
        return {k: torch.stack(v) for k, v in probes.items() if v}

    def _hard_user_bits(self, bit_probs: torch.Tensor) -> torch.Tensor:
        """P(bit = 0) (..., mults * N) -> hard user-bit decisions, the first K
        of each LDPC block, (..., mults * K) int32 (ldpc_probs_to_user_bits,
        sparc_new.py:1234-1246)."""
        lead = bit_probs.shape[:-1]
        blocks = bit_probs.reshape(lead + (-1, self.code.N))
        return (blocks[..., :self.code.K] < 0.5).to(torch.int32).reshape(lead + (-1,))


# --------------------------------------------------------------------------
# end-to-end simulation (sparc_sim_new.py:12-224 family)
# --------------------------------------------------------------------------

def concat_sim(sparc_params: SparcParams, ldpc_params: LdpcParams,
               lengths: ConcatLengths, ldpc_protected: bool,
               decode_params: DecodeParams, awgn_var: float, seed,
               decoder: str = "sequential", device=None,
               fwht_kernel: bool = True, bp_kernel: bool = True) -> dict:
    """One concatenated-code trial: encode -> AWGN -> decode -> BER, on the
    card unless `device` says otherwise. Bits come from the generator of
    derive(seed, BITS), noise from derive(seed, CHANNEL), the design from
    seed. Returns ber, bits_in and bits_out."""
    device = resolve_device(device)
    codec = ConcatCodec(sparc_params, ldpc_params, lengths, ldpc_protected)
    user_bits, _, _, x, design = codec.encode(seed, device=device)
    y = awgn_channel(x, awgn_var, rngmod.root_generator(
        rngmod.derive(seed, rngmod.CHANNEL), device))
    bits_out = codec.decode(y, design, decode_params, decoder,
                            fwht_kernel=fwht_kernel, bp_kernel=bp_kernel)
    return {"ber": bit_error_rate(user_bits, bits_out), "bits_in": user_bits,
            "bits_out": bits_out}
