"""Pure-SPARC codec: encoder, AWGN channel and the AMP decoder, in PyTorch.

Counterpart of `ldpc_sparc_tpu/models/sparc.py`: every family (plain,
power-allocated, spatially coupled), real or complex, unmodulated (K=1) or
K-PSK modulated (K = 2, 4, 8, ...), with the SRHT design engine or, for
complex plain codes, the DFT engine. The JAX decoder vmaps a `lax.scan`;
here the batch of codewords is a leading dimension and the iterations are a
Python loop of t_max - 1 steps. A codeword that has converged is frozen
row by row, exactly as the JAX decoder freezes its state, so the outputs do
not depend on what else is in the batch: with `torch.where`, and on the
fused path K3 copies a stopped row's beta and s through itself. The
decoder's state takes y's type: complex64 for complex y, else float32.

Kernels on the path (both run when the tensors are on a card, and their
plain versions run on the CPU):
  * the signed FWHT of both SRHT design products (`ops/wht_cuda.py`): K1
    with `fwht_mode="ms"` (the default), K2 with `fwht_mode="2mm"` (bf16 operands)
    or `"2mm_f32"` (float32 operands) on real data; complex data runs K1 on
    stacked real rows;
  * the fused denoiser tail (`ops/denoiser_cuda.py`), for real K=1 codes
    whenever the shape is eligible and `fused_denoiser` is not False.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import SparcParams, DecodeParams, create_base_matrix
from ..device import all_reduce, resolve_device
from ..ops.transforms import SparcDesign, design_class
from ..ops.denoiser import mmse_denoise, map_estimate
from ..ops.denoiser_cuda import fused_eligible, fused_denoise_update
from ..utils import bits as bitops
from ..utils import rng as rngmod
from ..utils.metrics import (bit_error_rate, location_value_errors,
                             section_errors)
from ..utils.tracing import count

MIN = torch.distributed.ReduceOp.MIN


def design_for_params(params: SparcParams, awgn_var: float, seed,
                      engine: str = "srht", device=None):
    """The seeded design of `params`, on the card unless `device` says
    otherwise: a `SparcDesign` ('srht', every family) or a `DftDesign`
    ('dft', the reference's complex ensemble, complex plain codes)."""
    return design_class(engine).for_params(params, awgn_var, seed, device)


# --------------------------------------------------------------------------
# Encoder / channel
# --------------------------------------------------------------------------

def sparc_encode(params: SparcParams, awgn_var: float, seed,
                 gen: Optional[torch.Generator] = None, engine: str = "srht",
                 device=None):
    """Random bits -> message vector -> x = A @ beta0 through the seeded
    design. Returns (bits, beta0, x, design)."""
    device = resolve_device(device)
    if gen is None:
        gen = rngmod.root_generator(rngmod.derive(seed, rngmod.BITS), device)
    bits = bitops.random_bits(gen, params.bit_len)
    beta0 = bitops.bits_to_msg_vector(bits, params.M, params.K)
    design = design_for_params(params, awgn_var, seed, engine, device)
    return bits, beta0, design.ab(beta0), design


def awgn_channel(x: torch.Tensor, awgn_var: float,
                 gen: torch.Generator) -> torch.Tensor:
    """AWGN channel: x + N(0, awgn_var) noise drawn from `gen`; a complex x
    gets circular noise of total variance awgn_var, awgn_var/2 a part, the
    real part drawn before the imaginary part."""
    if x.is_complex():
        part = x.real.dtype
        re = torch.randn(x.shape, generator=gen, device=x.device, dtype=part)
        im = torch.randn(x.shape, generator=gen, device=x.device, dtype=part)
        return x + torch.complex(re, im) * float(np.sqrt(awgn_var / 2))
    noise = torch.randn(x.shape, generator=gen, device=x.device,
                        dtype=x.dtype)
    return x + noise * float(np.sqrt(awgn_var))


# --------------------------------------------------------------------------
# AMP decoder
# --------------------------------------------------------------------------

def _abs2(v: torch.Tensor) -> torch.Tensor:
    """|v|^2 elementwise (v ** 2 for real v)."""
    return v.abs() ** 2 if v.is_complex() else v ** 2


class AmpResult(NamedTuple):
    beta: torch.Tensor        # (..., LM) hard-decision (MAP on s), unit amp
    beta_mmse: torch.Tensor   # (..., LM) final posterior-mean estimate
    s: torch.Tensor           # (..., LM) final effective observation
    t_final: torch.Tensor     # (...,) number of AMP iterations performed
    nmse: torch.Tensor        # (..., t_max, Lc) NMSE trajectory (vs beta0 if given)
    psi: torch.Tensor         # (..., Lc) final estimated NMSE


def amp_decode(y: torch.Tensor, design: SparcDesign, params: SparcParams,
               decode: DecodeParams, awgn_var: float,
               beta0: Optional[torch.Tensor] = None, W=None,
               fused_denoiser: bool | None = None,
               fwht_kernel: bool = True, fwht_mode: str = "ms",
               sec_group=None) -> AmpResult:
    """AMP decoding of SPARC codewords y (..., n), real or complex.

    Per iteration (unified 2-D base-matrix form, Lr x Lc blocks):
        gamma = W @ psi / Lc                       residual var minus noise var
        z     = y - A beta + repeat(gamma/phi_prev, Mr) * z     (Onsager)
        phi   = awgn_var + gamma            (phi_est_method=1)
              | per-row-block mean |z|^2    (phi_est_method=2)
        tau_c = (L/Mr) / (W^T (1/phi))_c           effective noise variance
        s     = beta + repeat(tau, Mc) * A^T (z / repeat(phi, Mr))
        beta  = MMSE eta(s, tau)             (K-PSK denoiser for K > 1)
        psi_c = 1 - sum|beta_c|^2 / (L/Lc)
    for t_max - 1 iterations, with per-codeword freezing once psi stops
    moving (allclose with rtol and atol = 2 * float32 resolution), then a
    MAP hard decision on s. The first iteration skips A @ 0. On the fused
    path the freeze of beta and s is K3's: it reads one pair of buffers,
    writes the other, copying stopped rows through, and the pairs swap.

    fused_denoiser: None takes the fused tail (`fused_denoise_update`)
    whenever `fused_eligible` holds, True demands it, False takes the
    plain `mmse_denoise` tail. fwht_kernel=False runs the design products
    on the plain FWHT chain. fwht_mode: "ms" (K1, float32), "2mm" (K2,
    bf16 operands) or "2mm_f32" (K2, float32 operands), the JAX package's
    `set_fwht_backend` mode and dtype.

    Every base-matrix family takes this one loop: the plain code (W is
    1 x 1), power allocation (1 x B) and spatial coupling (Lr x Lc), whose E
    nonzero blocks go through one batched transform. The state (beta, z, s)
    is complex64 for complex y, else float32; a K=1 denoiser's real
    estimate joins a complex state as complex.

    sec_group: the process group of a 'sec' axis that shares out the column
    blocks (`parallel/sharded.py`); None is one device. Given the group,
    `design` and `W` are this rank's shard (its column blocks and their
    columns of the base matrix), y is replicated, and three values are
    summed over the group: W psi, A beta and the stop test, so that a
    codeword stops when every section on every rank has settled. The
    returned beta, s, nmse and psi are the shard's.
    """
    eligible = fused_eligible(params.M, params.K, y.is_complex())
    if fused_denoiser and not eligible:
        raise ValueError(f"the fused denoiser does not take M={params.M}, "
                         f"K={params.K}")
    fused = eligible if fused_denoiser is None else fused_denoiser
    if W is None:
        W = create_base_matrix(params, float(awgn_var))
    W = torch.as_tensor(W, dtype=torch.float32, device=y.device)
    Lr, Lc = W.shape
    L, M, K = params.L, params.M, params.K
    n, LM = design.n, design.LM
    Mr, Mc = n // Lr, LM // Lc
    sec_per_col = Mc // M
    Lc_all = L // sec_per_col   # Lc over every rank of sec_group
    atol = 2 * float(np.finfo(np.float32).resolution)

    def total(v):   # the sum of v over sec_group
        return v if sec_group is None else all_reduce(v, sec_group)

    batch = y.shape[:-1]
    cdtype = torch.complex64 if y.is_complex() else torch.float32
    y = y.reshape(-1, n).to(cdtype)
    B = y.shape[0]
    if beta0 is not None:
        beta0 = beta0.reshape(-1, LM)

    def per_row_block(v, stat):  # (B, n) op (B, Lr) broadcast over Mr
        return v.reshape(B, Lr, Mr), stat[:, :, None]

    beta = torch.zeros(B, LM, dtype=cdtype, device=y.device)
    z = torch.zeros_like(y)
    s = torch.zeros_like(beta)
    phi = torch.ones(B, Lr, dtype=torch.float32, device=y.device)
    psi = torch.ones(B, Lc, dtype=torch.float32, device=y.device)
    stopped = torch.zeros(B, dtype=torch.bool, device=y.device)
    t_final = torch.zeros(B, dtype=torch.int64, device=y.device)
    nmse = [torch.ones_like(psi)]
    if fused:   # the buffers K3 writes s and beta into, swapped with s and beta
        spare = (torch.empty_like(s), torch.empty_like(beta))

    for t in range(decode.t_max - 1):
        count("amp.row_iters", B)
        gamma = total(psi @ W.T) / Lc_all                          # (B, Lr)
        if t == 0:
            z_new = y
        else:
            zb, coef = per_row_block(z, gamma / phi)
            z_new = (y - total(design.ab(beta, fwht_kernel, fwht_mode))
                     + (coef * zb).reshape(B, n))
        if decode.phi_est_method == 1:
            phi_new = awgn_var + gamma
        else:
            phi_new = (z_new.abs() ** 2).reshape(B, Lr, Mr).mean(-1)

        tau = (L / Mr) / ((1.0 / phi_new) @ W)                      # (B, Lc)
        zb, ph = per_row_block(z_new, phi_new)
        azo = design.az((zb / ph).reshape(B, n), fwht_kernel, fwht_mode)
        if fused:
            tau_sec = tau.repeat_interleave(sec_per_col, dim=1)        # (B, L)
            s_new, beta_new, sec_en = fused_denoise_update(
                beta, azo, tau_sec, M, stopped=stopped, s_prev=s, out=spare)
            psi_new = 1.0 - sec_en.reshape(B, Lc, sec_per_col).sum(-1) / sec_per_col
        else:
            tc = tau[:, :, None]
            s_new = (beta.reshape(B, Lc, Mc) + tc * azo.reshape(B, Lc, Mc))
            beta_new = mmse_denoise(s_new, 1.0 / tc, M, K).reshape(B, LM).to(cdtype)
            s_new = s_new.reshape(B, LM)
            psi_new = 1.0 - _abs2(beta_new.reshape(B, Lc, Mc)).sum(-1) / sec_per_col
        del azo   # one azo at a time: the next az allocates its own

        # every section has settled (rebound, so no extra tensor outlives the step)
        converged = ((psi_new - psi).abs() <= atol + decode.rtol * psi.abs()).all(-1)
        if sec_group is not None:   # and on every other rank of the group
            converged = all_reduce(converged.int(), sec_group, MIN) > 0
        converged = (t > 0) & converged
        # freeze the codewords that had stopped before this iteration
        keep = stopped[:, None]
        if fused:   # K3 froze beta and s
            spare = (s, beta)
            beta, s = beta_new, s_new
        else:
            beta = torch.where(keep, beta, beta_new)
            s = torch.where(keep, s, s_new)
        z = torch.where(keep, z, z_new)
        phi = torch.where(keep, phi, phi_new)
        psi = torch.where(keep, psi, psi_new)
        t_final = torch.where(stopped, t_final, t + 1)
        stopped = stopped | converged

        if beta0 is not None:
            err = _abs2(beta - beta0).reshape(B, Lc, Mc).sum(-1)
            nmse.append(err / sec_per_col)
        else:
            nmse.append(psi)

    if fused:
        del spare   # the MAP decision's buffers take its room
    beta_map = map_estimate(s, M, K)
    return AmpResult(beta=beta_map.reshape(batch + (LM,)),
                     beta_mmse=beta.reshape(batch + (LM,)),
                     s=s.reshape(batch + (LM,)),
                     t_final=t_final.reshape(batch),
                     nmse=torch.stack(nmse, 1).reshape(batch + (decode.t_max, Lc)),
                     psi=psi.reshape(batch + (Lc,)))


def decode_batch(y: torch.Tensor, design: SparcDesign, params: SparcParams,
                 decode: DecodeParams, awgn_var: float,
                 fused_denoiser: bool | None = None, fwht_kernel: bool = True,
                 fwht_mode: str = "ms"):
    """The batched decode `bench.py` times: AMP on y (B, n), returning the
    hard decisions (B, L*M) and the iterations run (B,)."""
    res = amp_decode(y, design, params, decode, awgn_var,
                     fused_denoiser=fused_denoiser, fwht_kernel=fwht_kernel,
                     fwht_mode=fwht_mode)
    return res.beta, res.t_final


def sparc_decode(y: torch.Tensor, design: SparcDesign, params: SparcParams,
                 decode: DecodeParams, awgn_var: float,
                 beta0: Optional[torch.Tensor] = None, fwht_mode: str = "ms",
                 fused_denoiser: bool | None = None):
    """AMP + hard decision + bits + the frame-error flag mean(psi) >= 1e-3."""
    res = amp_decode(y, design, params, decode, awgn_var, beta0,
                     fused_denoiser=fused_denoiser, fwht_mode=fwht_mode)
    expect_err = res.psi.mean(-1) >= 0.001
    bits_out = bitops.msg_vector_to_bits(res.beta, params.M, params.K)
    return bits_out, res, expect_err


# --------------------------------------------------------------------------
# End-to-end simulation
# --------------------------------------------------------------------------

def sparc_sim(params: SparcParams, decode: DecodeParams, awgn_var: float,
              seed, engine: str = "srht", device=None,
              fwht_mode: str = "ms",
              fused_denoiser: bool | None = None) -> dict:
    """One trial end to end: bits -> beta0 -> x -> AWGN -> AMP -> metrics.

    Returns ber, cer, t_final, nmse, detect, ser, num_of_sec_errs and
    loc_of_sec_errs (the indices of the sections decoded wrong); a modulated
    code adds ler, ver, num_of_loc_errs, num_of_val_errs, loc_of_loc_errs
    and loc_of_val_errs (`utils.metrics.location_value_errors`).
    fused_denoiser: see `amp_decode`; False takes the plain denoiser tail,
    whose stop fires where the JAX package's does.
    """
    device = resolve_device(device)
    design = design_for_params(params, awgn_var, seed, engine, device)
    W = create_base_matrix(params, awgn_var)
    bits_in = bitops.random_bits(
        rngmod.root_generator(rngmod.derive(seed, rngmod.BITS), device),
        params.bit_len)
    beta0 = bitops.bits_to_msg_vector(bits_in, params.M, params.K)
    y = awgn_channel(design.ab(beta0, fwht_mode=fwht_mode), awgn_var,
                     rngmod.root_generator(rngmod.derive(seed, rngmod.CHANNEL),
                                           device))
    res = amp_decode(y, design, params, decode, awgn_var, beta0, W,
                     fused_denoiser=fused_denoiser, fwht_mode=fwht_mode)
    expect_err = res.psi.mean() >= 0.001
    bits_out = bitops.msg_vector_to_bits(res.beta, params.M, params.K)

    ber = bit_error_rate(bits_in, bits_out)
    out = {"ber": ber, "cer": (ber > 0).to(torch.float32),
           "t_final": res.t_final, "nmse": res.nmse,
           "detect": (~((ber > 0) ^ expect_err)).to(torch.float32)}
    if not params.modulated:
        err, ser = section_errors(beta0, res.beta, params.L)
        inds = {"sec": err}
    else:
        (ler, ver, ser), (loc_e, val_e, err) = location_value_errors(
            beta0, res.beta, params.L)
        out.update(ler=ler, ver=ver, num_of_loc_errs=loc_e.sum(),
                   num_of_val_errs=val_e.sum())
        inds = {"sec": err, "loc": loc_e, "val": val_e}
    out.update(ser=ser, num_of_sec_errs=err.sum())
    for name, ind in inds.items():
        out[f"loc_of_{name}_errs"] = np.flatnonzero(ind.cpu().numpy())
    return out
