"""Checks of the AMP loop's freeze inside K3, shared by the CPU tests and the
card's (this module imports no JAX).

* `where_freeze_decode`: the loop's fused path as `models/sparc.py::
  amp_decode` ran it before K3 took the freeze: K3 (its plain version on
  the CPU) without a mask, then `torch.where` over beta, z, s, phi and psi.
  `amp_decode` is held to it bit for bit.
* `check_freeze_step`: one masked K3 step against the unmasked one.
"""

import numpy as np
import torch

from ldpc_sparc_tpu_torch.config import create_base_matrix
from ldpc_sparc_tpu_torch.ops.denoiser import map_estimate
from ldpc_sparc_tpu_torch.ops.denoiser_cuda import fused_denoise_update


def where_freeze_decode(y, design, params, decode, awgn_var, beta0=None):
    """Real K=1 codes whose M K3 takes; y (B, n). Returns (MAP decisions,
    beta_mmse, s, t_final, nmse, psi) as `amp_decode` returns them."""
    W = torch.as_tensor(create_base_matrix(params, float(awgn_var)),
                        dtype=torch.float32, device=y.device)
    Lr, Lc = W.shape
    L, M = params.L, params.M
    n, LM = design.n, design.LM
    Mr, spc = n // Lr, L // Lc
    atol = 2 * float(np.finfo(np.float32).resolution)
    B = y.shape[0]
    beta = torch.zeros(B, LM, device=y.device)
    z, s = torch.zeros_like(y), torch.zeros_like(beta)
    phi = torch.ones(B, Lr, device=y.device)
    psi = torch.ones(B, Lc, device=y.device)
    stopped = torch.zeros(B, dtype=torch.bool, device=y.device)
    t_final = torch.zeros(B, dtype=torch.int64, device=y.device)
    nmse = [torch.ones_like(psi)]
    for t in range(decode.t_max - 1):
        gamma = (psi @ W.T) / Lc
        if t == 0:
            z_new = y
        else:
            z_new = (y - design.ab(beta)
                     + ((gamma / phi)[:, :, None] * z.reshape(B, Lr, Mr)).reshape(B, n))
        if decode.phi_est_method == 1:
            phi_new = awgn_var + gamma
        else:
            phi_new = (z_new.abs() ** 2).reshape(B, Lr, Mr).mean(-1)
        tau = (L / Mr) / ((1.0 / phi_new) @ W)
        azo = design.az((z_new.reshape(B, Lr, Mr) / phi_new[:, :, None]).reshape(B, n))
        s_new, beta_new, sec_en = fused_denoise_update(
            beta, azo, tau.repeat_interleave(spc, dim=1), M)
        psi_new = 1.0 - sec_en.reshape(B, Lc, spc).sum(-1) / spc
        converged = (t > 0) & ((psi_new - psi).abs()
                               <= atol + decode.rtol * psi.abs()).all(-1)
        keep = stopped[:, None]
        beta = torch.where(keep, beta, beta_new)
        z = torch.where(keep, z, z_new)
        s = torch.where(keep, s, s_new)
        phi = torch.where(keep, phi, phi_new)
        psi = torch.where(keep, psi, psi_new)
        t_final = torch.where(stopped, t_final, t + 1)
        stopped = stopped | converged
        if beta0 is not None:
            nmse.append(((beta - beta0) ** 2).reshape(B, Lc, LM // Lc).sum(-1) / spc)
        else:
            nmse.append(psi)
    return map_estimate(s, M, 1), beta, s, t_final, torch.stack(nmse, 1), psi


def check_freeze_step(dev, B, L, M, route=None, stopped=None):
    """K3 with `stopped` (default: every third row live) on the state an
    unmasked step wrote: live rows bit-equal to the unmasked step, stopped
    rows' s and beta copied exactly and their energies the ones the step that
    wrote beta computed; s and beta_new land in `out`."""
    gen = torch.Generator(device=dev).manual_seed(M + B)
    beta0 = torch.softmax(3 * torch.randn(B, L, M, generator=gen, device=dev),
                          -1).reshape(B, L * M)
    step = [(2 * torch.randn(B, L * M, generator=gen, device=dev),
             0.5 + 1.5 * torch.rand(B, L, generator=gen, device=dev)) for _ in range(2)]
    s_prev, beta, en_prev = fused_denoise_update(beta0, *step[0], M, route)
    if stopped is None:
        stopped = torch.arange(B, device=dev) % 3 != 0
    out = (torch.empty_like(beta), torch.empty_like(beta))
    got = fused_denoise_update(beta, *step[1], M, route, stopped=stopped, s_prev=s_prev,
                               out=out)
    want = fused_denoise_update(beta, *step[1], M, route)
    live = ~stopped
    assert got[0] is out[0] and got[1] is out[1]
    assert all(torch.equal(g[live], w[live]) for g, w in zip(got, want))
    assert torch.equal(got[0][stopped], s_prev[stopped])
    assert torch.equal(got[1][stopped], beta[stopped])
    assert torch.equal(got[2][stopped], en_prev[stopped])
