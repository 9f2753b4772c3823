"""State evolution (SE): the deterministic AMP performance predictor.

Counterpart of `ldpc_sparc_tpu/models/state_evolution.py`: unmodulated
(K=1, real or complex) and K-PSK codes (K=2, K=4 and general K). The
Monte-Carlo expectation is computed over one (mc_samples, M) Gaussian
sample drawn once from a `torch.Generator` seeded from `seed` on the given
device and reused across iterations and column blocks; for K > 2 the sample
is complex, its real part drawn before its imaginary part. The fixed-point
loop runs on the host and stops early on allclose(tau, tau_prev) with rtol
1e-6, as the JAX package does. The streams are not JAX's, so the two
packages' psi agree within Monte-Carlo error; on the same samples
`se_expectation` agrees to float32 rounding.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import SparcParams, create_base_matrix
from ..device import resolve_device
from ..utils.bits import constel_tensor


def se_expectation(tau: torch.Tensor, K: int, u: torch.Tensor) -> torch.Tensor:
    """E[<beta, eta(beta + sqrt(tau) Z)>] by Monte Carlo, batched over tau.

    tau: (T,) effective noise variances (one per column block); u: (mc, M)
    standard normal samples, complex for K > 2. Returns (T,). Every branch
    shifts its exponentials by their maximum, so float32 never overflows at
    small tau.
    """
    tau = torch.atleast_1d(tau)[:, None]            # (T, 1)
    itau = 1.0 / tau
    rtau = torch.sqrt(itau)

    if K == 1:
        a = itau + rtau * u[:, 0][None, :]          # (T, mc)
        cT = rtau[..., None] * u[None, :, 1:]       # (T, mc, M-1)
        m = torch.maximum(a, cT.amax(-1))
        top = torch.exp(a - m)
        E = top / (top + torch.exp(cT - m[..., None]).sum(-1))
    elif K == 2:
        a = itau + rtau * u[:, 0][None, :]
        cT = rtau[..., None] * u[None, :, 1:]
        m = torch.maximum(a.abs(), cT.abs().amax(-1))
        mm = m[..., None]
        top = torch.exp(a - m) - torch.exp(-a - m)              # 2 sinh(a) e^-m
        both = torch.exp(cT - mm) + torch.exp(-cT - mm)
        E = top / (torch.exp(a - m) + torch.exp(-a - m) + both.sum(-1))
    elif K == 4:
        # sinh / cosh of each part, e^-m on top and bottom (the /2 cancels)
        a = itau + rtau * u[:, 0].real[None, :]     # (T, mc)
        b0 = rtau * u[:, 0].imag[None, :]
        cr = rtau[..., None] * u[None, :, 1:].real  # (T, mc, M-1)
        ci = rtau[..., None] * u[None, :, 1:].imag
        m = torch.maximum(torch.maximum(a.abs(), b0.abs()),
                          torch.maximum(cr.abs().amax(-1), ci.abs().amax(-1)))
        mm = m[..., None]
        top = torch.exp(a - m) - torch.exp(-a - m)
        bot = (torch.exp(a - m) + torch.exp(-a - m)
               + torch.exp(b0 - m) + torch.exp(-b0 - m)
               + (torch.exp(cr - mm) + torch.exp(-cr - mm)
                  + torch.exp(ci - mm) + torch.exp(-ci - mm)).sum(-1))
        E = top / bot
    else:
        c = constel_tensor(K, u.device)             # (K,)
        u0 = u[:, 0][None, :, None]                 # (1, mc, 1)
        arg0 = ((itau[..., None] + rtau[..., None] * u0) * c.conj()).real   # (T, mc, K)
        argC = ((rtau[..., None, None] * u[None, :, 1:, None]) * c.conj()).real
        # one shift for both exponent families (it cancels in the ratio)
        m = torch.maximum(arg0.amax(-1), argC.amax(dim=(-1, -2)))
        tmpB = torch.exp(arg0 - m[..., None])
        expsA = (c.real * tmpB).mean(-1)
        tmpC = torch.exp(argC - m[..., None, None]).mean(-1)
        E = expsA / (tmpB.mean(-1) + tmpC.sum(-1))
    return E.mean(-1)


def sparc_se(awgn_var: float, params: SparcParams, t_max: int,
             mc_samples: int, seed: int = 0,
             device=None) -> Tuple[np.ndarray, np.ndarray]:
    """State evolution for SPARCs. Returns (psi, tau): psi the (t_max, Lc)
    NMSE trajectory, tau the final (Lc,) effective noise variances. A
    complex code runs at the rate per dimension R/2; for K > 2 the sample
    is complex, two real draws of (mc_samples, M), real part first."""
    device = resolve_device(device)
    W = torch.as_tensor(create_base_matrix(params, awgn_var), dtype=torch.float32,
                        device=device)
    Lr, Lc = W.shape
    R = params.R / 2 if params.is_complex else params.R  # rate per dimension
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.randn(mc_samples, params.M, generator=gen, device=device)
    if params.K > 2:
        u = torch.complex(u, torch.randn(mc_samples, params.M, generator=gen,
                                         device=device))
    coef = float(np.log(2) * R * Lr / np.log(params.K * params.M))

    def tau_of(psi_t):
        phi = awgn_var + (W @ torch.as_tensor(psi_t, dtype=torch.float32,
                                              device=device)) / Lc
        return (coef / (W.T @ (1.0 / phi))).cpu().numpy()

    psi = np.ones((t_max, Lc))
    tau = None
    for t in range(t_max - 1):
        tau_prev = tau
        tau = tau_of(psi[t])
        if tau_prev is not None and np.allclose(tau, tau_prev, rtol=1e-6, atol=0):
            psi[t:] = psi[t]
            break
        psi[t + 1] = 1.0 - se_expectation(torch.as_tensor(tau, device=device),
                                          params.K, u).cpu().numpy()
    if tau is None:   # t_max == 1: the tau of the initial psi
        tau = tau_of(psi[0])
    return psi, tau
