"""State evolution (SE): the deterministic AMP performance predictor.

Counterpart of `ldpc_sparc_tpu/models/state_evolution.py` for K=1 (real or
complex unmodulated codes). The Monte-Carlo expectation is computed over
one (mc_samples, M) Gaussian sample drawn once from a `torch.Generator`
seeded from `seed` on the given device and reused across iterations and
column blocks; the fixed-point loop runs on the host and stops early on
allclose(tau, tau_prev) with rtol 1e-6, as the JAX package does. The
streams are not JAX's, so the two packages' psi agree within Monte-Carlo
error; on the same samples `se_expectation` agrees to float32 rounding.

PSK-modulated codes (K >= 2) are not ported and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import SparcParams, create_base_matrix
from ..device import resolve_device


def se_expectation(tau: torch.Tensor, K: int, u: torch.Tensor) -> torch.Tensor:
    """E[<beta, eta(beta + sqrt(tau) Z)>] by Monte Carlo, batched over tau.

    tau: (T,) effective noise variances (one per column block); u: (mc, M)
    standard normal samples. Returns (T,). The exponentials are shifted by
    their maximum, so float32 never overflows at small tau.
    """
    if K != 1:
        raise NotImplementedError("state evolution for PSK-modulated codes "
                                  "(K >= 2) is not ported")
    tau = torch.atleast_1d(tau)[:, None]            # (T, 1)
    itau = 1.0 / tau
    rtau = torch.sqrt(itau)
    a = itau + rtau * u[:, 0][None, :]              # (T, mc)
    cT = rtau[..., None] * u[None, :, 1:]           # (T, mc, M-1)
    m = torch.maximum(a, cT.amax(-1))
    top = torch.exp(a - m)
    bot = top + torch.exp(cT - m[..., None]).sum(-1)
    return (top / bot).mean(-1)


def sparc_se(awgn_var: float, params: SparcParams, t_max: int,
             mc_samples: int, seed: int = 0,
             device=None) -> Tuple[np.ndarray, np.ndarray]:
    """State evolution for SPARCs. Returns (psi, tau): psi the (t_max, Lc)
    NMSE trajectory, tau the final (Lc,) effective noise variances."""
    if params.K != 1:
        raise NotImplementedError("state evolution for PSK-modulated codes "
                                  "(K >= 2) is not ported")
    device = resolve_device(device)
    W = torch.as_tensor(create_base_matrix(params, awgn_var), dtype=torch.float32,
                        device=device)
    Lr, Lc = W.shape
    R = params.R / 2 if params.is_complex else params.R  # rate per dimension
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.randn(mc_samples, params.M, generator=gen, device=device)
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
