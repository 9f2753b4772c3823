"""Section-wise Bayes-MMSE and MAP denoisers for SPARC AMP.

Counterpart of `ldpc_sparc_tpu/ops/denoiser.py`. The posterior of each
M-entry section is a softmax of its logits (log-sum-exp, so float32 cannot
overflow): s / tau for K=1 (the real part of s for a complex code), and for
a K-PSK code (K >= 2) the M*K logits Re(s conj(c_k)) * factor / tau over
(position, symbol), with factor 2 for complex s (its noise has tau/2 a
part) and 1 for real s. The MAP estimate is the one-hot of each section's
argmax over the same logits, carrying the symbol (the first maximum on
ties). All functions are unit-amplitude.
"""

from __future__ import annotations

import torch

from ..utils.bits import constel_tensor


def _section_logits(s: torch.Tensor, inv_tau, M: int, K: int = 1) -> torch.Tensor:
    """(..., L*M) s times inv_tau (broadcastable to s) -> (..., L, M) for
    K == 1, else (..., L, M, K)."""
    L = s.shape[-1] // M
    sec = s.reshape(s.shape[:-1] + (L, M))
    it = torch.as_tensor(inv_tau, device=s.device).expand(s.shape).reshape(sec.shape)
    if K == 1:
        return sec.real * it
    c = constel_tensor(K, s.device)
    factor = 2.0 if s.is_complex() else 1.0
    return (sec[..., None] * c.conj()).real * (factor * it[..., None])


def mmse_denoise(s: torch.Tensor, inv_tau, M: int, K: int = 1,
                 return_probs: bool = False):
    """Posterior-mean estimate E[beta0 | beta0 + tau*N = s], (..., L*M): a
    softmax over each section's M (K=1) or M*K logits, then sum p * c;
    with return_probs, also the per-section position marginals (..., L, M)."""
    logits = _section_logits(s, inv_tau, M, K)
    if K == 1:
        p = pos = torch.softmax(logits, dim=-1)
        beta = p.reshape(s.shape)
    else:
        shp = logits.shape
        p = torch.softmax(logits.reshape(shp[:-2] + (M * K,)), dim=-1).reshape(shp)
        beta = (p * constel_tensor(K, s.device)).sum(-1).reshape(s.shape)
        pos = p.sum(-1)
    if return_probs:
        return beta, pos
    return beta


def map_estimate(s: torch.Tensor, M: int, K: int = 1) -> torch.Tensor:
    """Hard decision: per section, the one-hot of the (position, symbol)
    pair maximising Re(s conj(c)) (the first maximum on ties), times the
    symbol; float32 for K <= 2, complex64 above."""
    logits = _section_logits(s, torch.ones((), device=s.device), M, K)
    L = s.shape[-1] // M
    if K == 1:
        idx = torch.argmax(logits, dim=-1)
        vals = torch.ones(idx.shape, dtype=torch.float32, device=s.device)
    else:
        mk = torch.argmax(logits.reshape(logits.shape[:-2] + (M * K,)), dim=-1)
        idx = mk // K
        vals = constel_tensor(K, s.device)[mk % K]
    beta = torch.zeros(s.shape[:-1] + (L, M), dtype=vals.dtype, device=s.device)
    beta.scatter_(-1, idx[..., None], vals[..., None])
    return beta.reshape(s.shape[:-1] + (L * M,))
