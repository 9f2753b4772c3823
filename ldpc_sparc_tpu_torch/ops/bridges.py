"""AMP <-> BP probability bridges, in PyTorch.

Counterpart of `ldpc_sparc_tpu/ops/bridges.py`: the closed, vectorized
forms of the reference's per-(section, entry, bit) loops
(sparc_sophie/sparc_new.py:1118-1160, 1260-1279) and of the integrated
decoder's Onsager derivative (sparc_new.py:824-883). Everything reduces to
products with one fixed 0/1 mask

    BIT0[q, k] = 1  iff bit k (MSB first) of section index q is 0,

the S_k index sets of the reference's `S_k_mapping`. Every function takes
leading batch dimensions; the mask is made once per (M, device).

The products with the mask are float32 `torch.matmul`s and must run in full
float32 on a card: `torch.backends.cuda.matmul.allow_tf32` has to be False
(torch's default), or the bit probabilities lose 13 bits of mantissa.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def bit0_mask_np(M: int) -> np.ndarray:
    """(M, logM) mask: entry [q, k] is 1 iff bit k (MSB first) of q is 0."""
    logM = M.bit_length() - 1
    q = np.arange(M)[:, None]
    k = np.arange(logM)[None, :]
    return ((q >> (logM - 1 - k)) & 1 == 0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bit0_mask(M: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(bit0_mask_np(M), device=device)


def s_k_mapping(M: int) -> list:
    """The reference's S_k index sets (sparc_new.py:1140-1160): for each bit
    position k, the section indices whose bit k is 0."""
    mask = bit0_mask_np(M)
    return [list(np.flatnonzero(mask[:, k])) for k in range(mask.shape[1])]


def section_probs_to_bit_probs(probs: torch.Tensor, M: int) -> torch.Tensor:
    """Section posteriors (..., L*M) -> per-bit P(bit = 0) (..., L*logM):
    p0[l, k] = sum_{q in S_k} probs[l, q]."""
    logM = M.bit_length() - 1
    L = probs.shape[-1] // M
    sec = probs.reshape(probs.shape[:-1] + (L, M))
    p0 = sec @ _bit0_mask(M, probs.device)
    return p0.reshape(probs.shape[:-1] + (L * logM,))


def bit_probs_to_section_probs(p0: torch.Tensor, M: int,
                               eps: float = 1e-7) -> torch.Tensor:
    """Per-bit P(bit = 0) (..., L*logM) -> section posteriors (..., L*M),
    probs[l, q] = prod_k (BIT0[q, k] ? p0[l, k] : 1 - p0[l, k]), in log
    space. eps is float32-safe: 1 - 1e-15 would round to 1 and give log(0)."""
    logM = M.bit_length() - 1
    L = p0.shape[-1] // logM
    mask = _bit0_mask(M, p0.device)                       # (M, logM)
    pb = torch.clamp(p0.reshape(p0.shape[:-1] + (L, logM)), eps, 1.0 - eps)
    logits = torch.log(pb) @ mask.T + torch.log1p(-pb) @ (1.0 - mask.T)
    return torch.exp(logits).reshape(p0.shape[:-1] + (L * M,))


def combine_posteriors(alpha: torch.Tensor, gamma: torch.Tensor,
                       M: int) -> torch.Tensor:
    """Posterior combination (product, renormalized per section) of two
    section posteriors (..., L*M) (`update_using_bp_probs`,
    sparc_new.py:1030-1038)."""
    L = alpha.shape[-1] // M
    top = (alpha * gamma).reshape(alpha.shape[:-1] + (L, M))
    bot = top.sum(-1, keepdim=True)
    return (top / torch.clamp(bot, min=1e-30)).reshape(alpha.shape)


def integrated_onsager_derivative(alpha: torch.Tensor, vk: torch.Tensor,
                                  vk0: torch.Tensor, beta_probs: torch.Tensor,
                                  tau_sqr, M: int, c_amp: float) -> torch.Tensor:
    """Per-entry derivative d(eta)/ds of the BP-composed denoiser, for the
    integrated decoder's Onsager term (`differentiated_eta_calc` with
    `sub_term`, sparc_new.py:824-883). With B = BIT0, A = alpha @ B and
    D = clip(vk0) (1 - clip(vk0)):

        main[l, q] = (c / tau^2) alpha[l, q] ( [(1 - vk - A) / D] @ B^T
                                               + rowsum(vk A / D) )[l, q]

    and the result is beta_probs * main (the caller multiplies by c_amp).

    alpha, beta_probs : (..., L*M) unit-amplitude posteriors before / after BP
    vk, vk0           : (..., L*logM) BP output / input bit probabilities
    tau_sqr           : (...,) tensor (one per leading index) or a number
    """
    logM = M.bit_length() - 1
    L = alpha.shape[-1] // M
    lead = alpha.shape[:-1]
    B = _bit0_mask(M, alpha.device)                      # (M, logM)
    a = alpha.reshape(lead + (L, M))
    v = vk.reshape(lead + (L, logM))
    # float32-safe clip: the reference's 1e-10 rounds 1 - eps to 1, D to 0
    v0 = torch.clamp(vk0.reshape(lead + (L, logM)), 1e-6, 1.0 - 1e-6)
    D = v0 * (1.0 - v0)
    A = a @ B                                            # (..., L, logM)
    term_b = ((1.0 - v - A) / D) @ B.T                   # (..., L, M)
    term_c = (v * A / D).sum(-1, keepdim=True)           # (..., L, 1)
    tau = torch.as_tensor(tau_sqr, dtype=a.dtype, device=a.device)[..., None, None]
    main = (c_amp / tau) * a * (term_b + term_c)
    return (beta_probs.reshape(lead + (L, M)) * main).reshape(alpha.shape)
