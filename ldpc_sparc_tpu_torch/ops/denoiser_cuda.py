"""Fused AMP denoiser tail: the hand-written Hopper kernel and its plain version.

`fused_denoise_update` replaces `ldpc_sparc_tpu/ops/denoiser_pallas.py::
fused_denoise_update`. Per section of M entries, with tau = tau_sec[..., l]:

    s        = beta + tau * azo
    beta_new = softmax(s / tau)        (K=1 Bayes-MMSE estimate)
    sec_en   = sum(beta_new^2)

The AMP loop's freeze rides along (`stopped`, `s_prev`): a codeword that
has stopped keeps its beta and s, which the step copies through, and its
energies are those of beta; `out` names the two buffers s and beta_new are
written into, so that the loop can keep its state in two pairs of buffers
and swap them each step.

On a CUDA tensor the kernel of `csrc/denoise_update.cu` runs, or the call
raises; on a CPU tensor `fused_denoise_update_ref` runs. The counters
`k3.launches` and `k3.freeze_launches` (`utils/tracing.py`) count the
kernel's launches and those that took `stopped`. The kernel takes every
power of two M from 32 to 2^22, the JAX kernel's range
(`denoiser_pallas.use_fused_denoiser` with `config.py`'s powers of two),
by one of two routes:

* "block": up to 4096 one block holds a section in registers, from 8192 one
  block of 1024 threads walks it three times (the default up to 2^15);
* "cluster" (2^16 to 2^22, the default there): a thread-block cluster of C
  blocks a section (`cluster_layout`), each block walking its contiguous
  share, the section's max, sum and energy combined across the cluster in
  block-rank order.

`route=None` takes the default for M; a route named where it does not take
M raises, and a cluster launch the card refuses raises too.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import is_power_of_2
from ..utils.tracing import count

MIN_M, MAX_M = 32, 1 << 22
ROUTES = ("block", "cluster")
CLUSTER_MIN_M = 1 << 16
SHARE_LOG, HELD_LOG, CLUSTER_MAX = 14, 15, 16   # a share up to 2^18; held; blocks


def fused_eligible(M: int, K: int, is_complex: bool) -> bool:
    """Shapes the fused tail takes: real, unmodulated (K=1), and M a power of
    two in [32, 2^22] (one block per section)."""
    return K == 1 and not is_complex and is_power_of_2(M) and MIN_M <= M <= MAX_M


def k3_route(M: int) -> str:
    """The route `fused_denoise_update` takes for sections of M by default."""
    return "cluster" if M >= CLUSTER_MIN_M else "block"


def cluster_layout(M: int) -> tuple[int, int, int]:
    """The cluster route's (C, share, held) for sections of M >= 2^16: C
    blocks a section (M / 2^14, at most 16), block c owning entries
    [c share, (c + 1) share), the first `held` of them (at most 2^15) kept in
    shared memory (csrc/denoise_update.cu)."""
    if not (is_power_of_2(M) and CLUSTER_MIN_M <= M <= MAX_M):
        raise ValueError(f"the cluster route takes M a power of two in [2^16, 2^22], "
                         f"not {M}")
    C = min(M >> SHARE_LOG, CLUSTER_MAX)
    return C, M // C, min(M // C, 1 << HELD_LOG)


def fused_denoise_update_ref(beta: torch.Tensor, azo: torch.Tensor,
                             tau_sec: torch.Tensor, M: int,
                             stopped: torch.Tensor | None = None,
                             s_prev: torch.Tensor | None = None,
                             out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """The plain version. beta, azo: (..., L*M); tau_sec: (..., L).
    Returns s, beta_new (..., L*M) and sec_en (..., L).

    stopped: (...,) bool, the codewords that have stopped, with s_prev
    (..., L*M) their last s: there s is s_prev, beta_new is beta and sec_en
    sums beta's squares. out: (s, beta_new) buffers to write and return."""
    shape = beta.shape
    sec = shape[:-1] + (tau_sec.shape[-1], M)
    tau = tau_sec[..., None]
    s = beta.reshape(sec) + tau * azo.reshape(sec)
    p = torch.softmax(s / tau, dim=-1)
    s, en, p = s.reshape(shape), (p * p).sum(-1), p.reshape(shape)
    if stopped is not None:
        keep = stopped[..., None]
        s = torch.where(keep, s_prev, s)
        en = torch.where(keep, (beta.reshape(sec) * beta.reshape(sec)).sum(-1), en)
        p = torch.where(keep, beta, p)
    if out is not None:
        s, p = out[0].copy_(s), out[1].copy_(p)
    return s, p, en


def _check_freeze(beta, tau_sec, stopped, s_prev, out) -> None:
    """The freeze's arguments against beta and tau_sec, on every device."""
    if (stopped is None) != (s_prev is None):
        raise ValueError("stopped and s_prev come together")
    if stopped is not None and (stopped.dtype != torch.bool
                                or stopped.shape != tau_sec.shape[:-1]
                                or s_prev.shape != beta.shape):
        raise ValueError(f"stopped must be bool of shape {tuple(tau_sec.shape[:-1])} "
                         f"and s_prev of shape {tuple(beta.shape)}")
    if out is not None and (len(out) != 2 or any(o.shape != beta.shape for o in out)):
        raise ValueError(f"out must be two buffers of shape {tuple(beta.shape)}")


def _check(beta, azo, tau_sec, M, stopped=None, s_prev=None, out=()) -> None:
    L = tau_sec.shape[-1]
    reads = (beta, azo) + ((s_prev,) if stopped is not None else ())
    tensors = reads + (tau_sec, *out)
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != beta.device for t in tensors) or (
               stopped is not None and (not stopped.is_contiguous()
                                        or stopped.device != beta.device)):
        raise ValueError("beta, azo, tau_sec, s_prev and out must be contiguous "
                         "float32 tensors on one device, stopped beside them")
    if out and beta.numel() and (out[0].data_ptr() == out[1].data_ptr() or any(
            o.data_ptr() == r.data_ptr() for o in out for r in reads)):
        raise ValueError("out must be two buffers apart from beta, azo and s_prev")
    if azo.shape != beta.shape or beta.shape != tau_sec.shape[:-1] + (L * M,):
        raise ValueError(f"shapes {tuple(beta.shape)}, {tuple(azo.shape)}, "
                         f"{tuple(tau_sec.shape)} do not fit M={M}")
    if not fused_eligible(M, 1, False):
        raise ValueError(f"M={M} is not a power of two in [{MIN_M}, 2^22]")


def fused_denoise_update(beta: torch.Tensor, azo: torch.Tensor,
                         tau_sec: torch.Tensor, M: int, route: str | None = None,
                         stopped: torch.Tensor | None = None,
                         s_prev: torch.Tensor | None = None,
                         out: tuple[torch.Tensor, torch.Tensor] | None = None):
    """One fused AMP tail step; shapes, `stopped`, `s_prev` and `out` as in
    `fused_denoise_update_ref`. route: None (`k3_route(M)`), "block" or
    "cluster" (M >= 2^16). The kernel reads `stopped` on the card; the host
    never does. On the card `out` may not be beta, azo or s_prev."""
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES} or None, not {route!r}")
    if route == "cluster":
        cluster_layout(M)
    _check_freeze(beta, tau_sec, stopped, s_prev, out)
    if beta.device.type == "cpu":
        return fused_denoise_update_ref(beta, azo, tau_sec, M, stopped, s_prev, out)
    if beta.device.type != "cuda":
        raise ValueError(f"no fused_denoise_update kernel for device {beta.device}")
    _check(beta, azo, tau_sec, M, stopped, s_prev, out or ())
    s, beta_new = out or (torch.empty_like(beta), torch.empty_like(beta))
    lib = _build.load()
    sec_en = torch.empty_like(tau_sec)
    if tau_sec.numel() == 0:
        return s, beta_new, sec_en
    status = lib.ldpc_denoise_update(
        beta.data_ptr(), azo.data_ptr(), tau_sec.data_ptr(), s.data_ptr(),
        beta_new.data_ptr(), sec_en.data_ptr(), tau_sec.numel(), M,
        {None: 0, "block": 1, "cluster": 2}[route],
        None if stopped is None else stopped.data_ptr(),
        None if stopped is None else s_prev.data_ptr(), tau_sec.shape[-1],
        torch.cuda.current_stream(beta.device).cuda_stream)
    _build.check(status, "fused_denoise_update")
    count("k3.launches")
    if stopped is not None:
        count("k3.freeze_launches")
    return s, beta_new, sec_en
