"""Plain PyTorch fast Walsh-Hadamard transform: a Kronecker chain of matmuls.

Counterpart of `ldpc_sparc_tpu/ops/wht.py`. With the Sylvester Kronecker
factorisation H_w = H_f1 (x) H_f2 (x) ..., the transform of a (..., w) array
is one float32 `tensordot` per factor axis. This is the plain version that
the hand-written kernel (`ops/wht_cuda.py`) is held against, and the path
that CPU tensors take. On a card it needs float32 matmuls with TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False`), or its parity breaks.

The factorisation rule (`_factorize`, factors of at most 2^5 up to
w = 2^20 and 2^8 above) is the JAX package's, kept so that both packages
sum in the same order of stages; it was tuned for a TPU, not for this port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    """Sylvester-ordered n x n Hadamard matrix (n a power of two)."""
    assert n > 0 and (n & (n - 1)) == 0
    H = np.array([[1.0]], dtype=np.float32)
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


@functools.lru_cache(maxsize=None)
def hadamard_factor(n: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """H_n as a tensor, cached per (n, dtype, device) so that the chain does
    not copy it to the card on every call. Callers must not modify it."""
    return torch.as_tensor(_hadamard_np(n), dtype=dtype, device=device)


def _auto_max_log_factor(log_w: int) -> int:
    """The JAX package's width-dependent default largest factor."""
    return 5 if log_w <= 20 else 8


def _factorize(log_w: int, max_log_factor: int | None) -> list[int]:
    """Split log2(w) into near-equal chunks of at most max_log_factor
    (None = the width-dependent default)."""
    if max_log_factor is None:
        max_log_factor = _auto_max_log_factor(log_w)
    if log_w == 0:
        return [1]
    k = -(-log_w // max_log_factor)  # ceil
    base, rem = divmod(log_w, k)
    logs = [base + (1 if i < rem else 0) for i in range(k)]
    return [1 << g for g in logs]


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Walsh-Hadamard transform along the last axis (unnormalised,
    H H = w I). x: (..., w) with w a power of two; a complex x is
    transformed as its real and imaginary parts (H is real)."""
    w = x.shape[-1]
    if not (w > 0 and (w & (w - 1)) == 0):
        raise ValueError(f"FWHT length must be a power of two, got {w}")
    if x.is_complex():
        return torch.complex(fwht(x.real), fwht(x.imag))
    factors = _factorize(w.bit_length() - 1, None)
    batch = tuple(x.shape[:-1])
    y = x.reshape(batch + tuple(factors))
    nb = len(batch)
    for i, f in enumerate(factors):
        H = hadamard_factor(f, x.dtype, x.device)
        axis = nb + i
        # contract the factor axis with H (symmetric), put the result back
        y = torch.movedim(torch.tensordot(y, H, dims=([axis], [0])), -1, axis)
    return y.reshape(batch + (w,))


def fwht_matrix_row(w: int, r: int) -> np.ndarray:
    """Row r of the Sylvester Hadamard H_w: H_w[r, c] = (-1)^popcount(r & c)."""
    v = np.bitwise_and(np.uint64(r), np.arange(w, dtype=np.uint64))
    parity = np.zeros(w, dtype=np.uint64)
    while np.any(v):
        parity ^= v & np.uint64(1)
        v >>= np.uint64(1)
    return np.where(parity == 0, 1.0, -1.0)
