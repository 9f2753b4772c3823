"""Bit / message-vector / PSK codecs.

Counterpart of `ldpc_sparc_tpu/utils/bits.py`. Bits within a section index
are MSB first, and the message vector has exactly one nonzero per M-entry
section. A modulated code (K > 1) carries log2(K) Gray-coded PSK value bits
after each section's log2(M) location bits. Every tensor function takes
leading batch dimensions: bits are (..., L*log2(K*M)) and message vectors
(..., L*M).

The Gray code and constellation helpers are numpy copies of the JAX
package's (that module imports JAX). Their tables are complex128 or float64;
the JAX package runs them as complex64 / float32 (x64 off), so the tensor
functions cast them explicitly to those types.
"""

from __future__ import annotations

import numpy as np
import torch


# --------------------------------------------------------------------------
# Gray code and PSK constellations (numpy)
# --------------------------------------------------------------------------

def bin2gray(num: np.ndarray) -> np.ndarray:
    return num ^ (num >> 1)


def gray2bin(num: np.ndarray) -> np.ndarray:
    num = np.array(num, copy=True)
    mask = num >> 1
    while np.any(mask != 0):
        num = num ^ mask
        mask = mask >> 1
    return num


def psk_constel(K: int) -> np.ndarray:
    """K-PSK constellation: K=1 {1}, K=2 real {1, -1}, K>=4 complex on the
    unit circle with the K=4 points exactly on the axes."""
    if K == 1:
        return np.array([1.0])
    if K == 2:
        return np.array([1.0, -1.0])
    if K == 4:
        return np.array([1 + 0j, 0 + 1j, -1 + 0j, 0 - 1j])
    theta = 2 * np.pi * np.arange(K) / K
    return np.cos(theta) + 1j * np.sin(theta)


def psk_mod_table(K: int) -> np.ndarray:
    """Value-bits integer b -> constellation symbol c[gray2bin(b)]."""
    return psk_constel(K)[gray2bin(np.arange(K))]


def psk_demod_table(K: int) -> np.ndarray:
    """Constellation index k -> value-bits integer bin2gray(k)."""
    return bin2gray(np.arange(K))


def _as_tensor(table: np.ndarray, K: int, device) -> torch.Tensor:
    """A constellation table as the JAX package computes with it: float32
    for K <= 2, complex64 above."""
    return torch.tensor(table.astype(np.complex64 if K > 2 else np.float32),
                        device=device)


def constel_tensor(K: int, device=None) -> torch.Tensor:
    """psk_constel(K) on `device`, float32 for K <= 2, complex64 above."""
    return _as_tensor(psk_constel(K), K, device)


# --------------------------------------------------------------------------
# bits <-> integers (sectionwise, MSB first)
# --------------------------------------------------------------------------

def bits_to_ints(bits: torch.Tensor, width: int) -> torch.Tensor:
    """(..., width) {0,1} -> (...,) int64, MSB first."""
    weights = 1 << torch.arange(width - 1, -1, -1, device=bits.device)
    return (bits.to(torch.int64) * weights).sum(-1)


def ints_to_bits(idx: torch.Tensor, width: int) -> torch.Tensor:
    """(...,) integer -> (..., width) {0,1}, MSB first."""
    shifts = torch.arange(width - 1, -1, -1, device=idx.device)
    return (idx[..., None] >> shifts) & 1


# --------------------------------------------------------------------------
# bits <-> message vector
# --------------------------------------------------------------------------

def bits_to_msg_vector(bits: torch.Tensor, M: int, K: int = 1,
                       amplitude: float = 1.0) -> torch.Tensor:
    """(..., L*log2(K*M)) bits -> (..., L*M) message vector whose section l
    holds `amplitude` times its PSK symbol at the location its first
    log2(M) bits spell; the symbol is c[gray2bin(b)] for the value bits b.
    float32 for K <= 2, complex64 above."""
    logM, logK = M.bit_length() - 1, K.bit_length() - 1
    sec_size = logM + logK
    if bits.shape[-1] % sec_size:
        raise ValueError(f"bit length {bits.shape[-1]} is not a multiple of {sec_size}")
    L = bits.shape[-1] // sec_size
    secs = bits.reshape(bits.shape[:-1] + (L, sec_size))
    idx = bits_to_ints(secs[..., :logM], logM)
    if K == 1:
        vals = torch.full(idx.shape, amplitude, dtype=torch.float32,
                          device=bits.device)
    else:
        table = _as_tensor(psk_mod_table(K), K, bits.device)
        vals = table[bits_to_ints(secs[..., logM:], logK)] * amplitude
    out = torch.zeros(bits.shape[:-1] + (L, M), dtype=vals.dtype,
                      device=bits.device)
    out.scatter_(-1, idx[..., None], vals[..., None])
    return out.reshape(bits.shape[:-1] + (L * M,))


def msg_vector_to_bits(msg_vector: torch.Tensor, M: int, K: int = 1) -> torch.Tensor:
    """(..., L*M) message vector -> (..., L*log2(K*M)) bool bits: the
    location of each section's largest |entry| (the first one on ties), then
    for K > 1 the Gray bits of the constellation point nearest that entry,
    argmax_k Re(v conj(c_k)) / max(|v|, 1e-30) (the first one on ties), so
    the entry may carry an amplitude."""
    logM, logK = M.bit_length() - 1, K.bit_length() - 1
    if msg_vector.shape[-1] % M:
        raise ValueError(f"length {msg_vector.shape[-1]} is not a multiple of M={M}")
    L = msg_vector.shape[-1] // M
    secs = msg_vector.reshape(msg_vector.shape[:-1] + (L, M))
    idx = torch.argmax(secs.abs(), dim=-1)
    bits = ints_to_bits(idx, logM)
    if K > 1:
        v = secs.gather(-1, idx[..., None])                    # (..., L, 1)
        c = constel_tensor(K, msg_vector.device)
        score = (v * c.conj()).real
        k = torch.argmax(score / v.abs().clamp_min(1e-30), dim=-1)
        demod = torch.as_tensor(psk_demod_table(K), device=msg_vector.device)
        bits = torch.cat([bits, ints_to_bits(demod[k], logK)], dim=-1)
    return bits.reshape(msg_vector.shape[:-1] + (L * (logM + logK),)).to(torch.bool)


def random_bits(gen: torch.Generator, length: int) -> torch.Tensor:
    """`length` uniform random bits (bool) on the generator's device."""
    return torch.randint(0, 2, (length,), generator=gen,
                         device=gen.device).to(torch.bool)


def random_msg_vector(gen: torch.Generator, L: int, M: int, K: int = 1) -> torch.Tensor:
    """A random valid message vector of L sections: the message vector of
    L*log2(K*M) bits drawn from `gen`."""
    logM, logK = M.bit_length() - 1, K.bit_length() - 1
    return bits_to_msg_vector(random_bits(gen, L * (logM + logK)), M, K)
