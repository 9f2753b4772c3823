"""Error-rate metrics (counterpart of `ldpc_sparc_tpu/utils/metrics.py`)."""

from __future__ import annotations

import torch


def bit_error_rate(bits_in: torch.Tensor, bits_out: torch.Tensor) -> torch.Tensor:
    """Fraction of differing bits along the last axis."""
    if bits_in.shape != bits_out.shape:
        raise ValueError(f"shapes differ: {bits_in.shape} vs {bits_out.shape}")
    return (bits_in.to(torch.int32) != bits_out.to(torch.int32)).to(
        torch.float32).mean(-1)


def section_errors(beta0: torch.Tensor, beta: torch.Tensor, L: int):
    """Per-section error indicators (..., L) and the section error rate."""
    M = beta0.shape[-1] // L
    b0 = beta0.reshape(beta0.shape[:-1] + (L, M))
    b = beta.reshape(beta.shape[:-1] + (L, M))
    err = (b0 != b).any(-1)
    return err, err.to(torch.float32).mean(-1)


def location_value_errors(beta0: torch.Tensor, beta: torch.Tensor, L: int):
    """Location / value / section error rates of modulated codes.

    Per section: the location error compares the argmax |.| positions, the
    value error the entries at those positions (whether or not the
    locations matched, as the JAX package does), and a section is in error
    if either is. Returns ((ler, ver, ser), (loc_err, val_err, sec_err))
    with the (..., L) indicators."""
    M = beta0.shape[-1] // L
    b0 = beta0.reshape(beta0.shape[:-1] + (L, M))
    b = beta.reshape(beta.shape[:-1] + (L, M))
    i0 = torch.argmax(b0.abs(), dim=-1, keepdim=True)
    i1 = torch.argmax(b.abs(), dim=-1, keepdim=True)
    loc_err = (i0 != i1)[..., 0]
    val_err = (b0.gather(-1, i0) != b.gather(-1, i1))[..., 0]
    sec_err = loc_err | val_err
    rates = tuple(e.to(torch.float32).mean(-1) for e in (loc_err, val_err, sec_err))
    return rates, (loc_err, val_err, sec_err)
