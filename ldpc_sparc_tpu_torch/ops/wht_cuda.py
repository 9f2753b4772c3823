"""Signed FWHT: the hand-written Hopper kernels and their plain versions.

`fwht_signed` replaces `ldpc_sparc_tpu/ops/wht_pallas.py::fwht_signed`
in its default mode (the `_ms_kernel` Pallas kernel, K1), and
`fwht_signed_2mm` the same function in mode "2mm" (the `_kernel` Pallas
kernel, K2). Over rows of an (R, w) float32 array:

    apply_pre=True : y = FWHT(x * s)   (forward design product)
    apply_pre=False: y = FWHT(x) * s   (adjoint design product)
    signs=None     : y = FWHT(x)

with s = signs[r % E] for row r, so an (E, w) sign plane serves a batch of
codewords laid out (B, E). The block scale is not applied here.

On a CUDA tensor the kernel (`csrc/fwht_signed.cu`, `csrc/fwht_2mm.cu`)
runs, or the call raises; on a CPU tensor the plain version runs.
`LAUNCHES` and `LAUNCHES_2MM` count the kernels' launches (one per call,
however many passes a kernel takes).

K1 is float32 throughout. K2 is the two-sided form H_a . X . H_b on the
(a, b) view of each row with bf16 operands and float32 accumulation, the
TPU kernel's default operand type, so it is a different computation: its
plain version `fwht_signed_2mm_ref` rounds where the kernel does.
"""

from __future__ import annotations

import torch

from .. import _build
from .wht import fwht, hadamard_factor

MAX_LOG_W = 22  # two passes: 2^12 along the rows, 2^10 along the columns
# K2's widths: a >= 16 fills an mma tile; 2^20 is the TPU kernel's bound
MIN_LOG_W_2MM, MAX_LOG_W_2MM = 8, 20
TILE_MAX_LOG_W_2MM = 15   # above, K2's intermediate crosses device memory
MM_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

LAUNCHES = 0
LAUNCHES_2MM = 0


def fwht_signed_ref(x: torch.Tensor, signs: torch.Tensor | None,
                    apply_pre: bool) -> torch.Tensor:
    """The plain version: the torch Kronecker chain of `ops/wht.py`."""
    if signs is None:
        return fwht(x)
    R, w = x.shape
    xb = x.reshape(R // signs.shape[0], signs.shape[0], w)
    y = fwht(xb * signs) if apply_pre else fwht(xb) * signs
    return y.reshape(R, w)


def _check(x: torch.Tensor, signs: torch.Tensor | None) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.data_ptr() % 16 or (signs is not None and signs.data_ptr() % 16):
        raise ValueError("x and signs must start on a 16-byte boundary "
                         "(the kernel loads float4)")
    w = x.shape[1]
    if w & (w - 1) or not 1 <= w <= 1 << MAX_LOG_W:
        raise ValueError(f"width {w} is not a power of two in [1, 2^{MAX_LOG_W}]")
    if signs is not None:
        if (signs.dim() != 2 or signs.shape[1] != w or signs.dtype != torch.float32
                or not signs.is_contiguous() or signs.device != x.device):
            raise ValueError(f"signs must be a contiguous float32 (E, {w}) "
                             f"tensor on {x.device}")
        if x.shape[0] % signs.shape[0]:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{signs.shape[0]} sign rows")


def fwht_signed(x: torch.Tensor, signs: torch.Tensor | None,
                apply_pre: bool) -> torch.Tensor:
    """Signed FWHT of each row of x (R, w); see the module docstring."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fwht_signed_ref(x, signs, apply_pre)
    if x.device.type != "cuda":
        raise ValueError(f"no fwht_signed kernel for device {x.device}")
    _check(x, signs)
    lib = _build.load()
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    E = 1 if signs is None else signs.shape[0]
    status = lib.ldpc_fwht_signed(
        x.data_ptr(), None if signs is None else signs.data_ptr(), y.data_ptr(),
        x.shape[0], x.shape[1].bit_length() - 1, E, int(apply_pre),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "fwht_signed")
    LAUNCHES += 1
    return y


def split_ab(w: int) -> tuple[int, int]:
    """w = a * b with a <= b, both powers of two (a=512, b=1024 at 2^19)."""
    log_w = w.bit_length() - 1
    a = 1 << (log_w // 2)
    return a, w // a


def _round(v: torch.Tensor, mm: torch.dtype) -> torch.Tensor:
    return v if mm == torch.float32 else v.to(mm).to(torch.float32)


def fwht_signed_2mm_ref(x: torch.Tensor, signs: torch.Tensor | None,
                        apply_pre: bool, mm_dtype: str = "bfloat16") -> torch.Tensor:
    """The plain version of K2: on the (a, b) view X of each row,
    Y = H_a . round(round(X * S) . H_b) (apply_pre) or
    (H_a . round(round(X) . H_b)) * S, with round the cast to `mm_dtype`.
    The products run as float32 matmuls of the rounded operands (exact
    products, float32 sums), which is what bf16 operands with float32
    accumulation compute."""
    mm = MM_DTYPES[mm_dtype]
    R, w = x.shape
    a, b = split_ab(w)
    E = 1 if signs is None else signs.shape[0]
    xv = x.reshape(R // E, E, a, b)
    sv = None if signs is None else signs.reshape(E, a, b)
    if sv is not None and apply_pre:
        xv = xv * sv
    ha = hadamard_factor(a, torch.float32, x.device)
    hb = hadamard_factor(b, torch.float32, x.device)
    y = ha @ _round(_round(xv, mm) @ hb, mm)
    if sv is not None and not apply_pre:
        y = y * sv
    return y.reshape(R, w)


def _check_width_2mm(w: int) -> None:
    if w & (w - 1) or not 1 << MIN_LOG_W_2MM <= w <= 1 << MAX_LOG_W_2MM:
        raise ValueError(f"fwht_signed_2mm takes widths 2^{MIN_LOG_W_2MM} to "
                         f"2^{MAX_LOG_W_2MM}, got {w}")


def fwht_signed_2mm(x: torch.Tensor, signs: torch.Tensor | None,
                    apply_pre: bool, mm_dtype: str = "bfloat16") -> torch.Tensor:
    """K2: the signed FWHT of each row of x (R, w) as two tensor-core
    products; see `fwht_signed_2mm_ref`. The kernel takes bf16 operands
    only; the width must lie in [2^8, 2^20] on any device."""
    global LAUNCHES_2MM
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be one of {sorted(MM_DTYPES)}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    _check_width_2mm(x.shape[1])
    if x.device.type == "cpu":
        return fwht_signed_2mm_ref(x, signs, apply_pre, mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no fwht_signed_2mm kernel for device {x.device}")
    if mm_dtype != "bfloat16":
        raise NotImplementedError("the K2 kernel takes bf16 operands only")
    _check(x, signs)
    lib = _build.load()
    R, w = x.shape
    y = torch.empty_like(x)
    if R == 0:
        return y
    log_w = w.bit_length() - 1
    scratch = (torch.empty(R, w, dtype=torch.bfloat16, device=x.device)
               if log_w > TILE_MAX_LOG_W_2MM else None)
    E = 1 if signs is None else signs.shape[0]
    status = lib.ldpc_fwht_2mm(
        x.data_ptr(), None if signs is None else signs.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(), R, log_w, E,
        int(apply_pre), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "fwht_signed_2mm")
    LAUNCHES_2MM += 1
    return y
