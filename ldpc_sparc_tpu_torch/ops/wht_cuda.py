"""Signed FWHT: the hand-written Hopper kernels and their plain versions.

`fwht_signed` replaces `ldpc_sparc_tpu/ops/wht_pallas.py::fwht_signed`
in its default mode (the `_ms_kernel` Pallas kernel, K1), and
`fwht_signed_2mm` the same function in mode "2mm" (the `_kernel` Pallas
kernel, K2). Over rows of an (R, w) float32 array:

    apply_pre=True : y = FWHT(x * s)   (forward design product)
    apply_pre=False: y = FWHT(x) * s   (adjoint design product)
    signs=None     : y = FWHT(x)

with s = signs[r % E] for row r, so an (E, w) sign plane serves a batch of
codewords laid out (B, E). The signs are +1 or -1: from 2^13 up K1 keeps
only their sign bits. The block scale is not applied here.

K1 keeps a row on chip from its one read to its one write, by a route
that is a fixed function of the width (`fwht_route`; `csrc/fwht_signed.cu`
says how each works):

    log2 w    route        a row is held by
    0 - 15    "block"      one block's shared memory
    16 - 19   "cluster"    a cluster of w / 2^15 blocks (2, 4, 8, 16)
    20 - 22   "two_pass"   nothing: it crosses device memory twice

`fwht_signed(..., route=...)` runs one route explicitly ("two_pass" takes
2^10 to 2^22); a route that cannot take the width raises. The table is the
faster route at every width as measured on an H100 (PERF.md).

`srht_scatter_fwht` and `srht_fwht_gather` are the two SRHT design
products with the index side folded into K1 (the same table): the adjoint scatters the k
values of a row into the zeroed tile on chip in place of reading a
zero-filled (R, w) array, and the forward product writes only the k
indexed outputs in place of an (R, w) array that a gather then reads.
Their plain versions are the zero fill, `scatter_`, transform and
`gather` composition.

On a CUDA tensor the kernel (`csrc/fwht_signed.cu`, `csrc/fwht_2mm.cu`)
runs, or the call raises; on a CPU tensor the plain version runs.
`LAUNCHES` counts K1's launches, the two fused entry points included, and
`LAUNCHES_2MM` K2's (one per call, however many passes a kernel takes).

K1 is float32 throughout. K2 is the two-sided form H_a . X . H_b on the
(a, b) view of each row with bf16 operands and float32 accumulation, the
TPU kernel's default operand type, so it is a different computation: its
plain version `fwht_signed_2mm_ref` rounds where the kernel does. K2's
kernel and layout are a fixed function of the width too (`k2_layout`;
`csrc/fwht_2mm.cu` says how each works):

    log2 w    kernel   layout   the row's intermediate T
    8 - 11    "mma"    "tile"   stays in shared memory, one launch
    12 - 15   "wgmma"  "tile"   stays in shared memory, one launch
    16 - 20   "wgmma"  "wide"   crosses device memory in bf16, two launches

`fwht_signed_2mm(..., kernel="mma")` runs the `mma.sync` kernel up to 2^15
(the yardstick the `wgmma` tile kernel was measured against). The
kernels take bf16 operands only: `mm_dtype="float32"` runs the plain
version on a CPU tensor and raises `NotImplementedError` on a CUDA one.
"""

from __future__ import annotations

import torch

from .. import _build
from .wht import fwht, hadamard_factor

MAX_LOG_W = 22  # two passes: 2^12 along the rows, 2^10 along the columns
ROUTES = ("block", "cluster", "two_pass")
# log2 widths each K1 route takes (inclusive)
ROUTE_LOG_W = {"block": (0, 15), "cluster": (16, 19), "two_pass": (10, 22)}
SEG_LOG_W = 15  # the cluster route's segment: one block holds 2^15 floats
# K2's widths: a >= 16 fills an mma tile; 2^20 is the TPU kernel's bound
MIN_LOG_W_2MM, MAX_LOG_W_2MM = 8, 20
TILE_MAX_LOG_W_2MM = 15   # above, K2's intermediate crosses device memory
K2_KERNELS = ("mma", "wgmma")
WGMMA_MIN_LOG_W = 12      # a = b = 64: one 64-row wgmma tile of each factor
MM_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

LAUNCHES = 0
LAUNCHES_2MM = 0


def fwht_route(log_w: int) -> tuple[str, int]:
    """The route K1 takes at width 2^log_w and the number of blocks that
    hold one row (1 unless the route is "cluster")."""
    if not 0 <= log_w <= MAX_LOG_W:
        raise ValueError(f"no K1 route for width 2^{log_w}")
    if log_w <= ROUTE_LOG_W["block"][1]:
        return "block", 1
    if log_w <= ROUTE_LOG_W["cluster"][1]:
        return "cluster", 1 << (log_w - SEG_LOG_W)
    return "two_pass", 1


def _route_code(route: str | None, log_w: int, fused: bool = False) -> int:
    """The kernel library's code of `route` (None: the table's), after
    checking that the route takes the width."""
    if route is None:
        route = fwht_route(log_w)[0]
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    lo, hi = ROUTE_LOG_W[route]
    if not lo <= log_w <= hi:
        raise ValueError(f"route {route!r} takes widths 2^{lo} to 2^{hi}, "
                         f"not 2^{log_w}")
    if fused and route == "two_pass":
        raise ValueError("the fused SRHT products keep the row on chip: no "
                         "'two_pass' route")
    return ROUTES.index(route)


def _fused_route_code(route: str | None, log_w: int) -> int | None:
    """The route code of a fused SRHT product, or None where the table sends
    the width to "two_pass" and the product is composed around it."""
    if route is None and fwht_route(log_w)[0] == "two_pass":
        return None
    return _route_code(route, log_w, fused=True)


def fwht_signed_ref(x: torch.Tensor, signs: torch.Tensor | None,
                    apply_pre: bool) -> torch.Tensor:
    """The plain version: the torch Kronecker chain of `ops/wht.py`."""
    if signs is None:
        return fwht(x)
    R, w = x.shape
    xb = x.reshape(R // signs.shape[0], signs.shape[0], w)
    y = fwht(xb * signs) if apply_pre else fwht(xb) * signs
    return y.reshape(R, w)


def _check_width(w: int) -> None:
    if w & (w - 1) or not 1 <= w <= 1 << MAX_LOG_W:
        raise ValueError(f"width {w} is not a power of two in [1, 2^{MAX_LOG_W}]")


def _check_signs(signs: torch.Tensor | None, rows: int, w: int, device) -> None:
    if signs is None:
        return
    if (signs.dim() != 2 or signs.shape[1] != w or signs.dtype != torch.float32
            or not signs.is_contiguous() or signs.device != device):
        raise ValueError(f"signs must be a contiguous float32 (E, {w}) "
                         f"tensor on {device}")
    if signs.data_ptr() % 16:
        raise ValueError("signs must start on a 16-byte boundary (the kernel "
                         "loads float4)")
    if rows % signs.shape[0]:
        raise ValueError(f"{rows} rows do not split into {signs.shape[0]} "
                         f"sign rows")


def _check(x: torch.Tensor, signs: torch.Tensor | None) -> None:
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel "
                         "loads float4)")
    _check_width(x.shape[1])
    _check_signs(signs, x.shape[0], x.shape[1], x.device)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fwht_signed(x: torch.Tensor, signs: torch.Tensor | None,
                apply_pre: bool, route: str | None = None) -> torch.Tensor:
    """Signed FWHT of each row of x (R, w); see the module docstring.
    route: None takes `fwht_route`'s; "block", "cluster" or "two_pass"
    runs that route or raises if it cannot take the width."""
    global LAUNCHES
    if x.device.type == "cpu":
        if route is not None and x.dim() == 2:
            _check_width(x.shape[1])
            _route_code(route, x.shape[1].bit_length() - 1)
        return fwht_signed_ref(x, signs, apply_pre)
    if x.device.type != "cuda":
        raise ValueError(f"no fwht_signed kernel for device {x.device}")
    _check(x, signs)
    log_w = x.shape[1].bit_length() - 1
    code = _route_code(route, log_w)
    lib = _build.load()
    y = torch.empty_like(x)
    if x.shape[0] == 0:
        return y
    E = 1 if signs is None else signs.shape[0]
    status = lib.ldpc_fwht_signed(
        x.data_ptr(), None if signs is None else signs.data_ptr(), y.data_ptr(),
        x.shape[0], log_w, E, int(apply_pre), code, _stream(x))
    _build.check(status, "fwht_signed")
    LAUNCHES += 1
    return y


def active_clusters(log_w: int) -> int:
    """How many clusters of the "cluster" route's kernel the card holds at
    once at width 2^log_w (each is w / 2^15 blocks, one a multiprocessor)."""
    _route_code("cluster", log_w)
    n = _build.load().ldpc_fwht_active_clusters(log_w)
    if n < 0:
        _build.check(-n, "fwht_signed active_clusters")
    return n


# ---- the SRHT products with the index side folded into K1 --------------------

def _check_idx(idx: torch.Tensor, rows: int, k: int, w: int, device,
               signs: torch.Tensor | None, validate: bool) -> None:
    if (idx.dim() != 2 or idx.dtype not in (torch.int32, torch.int64)
            or not idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous 2-D int32 or int64 tensor, "
                         f"got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != device:
        raise ValueError(f"idx lies on {idx.device}, the values on {device}")
    E = idx.shape[0]
    if idx.shape[1] != k or E == 0 or rows % E:
        raise ValueError(f"idx {tuple(idx.shape)} does not index {rows} rows of "
                         f"{k} values")
    if signs is not None and signs.shape[0] != E:
        raise ValueError(f"{signs.shape[0]} sign rows for {E} index rows")
    if validate and idx.numel() and not (int(idx.min()) >= 0 and int(idx.max()) < w):
        raise ValueError(f"idx has entries outside [0, {w})")


def _check_small(v: torch.Tensor, name: str) -> None:
    if v.dim() != 2 or v.dtype != torch.float32 or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D float32 tensor, got "
                         f"{tuple(v.shape)} {v.dtype}")


def srht_scatter_fwht_ref(vals: torch.Tensor, idx: torch.Tensor,
                          signs: torch.Tensor | None, w: int,
                          apply_pre: bool = False,
                          transform=fwht_signed_ref) -> torch.Tensor:
    """The plain version: a zero-filled (R, w) array, `scatter_` of the k
    values of row r at idx[r % E], then the signed transform."""
    R, k = vals.shape
    E = idx.shape[0]
    X = torch.zeros(R // E, E, w, dtype=vals.dtype, device=vals.device)
    X.scatter_(-1, idx.long().expand(R // E, E, -1), vals.reshape(R // E, E, k))
    return transform(X.reshape(R, w), signs, apply_pre=apply_pre)


def srht_fwht_gather_ref(x: torch.Tensor, signs: torch.Tensor | None,
                         idx: torch.Tensor, apply_pre: bool = True,
                         transform=fwht_signed_ref) -> torch.Tensor:
    """The plain version: the signed transform of all of (R, w), then a
    `gather` of the k entries at idx[r % E] of row r."""
    R, w = x.shape
    E, k = idx.shape
    Y = transform(x, signs, apply_pre=apply_pre).reshape(R // E, E, w)
    return Y.gather(-1, idx.long().expand(R // E, E, -1)).reshape(R, k)


def srht_scatter_fwht(vals: torch.Tensor, idx: torch.Tensor,
                      signs: torch.Tensor | None, w: int,
                      apply_pre: bool = False, route: str | None = None,
                      validate: bool = True) -> torch.Tensor:
    """The adjoint SRHT product: row r of the (R, w) result is the signed
    FWHT of the zero row that holds vals[r, j] at idx[r % E, j].

    vals (R, k) float32; idx (E, k) int32 or int64 with entries in [0, w),
    no entry twice in a row; signs (E, w) or None. On a CUDA tensor one
    K1 launch ("block" or "cluster" route) zeroes and fills the tile on
    chip; widths above 2^19 zero-fill and scatter in device memory around
    the "two_pass" transform. validate=False skips the
    range check of idx (a device synchronisation) for an index set checked
    before, as `SparcDesign` checks its own when it is built."""
    global LAUNCHES
    _check_small(vals, "vals")
    _check_width(w)
    R, k = vals.shape
    _check_signs(signs, R, w, vals.device)
    _check_idx(idx, R, k, w, vals.device, signs, validate)
    code = _fused_route_code(route, w.bit_length() - 1)
    if vals.device.type == "cpu":
        return srht_scatter_fwht_ref(vals, idx, signs, w, apply_pre)
    if vals.device.type != "cuda":
        raise ValueError(f"no srht_scatter_fwht kernel for device {vals.device}")
    if code is None:
        return srht_scatter_fwht_ref(vals, idx, signs, w, apply_pre, fwht_signed)
    lib = _build.load()
    y = torch.empty(R, w, dtype=torch.float32, device=vals.device)
    if R == 0:
        return y
    idx32 = idx if idx.dtype == torch.int32 else idx.to(torch.int32)
    status = lib.ldpc_srht_scatter_fwht(
        vals.data_ptr(), idx32.data_ptr(),
        None if signs is None else signs.data_ptr(), y.data_ptr(), R, k,
        w.bit_length() - 1, idx.shape[0], int(apply_pre), code, _stream(vals))
    _build.check(status, "srht_scatter_fwht")
    LAUNCHES += 1
    return y


def srht_fwht_gather(x: torch.Tensor, signs: torch.Tensor | None,
                     idx: torch.Tensor, apply_pre: bool = True,
                     route: str | None = None,
                     validate: bool = True) -> torch.Tensor:
    """The forward SRHT product: out[r, j] (R, k) is entry idx[r % E, j] of
    the signed FWHT of row r of x (R, w).

    idx (E, k) int32 or int64 with entries in [0, w); signs (E, w) or None.
    On a CUDA tensor one K1 launch ("block" or "cluster" route) leaves the
    transform in shared memory and writes only the k indexed outputs; widths
    above 2^19 gather from the "two_pass" transform's output. validate: as
    in `srht_scatter_fwht`."""
    global LAUNCHES
    if x.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"x and idx must be 2-D, got {tuple(x.shape)} and "
                         f"{tuple(idx.shape)}")
    _check(x, signs)
    R, w = x.shape
    k = idx.shape[1]
    _check_idx(idx, R, k, w, x.device, signs, validate)
    code = _fused_route_code(route, w.bit_length() - 1)
    if x.device.type == "cpu":
        return srht_fwht_gather_ref(x, signs, idx, apply_pre)
    if x.device.type != "cuda":
        raise ValueError(f"no srht_fwht_gather kernel for device {x.device}")
    if code is None:
        return srht_fwht_gather_ref(x, signs, idx, apply_pre, fwht_signed)
    lib = _build.load()
    out = torch.empty(R, k, dtype=torch.float32, device=x.device)
    if R == 0 or k == 0:
        return out
    idx32 = idx if idx.dtype == torch.int32 else idx.to(torch.int32)
    status = lib.ldpc_srht_fwht_gather(
        x.data_ptr(), None if signs is None else signs.data_ptr(),
        idx32.data_ptr(), out.data_ptr(), R, k, w.bit_length() - 1, idx.shape[0],
        int(apply_pre), code, _stream(x))
    _build.check(status, "srht_fwht_gather")
    LAUNCHES += 1
    return out


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


def k2_layout(log_w: int) -> tuple[str, str]:
    """(kernel, layout) K2 takes at width 2^log_w, a fixed table: the
    `mma.sync` kernel below 2^12, where a Hadamard factor is narrower than
    a 64-row `wgmma` tile, and the `wgmma` kernels from there up; layout
    "tile" (the row's intermediate stays on chip, one launch) up to 2^15
    and "wide" (it crosses device memory in bf16, two launches) above."""
    if not MIN_LOG_W_2MM <= log_w <= MAX_LOG_W_2MM:
        raise ValueError(f"no K2 kernel for width 2^{log_w}")
    return ("wgmma" if log_w >= WGMMA_MIN_LOG_W else "mma",
            "tile" if log_w <= TILE_MAX_LOG_W_2MM else "wide")


def _check_width_2mm(w: int) -> None:
    if w & (w - 1) or not 1 << MIN_LOG_W_2MM <= w <= 1 << MAX_LOG_W_2MM:
        raise ValueError(f"fwht_signed_2mm takes widths 2^{MIN_LOG_W_2MM} to "
                         f"2^{MAX_LOG_W_2MM}, got {w}")


def fwht_signed_2mm(x: torch.Tensor, signs: torch.Tensor | None,
                    apply_pre: bool, mm_dtype: str = "bfloat16",
                    kernel: str | None = None, passes: int = 3) -> torch.Tensor:
    """K2: the signed FWHT of each row of x (R, w) as two tensor-core
    products; see `fwht_signed_2mm_ref`. The kernels take bf16 operands
    only; the width must lie in [2^8, 2^20] on any device. kernel: None
    takes `k2_layout`'s, "mma" or "wgmma" runs that kernel or raises
    ("mma" takes up to 2^15, "wgmma" 2^12 and up). passes (timing only, "wide" layout): 1
    runs the first launch alone, 2 the second; the result is then not the
    transform."""
    global LAUNCHES_2MM
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be one of {sorted(MM_DTYPES)}")
    if kernel is not None and kernel not in K2_KERNELS:
        raise ValueError(f"kernel must be one of {K2_KERNELS} or None, got {kernel!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    _check_width_2mm(x.shape[1])
    log_w = x.shape[1].bit_length() - 1
    table_kernel, layout = k2_layout(log_w)
    if kernel is None:
        kernel = table_kernel
    if kernel == "wgmma" and log_w < WGMMA_MIN_LOG_W:
        raise ValueError(f"the wgmma kernel takes widths from 2^{WGMMA_MIN_LOG_W}, "
                         f"not 2^{log_w}")
    if kernel == "mma" and layout == "wide":
        raise ValueError(f"the mma kernel takes widths up to "
                         f"2^{TILE_MAX_LOG_W_2MM}, not 2^{log_w}")
    if passes not in (1, 2, 3) or (passes != 3 and layout != "wide"):
        raise ValueError("passes is 3, or 1 or 2 for a width above "
                         f"2^{TILE_MAX_LOG_W_2MM}")
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
    scratch = (torch.empty(R, w, dtype=torch.bfloat16, device=x.device)
               if layout == "wide" else None)
    E = 1 if signs is None else signs.shape[0]
    bits = (torch.empty(E, w // 32, dtype=torch.int32, device=x.device)
            if signs is not None and kernel != "mma" else None)
    status = lib.ldpc_fwht_2mm(
        x.data_ptr(), None if signs is None else signs.data_ptr(), y.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if bits is None else bits.data_ptr(), R, log_w, E,
        int(apply_pre), K2_KERNELS.index(kernel), passes, _stream(x))
    _build.check(status, "fwht_signed_2mm")
    LAUNCHES_2MM += 1
    return y
