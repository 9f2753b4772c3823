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

`srht_fwht_gather_blocks` and `srht_scatter_fwht_sum` are the same two
products for a design of E blocks whose window side is Lw window blocks
("block" route only, w <= 2^15), with the window side addressed by a
segment table (`ptr`, `blocks`): the forward product reads each block's
input from its window block by index (the select folded into the load),
and the adjoint adds the blocks of each window block in the table's order
as it stores (the segment sum folded into the store, no float atomics).
Their plain versions are `index_select` before, and an in-order sum after,
the fused products' plain versions.

On a CUDA tensor the kernel (`csrc/fwht_signed.cu`, `csrc/fwht_2mm.cu`)
runs, or the call raises; on a CPU tensor the plain version runs.
The counter `k1.launches` (`utils/tracing.py`) counts K1's launches, the
fused entry points included, `k1.block_products` those of the two
block-indexed products, and `k2.launches` K2's (one per call, however many
passes a kernel takes).

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
(the yardstick the `wgmma` tile kernel was measured against).

`mm_dtype="float32"` is the TPU kernel's float32 operand type: T = X . H_b
stays float32 and no operand is rounded. Each float32 operand runs as three
bf16 planes whose sum is exact, accumulated lo, mid, hi into float32; its
own table (`k2_layout(log_w, "float32")`):

    log2 w    kernel   layout    the row's intermediate T
    8 - 11    "mma"    "passes"  crosses device memory in float32, two launches
    12 - 15   "wgmma"  "tile"    stays on chip, one launch
    16 - 20   "wgmma"  "wide"    crosses device memory in float32, two launches

The "mma" pass kernels (H_b along the rows, then H_a along the columns in
place) take every width, by name with `kernel="mma"`: they are the
yardstick the `wgmma` kernels are timed against. Its plain version is
`fwht_signed_2mm_ref(..., "float32")`, two float32 matmuls; the two differ
only in the order of their float32 sums.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.tracing import count
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
    count("k1.launches")
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
    count("k1.launches")
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
    count("k1.launches")
    return out


# ---- the block-indexed products: the window side's select and sum in K1 -------

def _check_segments(ptr: torch.Tensor, blocks: torch.Tensor, Lw: int, E: int,
                    device, validate: bool) -> None:
    for t, n, name in ((ptr, Lw + 1, "ptr"), (blocks, E, "blocks")):
        if (t.dim() != 1 or t.shape[0] != n or t.dtype != torch.int32
                or not t.is_contiguous() or t.device != device):
            raise ValueError(f"{name} must be a contiguous int32 ({n},) tensor "
                             f"on {device}")
    if validate:
        p = ptr.long()
        if (int(p[0]) != 0 or int(p[-1]) != E or bool((p[1:] < p[:-1]).any())
                or not torch.equal(blocks.long().sort().values,
                                   torch.arange(E, device=device))):
            raise ValueError("ptr and blocks are not a segment table of "
                             f"{E} blocks in {Lw} segments")


def _window_blocks(ptr: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """(E,) int64: the window block of each of the table's blocks."""
    counts = (ptr[1:] - ptr[:-1]).long()
    win = torch.empty(blocks.shape[0], dtype=torch.int64, device=blocks.device)
    win[blocks.long()] = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=blocks.device), counts)
    return win


def srht_fwht_gather_blocks_ref(x: torch.Tensor, signs: torch.Tensor | None,
                                idx: torch.Tensor, ptr: torch.Tensor,
                                blocks: torch.Tensor) -> torch.Tensor:
    """The plain version: an `index_select` of each block's window block, then
    `srht_fwht_gather_ref`."""
    B, _, w = x.shape
    E, k = idx.shape
    xs = x.index_select(1, _window_blocks(ptr, blocks)).reshape(B * E, w)
    return srht_fwht_gather_ref(xs, signs, idx).reshape(B, E, k)


def srht_scatter_fwht_sum_ref(vals: torch.Tensor, idx: torch.Tensor,
                              signs: torch.Tensor | None, w: int,
                              ptr: torch.Tensor,
                              blocks: torch.Tensor) -> torch.Tensor:
    """The plain version: `srht_scatter_fwht_ref` of every block, then each
    window block's parts added in the table's order."""
    B, E, k = vals.shape
    parts = srht_scatter_fwht_ref(vals.reshape(B * E, k), idx, signs,
                                  w).reshape(B, E, w)
    p, bl = ptr.tolist(), blocks.tolist()
    out = parts.new_zeros(B, len(p) - 1, w)
    for s in range(len(p) - 1):
        for e in bl[p[s]:p[s + 1]]:
            out[:, s] += parts[:, e]
    return out


def srht_fwht_gather_blocks(x: torch.Tensor, signs: torch.Tensor | None,
                            idx: torch.Tensor, ptr: torch.Tensor,
                            blocks: torch.Tensor,
                            validate: bool = True) -> torch.Tensor:
    """The forward SRHT product of E blocks that read Lw window blocks:
    out[b, e] (B, E, k) is entry idx[e, j] of FWHT(x[b, s] * signs[e])
    (x (B, Lw, w)), s the window block whose segment holds e.

    ptr (Lw + 1,) and blocks (E,) int32 are the segment table: segment s
    holds blocks[ptr[s]:ptr[s + 1]]. idx (E, k) int32 with entries in
    [0, w); signs (E, w) or None; w <= 2^15. On a CUDA tensor one K1 launch
    on the block route reads each block's input from x by its window block:
    no (B, E, w) copy of x exists. validate=False skips the checks of idx's
    range and of the table (device synchronisations) for a design that
    checked both when it was built."""
    if x.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"x must be 3-D and idx 2-D, got {tuple(x.shape)} and "
                         f"{tuple(idx.shape)}")
    B, Lw, w = x.shape
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _check(x.view(B * Lw, w), None)
    if w.bit_length() - 1 > ROUTE_LOG_W["block"][1]:
        raise ValueError(f"the block-indexed products take widths up to "
                         f"2^{ROUTE_LOG_W['block'][1]}, not {w}")
    E, k = idx.shape
    _check_signs(signs, E, w, x.device)
    _check_idx(idx, E, k, w, x.device, signs, validate)
    _check_segments(ptr, blocks, Lw, E, x.device, validate)
    if x.device.type == "cpu":
        return srht_fwht_gather_blocks_ref(x, signs, idx, ptr, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"no srht_fwht_gather_blocks kernel for device {x.device}")
    out = torch.empty(B, E, k, dtype=torch.float32, device=x.device)
    if B == 0 or k == 0:
        return out
    idx32 = idx if idx.dtype == torch.int32 else idx.to(torch.int32)
    status = _build.load().ldpc_srht_fwht_gather_blocks(
        x.data_ptr(), None if signs is None else signs.data_ptr(),
        idx32.data_ptr(), out.data_ptr(), B, k, w.bit_length() - 1, E, Lw,
        ptr.data_ptr(), blocks.data_ptr(), _stream(x))
    _build.check(status, "srht_fwht_gather_blocks")
    count("k1.launches")
    count("k1.block_products")
    return out


def srht_scatter_fwht_sum(vals: torch.Tensor, idx: torch.Tensor,
                          signs: torch.Tensor | None, w: int, ptr: torch.Tensor,
                          blocks: torch.Tensor,
                          validate: bool = True) -> torch.Tensor:
    """The adjoint SRHT product of E blocks summed into Lw window blocks:
    out[b, s] (B, Lw, w) is the sum, over the blocks e of segment s in the
    table's order, of FWHT(the zero row that holds vals[b, e, j] at
    idx[e, j]) * signs[e] (vals (B, E, k)).

    Arguments as in `srht_fwht_gather_blocks`. On a CUDA tensor one K1
    launch on the block route: a block owns out[b, s], stores the first
    block's transform and adds the others to it in order, so that no
    (B, E, w) array of parts exists, no float atomic adds, and two runs
    give the same bits."""
    _check_width(w)
    if vals.dim() != 3 or idx.dim() != 2:
        raise ValueError(f"vals must be 3-D and idx 2-D, got {tuple(vals.shape)} "
                         f"and {tuple(idx.shape)}")
    B, E, k = vals.shape
    if not vals.is_contiguous():
        raise ValueError("vals must be contiguous")
    _check_small(vals.view(B * E, k), "vals")
    if w.bit_length() - 1 > ROUTE_LOG_W["block"][1]:
        raise ValueError(f"the block-indexed products take widths up to "
                         f"2^{ROUTE_LOG_W['block'][1]}, not {w}")
    _check_signs(signs, E, w, vals.device)
    _check_idx(idx, E, k, w, vals.device, signs, validate)
    Lw = ptr.shape[0] - 1 if ptr.dim() == 1 else -1
    _check_segments(ptr, blocks, Lw, E, vals.device, validate)
    if vals.device.type == "cpu":
        return srht_scatter_fwht_sum_ref(vals, idx, signs, w, ptr, blocks)
    if vals.device.type != "cuda":
        raise ValueError(f"no srht_scatter_fwht_sum kernel for device {vals.device}")
    out = torch.empty(B, Lw, w, dtype=torch.float32, device=vals.device)
    if B == 0:
        return out
    idx32 = idx if idx.dtype == torch.int32 else idx.to(torch.int32)
    status = _build.load().ldpc_srht_scatter_fwht_sum(
        vals.data_ptr(), idx32.data_ptr(),
        None if signs is None else signs.data_ptr(), out.data_ptr(), B, k,
        w.bit_length() - 1, E, Lw, ptr.data_ptr(), blocks.data_ptr(),
        _stream(vals))
    _build.check(status, "srht_scatter_fwht_sum")
    count("k1.launches")
    count("k1.block_products")
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


def k2_layout(log_w: int, mm_dtype: str = "bfloat16") -> tuple[str, str]:
    """(kernel, layout) K2 takes at width 2^log_w, a fixed table: the
    `mma.sync` kernel below 2^12, where a Hadamard factor is narrower than
    a 64-row `wgmma` tile, and the `wgmma` kernels from there up; layout
    "tile" (the row's intermediate stays on chip, one launch) up to 2^15
    and "wide" (it crosses device memory, in bf16 or in float32 by the
    operand type, two launches) above. Below 2^12 float32 operands take
    the `mma.sync` pass kernels, layout "passes" (two launches, T through
    device memory in float32)."""
    if mm_dtype not in MM_DTYPES:
        raise ValueError(f"mm_dtype must be one of {sorted(MM_DTYPES)}")
    if not MIN_LOG_W_2MM <= log_w <= MAX_LOG_W_2MM:
        raise ValueError(f"no K2 kernel for width 2^{log_w}")
    if log_w < WGMMA_MIN_LOG_W:
        return "mma", "passes" if mm_dtype == "float32" else "tile"
    return "wgmma", "tile" if log_w <= TILE_MAX_LOG_W_2MM else "wide"


def _check_width_2mm(w: int) -> None:
    if w & (w - 1) or not 1 << MIN_LOG_W_2MM <= w <= 1 << MAX_LOG_W_2MM:
        raise ValueError(f"fwht_signed_2mm takes widths 2^{MIN_LOG_W_2MM} to "
                         f"2^{MAX_LOG_W_2MM}, got {w}")


def fwht_signed_2mm(x: torch.Tensor, signs: torch.Tensor | None,
                    apply_pre: bool, mm_dtype: str = "bfloat16",
                    kernel: str | None = None, passes: int = 3) -> torch.Tensor:
    """K2: the signed FWHT of each row of x (R, w) as two tensor-core
    products; see `fwht_signed_2mm_ref`. The width must lie in [2^8, 2^20]
    on any device. kernel: None takes `k2_layout`'s, "mma" or "wgmma" runs
    that kernel or raises ("wgmma" takes 2^12 and up; "mma" up to 2^15
    with bf16 operands, and with float32 operands the pass kernels at
    every width). passes (timing only; where a kernel makes two launches,
    the "wide" layout or the float32 pass kernels): 1 runs the first launch
    alone, 2 the second; the result is then not the transform."""
    if kernel is not None and kernel not in K2_KERNELS:
        raise ValueError(f"kernel must be one of {K2_KERNELS} or None, got {kernel!r}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got {tuple(x.shape)}")
    _check_width_2mm(x.shape[1])
    log_w = x.shape[1].bit_length() - 1
    f32 = mm_dtype == "float32"
    table_kernel, layout = k2_layout(log_w, mm_dtype)
    if kernel is None:
        kernel = table_kernel
    if kernel == "wgmma" and log_w < WGMMA_MIN_LOG_W:
        raise ValueError(f"the wgmma kernel takes widths from 2^{WGMMA_MIN_LOG_W}, "
                         f"not 2^{log_w}")
    if kernel == "mma" and f32:
        layout = "passes"
    elif kernel == "mma" and layout == "wide":
        raise ValueError(f"the mma kernel takes widths up to "
                         f"2^{TILE_MAX_LOG_W_2MM}, not 2^{log_w}")
    if passes not in (1, 2, 3) or (passes != 3 and layout == "tile"):
        raise ValueError("passes is 3, or 1 or 2 where the kernel makes two "
                         "launches (a width above 2^15, or float32 operands "
                         "through kernel 'mma')")
    if x.device.type == "cpu":
        return fwht_signed_2mm_ref(x, signs, apply_pre, mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no fwht_signed_2mm kernel for device {x.device}")
    _check(x, signs)
    lib = _build.load()
    R, w = x.shape
    y = torch.empty_like(x)
    if R == 0:
        return y
    E = 1 if signs is None else signs.shape[0]
    bits = (torch.empty(E, w // 32, dtype=torch.int32, device=x.device)
            if signs is not None and kernel == "wgmma" else None)
    scratch = (torch.empty(R, w, dtype=torch.float32 if f32 else torch.bfloat16,
                           device=x.device) if layout == "wide" else None)
    args = (None if scratch is None else scratch.data_ptr(),
            None if bits is None else bits.data_ptr(), R, log_w, E, int(apply_pre),
            K2_KERNELS.index(kernel), passes, _stream(x))
    sp = None if signs is None else signs.data_ptr()
    if f32:
        status = lib.ldpc_fwht_2mm_f32(x.data_ptr(), sp, y.data_ptr(), *args)
    else:
        status = lib.ldpc_fwht_2mm(x.data_ptr(), sp, y.data_ptr(), *args)
    _build.check(status, "fwht_signed_2mm")
    count("k2.launches")
    return y
