"""LDPC BP decode: the hand-written Hopper kernel (K4) and its plain version.

`bp_decode_kernel` replaces `ldpc_sparc_tpu/ops/bp_pallas.py::_make_kernel`
(through `bp_decode_pallas`): the whole BP decode of a batch of codewords in
one launch, one block per codeword, its messages resident in shared memory
across all iterations. Each codeword stops on its own when its parity
checks hold; its APP is the variable sum of that iteration and its
iteration count the number of iterations after which parity did not yet
hold (0 for an input that already satisfies it after one).

The check phase has two variants, bit-equal to each other: "check_thread"
(one thread runs a check's whole trellis) and "split" (two neighbouring
lanes a check: one runs the forward prefixes, the other the backward
suffixes, then the extrinsic values are dealt out between them; a third
(E, z) buffer holds the suffixes). `k4_variant` is the fixed table that
picks one from the graph, the faster as measured on an H100 (PERF.md).
`split_check_model` is the split variant's order of work in plain PyTorch.

On a CUDA tensor the kernel of `csrc/bp_decode.cu` runs, or the call
raises; on a CPU tensor `bp_decode_ref`, the plain decode of `ops/bp.py`,
runs. The counter `k4.launches` (`utils/tracing.py`) counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..utils.tracing import count
from .bp import _BIG, BpResult, TannerGraph, _decode_lanes, column_edges, lxor

MAX_SHARED = 232_448     # bytes of shared memory one block may have on sm_90
VARIANTS = ("check_thread", "split")
# the largest block of each variant whose launch bound leaves two blocks an SM
TWO_BLOCK_THREADS = {"check_thread": 512, "split": 704}
MAX_THREADS = 1024


def bp_decode_ref(ch: torch.Tensor, graph: TannerGraph, max_iters: int,
                  correction: bool, corr_factor: float) -> BpResult:
    """The plain version: ch (B, Nv) -> app (B, Nv), iterations (B,)."""
    return _decode_lanes(ch, graph, max_iters, correction, corr_factor)


def _table_arrays(g: TannerGraph) -> np.ndarray:
    """The graph as the kernel reads it, one int32 array: edge shifts (E),
    per-column edge lists as CSR (Np+1 offsets, E ids) and per-row edge
    lists as CSR (Mp+1 offsets, E ids), each list in ascending edge id."""
    col = column_edges(g)
    col_ids = col[col >= 0]                      # row-major: column by column
    col_ptr = np.concatenate([[0], np.cumsum((col >= 0).sum(1))])
    chk = g.chk_edges
    row_ids = chk[chk >= 0]
    row_ptr = np.concatenate([[0], np.cumsum((chk >= 0).sum(1))])
    return np.concatenate([g.edge_shift, col_ptr, col_ids, row_ptr,
                           row_ids]).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _tables(g: TannerGraph, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_table_arrays(g), device=device)


def k4_variant(g: TannerGraph) -> str:
    """The variant K4 takes for graph g when the caller names none, the
    faster as measured on an H100: "split" where two threads a check fit
    the 704-thread block (at most 352 checks: z = 27, 81 of the tables),
    else "check_thread" (z = 150: 900 or 1800 checks, where one thread a
    check already fills a 1024-thread block)."""
    if (block_threads(g, "split") <= TWO_BLOCK_THREADS["split"]
            and shared_bytes(g, "split") <= MAX_SHARED):
        return "split"
    return "check_thread"


def shared_bytes(g: TannerGraph, variant: str | None = None) -> int:
    """Dynamic shared memory of one block: the tables, the (E, z) messages
    and trellis prefixes (and suffixes, for "split"), and the channel LLRs
    and APP (Np, z). variant None: the one `k4_variant` picks."""
    if variant is None:
        variant = k4_variant(g)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS} or None, got {variant!r}")
    planes = 3 if variant == "split" else 2
    return 4 * (3 * g.E + g.Np + g.Mp + 2) + 4 * (planes * g.E * g.z + 2 * g.Nv)


def block_threads(g: TannerGraph, variant: str) -> int:
    """The block's size: one thread a check ("check_thread") or two
    ("split"), in whole warps, at most 1024."""
    return min(-(-g.Nc // 32) * 32 * (2 if variant == "split" else 1), MAX_THREADS)


SPLIT_TWO_BLOCK_DC_MAX = 8   # checks of higher degree: "split" alone on its SM


def two_blocks_an_sm(variant: str, threads: int, batch: int, sms: int,
                     dc_max: int) -> bool:
    """Which compiled kernel a launch takes: the one bounded for two blocks
    an SM (fewer registers) or the one bounded for one. A block that is too
    large for the first takes the second. "check_thread" otherwise keeps
    two an SM. "split" takes two an SM where that holds the whole batch in
    one wave and the checks are short (degree at most 8), else one: alone
    on its SM with 64 registers a block runs about twice as fast as two
    that share it with 48, and more than that on long checks (measured,
    PERF.md)."""
    if threads > TWO_BLOCK_THREADS[variant]:
        return False
    if variant == "check_thread":
        return True
    return batch <= 2 * sms and dc_max <= SPLIT_TWO_BLOCK_DC_MAX


def split_check_model(rows: list[torch.Tensor], correction: bool,
                      corr_factor: float) -> tuple[list[torch.Tensor], torch.Tensor]:
    """The "split" variant's check update of one protograph row, in its
    order: rows[k] is the k-th incoming message (any shape). Lane 0's chain
    gives the prefixes f[0..d-2], lane 1's the suffixes s[d-1..0]; then the
    extrinsic value of edge k is f[d-2] (k = d-1), s[1] (k = 0) or
    Lxor(f[k-1], s[k+1]), the even k by lane 0 and the odd by lane 1.
    Returns (extrinsic values, aggregate s[0])."""
    d = len(rows)
    f = [rows[0]]
    for k in range(1, d - 1):
        f.append(lxor(f[-1], rows[k], correction))
    s = {d - 1: rows[d - 1]}
    for k in range(d - 2, -1, -1):
        s[k] = lxor(s[k + 1], rows[k], correction)
    ext: list = [None] * d
    for role in (0, 1):
        for k in range(role, d, 2):
            if d == 1:
                e = torch.full_like(rows[0], _BIG)
            elif k == d - 1:
                e = f[k - 1]
            elif k == 0:
                e = s[1]
            else:
                e = lxor(f[k - 1], s[k + 1], correction)
            ext[k] = e if correction else e * corr_factor
    return ext, s[0]


def decode_split_model(ch: torch.Tensor, g: TannerGraph, max_iters: int,
                       correction: bool, corr_factor: float) -> BpResult:
    """The whole decode as the "split" kernel orders it, in plain PyTorch:
    per codeword, the variable sum ch first then ascending edge id, each
    check row of its true degree through `split_check_model`, a freeze at
    the first iteration whose aggregates are all > 0."""
    B, z = ch.shape[0], g.z
    chb = ch.reshape(B, g.Np, z)
    col = column_edges(g)
    idx = torch.arange(z)
    msg = ch.new_zeros(B, g.E, z)                  # check order
    app = torch.zeros_like(chb)
    it = torch.zeros(B, dtype=torch.int32)
    done = torch.zeros(B, dtype=torch.bool)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        new = msg.clone()
        tot = chb.clone()
        for j in range(g.Np):
            for e in col[j][col[j] >= 0]:
                c = (idx - int(g.edge_shift[e])) % z   # variable v reads slot c
                tot[:, j] = tot[:, j] + msg[:, e, c]
        for e in range(g.E):
            c = (idx - int(g.edge_shift[e])) % z
            new[:, e, c] = tot[:, g.edge_col[e]] - msg[:, e, c]
        ok = torch.ones(B, dtype=torch.bool)
        out = new.clone()
        for i in range(g.Mp):
            edges = [int(e) for e in g.chk_edges[i] if e >= 0]
            ext, aggr = split_check_model([new[:, e] for e in edges], correction,
                                          corr_factor)
            for e, v in zip(edges, ext):
                out[:, e] = v
            ok &= (aggr > 0.0).all(1)
        live = ~done
        msg = torch.where(live[:, None, None], out, msg)
        app = torch.where(live[:, None, None], tot, app)
        it = torch.where(live & ~ok, it + 1, it)
        done = done | ok
    return BpResult(app=app.reshape(B, g.Nv), iterations=it)


def _check(ch: torch.Tensor, g: TannerGraph, variant: str | None = None) -> None:
    if ch.dim() != 2 or ch.dtype != torch.float32 or not ch.is_contiguous():
        raise ValueError(f"ch must be a contiguous 2-D float32 tensor, got "
                         f"{tuple(ch.shape)} {ch.dtype}"
                         f"{'' if ch.is_contiguous() else ' (not contiguous)'}")
    if ch.shape[1] != g.Nv:
        raise ValueError(f"ch has {ch.shape[1]} LLRs per codeword, the graph "
                         f"{g.Nv}")
    need = shared_bytes(g, variant)
    if need > MAX_SHARED:
        raise ValueError(f"the BP state of one codeword (E={g.E}, z={g.z}, "
                         f"variant {variant!r}) needs {need} bytes of shared "
                         f"memory; a block has at most {MAX_SHARED}")


def lxor_chain_ms(n: int, correction: bool = True,
                  device: torch.device | str = "cuda") -> float:
    """Milliseconds one warp takes for n Lxors that each wait for the one
    before (CUDA events around one launch of the timing kernel of
    `csrc/bp_decode.cu`); the difference of two n over their difference is
    the latency of one dependent Lxor."""
    lib = _build.load()
    io = torch.empty(96, device=device).uniform_(0.5, 4.0)
    stream = torch.cuda.current_stream(io.device).cuda_stream
    _build.check(lib.ldpc_bp_lxor_chain(io.data_ptr(), 16, int(correction), stream),
                 "lxor_chain")
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    _build.check(lib.ldpc_bp_lxor_chain(io.data_ptr(), n, int(correction), stream),
                 "lxor_chain")
    stop.record()
    torch.cuda.synchronize(io.device)
    return start.elapsed_time(stop)


def bp_decode_kernel(ch: torch.Tensor, graph: TannerGraph, max_iters: int,
                     correction: bool, corr_factor: float,
                     variant: str | None = None,
                     two_blocks: bool | None = None) -> BpResult:
    """Decode ch (B, Nv) float32: K4 on a CUDA tensor, the plain version on
    a CPU one. correction=True is sum-product, False min-sum scaled by
    corr_factor. variant: None takes `k4_variant`'s, else "check_thread" or
    "split" runs that one or raises. two_blocks: None takes
    `two_blocks_an_sm`'s choice of compiled kernel, True or False that one
    (for timing; no result depends on it)."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS} or None, got {variant!r}")
    if ch.device.type == "cpu":
        return bp_decode_ref(ch, graph, max_iters, correction, corr_factor)
    if ch.device.type != "cuda":
        raise ValueError(f"no bp_decode kernel for device {ch.device}")
    if variant is None:
        variant = k4_variant(graph)
    _check(ch, graph, variant)
    threads = block_threads(graph, variant)
    if two_blocks is None:
        sms = torch.cuda.get_device_properties(ch.device).multi_processor_count
        two_blocks = two_blocks_an_sm(variant, threads, ch.shape[0], sms,
                                      graph.dc_max)
    lib = _build.load()
    B = ch.shape[0]
    app = torch.empty_like(ch)
    it = torch.empty(B, dtype=torch.int32, device=ch.device)
    if B == 0:
        return BpResult(app=app, iterations=it)
    tables = _tables(graph, ch.device)
    status = lib.ldpc_bp_decode(
        ch.data_ptr(), tables.data_ptr(), app.data_ptr(), it.data_ptr(), B,
        graph.z, graph.Np, graph.Mp, graph.E, int(max_iters), int(correction),
        ctypes.c_float(corr_factor), int(variant == "split"), threads,
        int(two_blocks and threads <= TWO_BLOCK_THREADS[variant]),
        torch.cuda.current_stream(ch.device).cuda_stream)
    _build.check(status, "bp_decode_kernel")
    count("k4.launches")
    return BpResult(app=app, iterations=it)
