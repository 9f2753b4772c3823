"""LDPC BP decode: the hand-written Hopper kernel (K4) and its plain version.

`bp_decode_kernel` replaces `ldpc_sparc_tpu/ops/bp_pallas.py::_make_kernel`
(through `bp_decode_pallas`): the whole BP decode of a batch of codewords in
one launch, one block per codeword, its messages resident in shared memory
across all iterations. Each codeword stops on its own when its parity
checks hold; its APP is the variable sum of that iteration and its
iteration count the number of iterations after which parity did not yet
hold (0 for an input that already satisfies it after one).

On a CUDA tensor the kernel of `csrc/bp_decode.cu` runs, or the call
raises; on a CPU tensor `bp_decode_ref`, the plain decode of `ops/bp.py`,
runs. `LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from .bp import BpResult, TannerGraph, _decode_lanes, column_edges

MAX_SHARED = 232_448     # bytes of shared memory one block may have on sm_90

LAUNCHES = 0


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


def shared_bytes(g: TannerGraph) -> int:
    """Dynamic shared memory of one block: the tables, the (E, z) messages
    and trellis prefixes, and the channel LLRs and APP (Np, z)."""
    return 4 * (3 * g.E + g.Np + g.Mp + 2) + 4 * (2 * g.E * g.z + 2 * g.Nv)


def _check(ch: torch.Tensor, g: TannerGraph) -> None:
    if ch.dim() != 2 or ch.dtype != torch.float32 or not ch.is_contiguous():
        raise ValueError(f"ch must be a contiguous 2-D float32 tensor, got "
                         f"{tuple(ch.shape)} {ch.dtype}"
                         f"{'' if ch.is_contiguous() else ' (not contiguous)'}")
    if ch.shape[1] != g.Nv:
        raise ValueError(f"ch has {ch.shape[1]} LLRs per codeword, the graph "
                         f"{g.Nv}")
    if shared_bytes(g) > MAX_SHARED:
        raise ValueError(f"the BP state of one codeword (E={g.E}, z={g.z}) "
                         f"needs {shared_bytes(g)} bytes of shared memory; a "
                         f"block has at most {MAX_SHARED}")


def bp_decode_kernel(ch: torch.Tensor, graph: TannerGraph, max_iters: int,
                     correction: bool, corr_factor: float) -> BpResult:
    """Decode ch (B, Nv) float32: K4 on a CUDA tensor, the plain version on
    a CPU one. correction=True is sum-product, False min-sum scaled by
    corr_factor."""
    global LAUNCHES
    if ch.device.type == "cpu":
        return bp_decode_ref(ch, graph, max_iters, correction, corr_factor)
    if ch.device.type != "cuda":
        raise ValueError(f"no bp_decode kernel for device {ch.device}")
    _check(ch, graph)
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
        ctypes.c_float(corr_factor), torch.cuda.current_stream(ch.device).cuda_stream)
    _build.check(status, "bp_decode_kernel")
    LAUNCHES += 1
    return BpResult(app=app, iterations=it)
