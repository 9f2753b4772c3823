"""Timing, tracing and the per-iteration work models.

Counterpart of `ldpc_sparc_tpu/utils/profiling.py`:

  * `timed(fn)`: wall-clock seconds per call, after a warm-up, with the
    card synchronised before the clock starts and after the last call
    whenever the result holds a CUDA tensor
  * `trace(path)`: `torch.profiler` around a block, written as a Chrome
    trace (open it in Perfetto or chrome://tracing), with the program's
    spans (`utils/tracing.py`) on the kernels' timeline
  * `fwht_width`, `amp_iteration_flops`, `amp_iteration_hbm_bytes`,
    `bp_iteration_flops`: the JAX package's models, which give the same
    integers for the same arguments. `backend="xla"` counts the Kronecker
    chain of `ops/wht.py` (`_factorize`, the width-dependent default
    largest factor when `max_log_factor` is None); `backend="pallas_ms"`
    counts the TPU kernel's one pass (sublane factors of w/128 and the
    lane factor 128). They model the JAX package's transforms; the bounds
    of the port's kernels are reckoned in `chip_smoke.py` (PERF.md).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import torch

from ..ops.wht import _factorize


def _synchronize(out) -> None:
    """Wait for the card if `out` (a tensor or a nest of tuples, lists and
    dicts of them) holds a CUDA tensor."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)


def timed(fn: Callable, *args, reps: int = 1, warmup: int = 1, **kw):
    """Run fn `warmup` times, then `reps` times on the clock; returns
    (last result, seconds per call)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    _synchronize(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
    _synchronize(out)
    return out, (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def trace(path: str = "trace.json"):
    """`with trace('t.json'): run()` records the CPU and, where there is a
    card, its kernels, and writes a Chrome trace to `path`. The program's
    spans (`utils/tracing.span`: `mc.designs`, `mc.decode`, ...) record
    while it runs, so the trace shows them on the host's row, on the
    kernels' timeline."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(path))


def _sublane_factors(S: int, max_log: int = 7) -> tuple[int, ...]:
    """S (a power of two) as powers of two of at most 2^max_log, the larger
    first: the TPU kernel's sublane stages (wht_pallas.py:122)."""
    log_s = S.bit_length() - 1
    out = []
    while log_s > 0:
        g = min(max_log, log_s)
        out.append(1 << g)
        log_s -= g
    return tuple(out)


def fwht_width(L: int, M: int, n: int,
               base_shape: Tuple[int, int] = (1, 1)) -> int:
    """Transform width w of the design engine (`SparcDesign.build`) for a
    base matrix of shape (Lr, Lc): the larger of the block sides n/Lr and
    L*M/Lc when it is a power of two, else the next power of two above it."""
    Lr, Lc = base_shape
    large = max(n // Lr, (L * M) // Lc)
    if large & (large - 1) == 0:
        return large
    return 1 << large.bit_length()


def _stage_factors(w: int, max_log_factor: int | None, backend: str) -> list[int]:
    if backend == "pallas_ms":
        return list(_sublane_factors(w // 128)) + [128]
    return _factorize(w.bit_length() - 1, max_log_factor)


def amp_iteration_flops(L: int, M: int, n: int,
                        max_log_factor: int | None = None,
                        backend: str = "xla",
                        base_shape: Tuple[int, int] = (1, 1),
                        n_blocks: int | None = None) -> int:
    """FLOPs of one AMP iteration: per nonzero base-matrix block two FWHTs
    of width w, each a chain of dense factor products costing
    2 * w * sum(factors), plus about 10 operations an entry of the
    denoiser. n_blocks: the nonzero blocks (defaults to Lr * Lc)."""
    w = fwht_width(L, M, n, base_shape)
    if n_blocks is None:
        n_blocks = base_shape[0] * base_shape[1]
    fwht = 2 * w * sum(_stage_factors(w, max_log_factor, backend))
    return 2 * n_blocks * fwht + 10 * L * M


def amp_iteration_hbm_bytes(L: int, M: int, n: int,
                            max_log_factor: int | None = None,
                            itemsize: int = 4,
                            backend: str = "xla",
                            base_shape: Tuple[int, int] = (1, 1),
                            n_blocks: int | None = None) -> int:
    """Least device-memory traffic of one AMP iteration: each stage of the
    chain reads and writes the w-state once a block ("xla"), or each
    transform reads the state and a bf16 sign plane and writes once
    ("pallas_ms"); plus one read and write of the L*M state."""
    w = fwht_width(L, M, n, base_shape)
    if n_blocks is None:
        n_blocks = base_shape[0] * base_shape[1]
    if backend == "pallas_ms":
        per_transform = w * (itemsize + itemsize + 2)
    else:
        stages = len(_factorize(w.bit_length() - 1, max_log_factor))
        per_transform = 2 * stages * w * itemsize
    return 2 * n_blocks * per_transform + 2 * L * M * itemsize


def bp_iteration_flops(E: int, z: int, dc_max: int, Mp: int) -> int:
    """Elementwise operations of one BP iteration in the z-structured
    layout: variable sums and 3 (dc - 2) Lxor evaluations a check row."""
    var_ops = 4 * E * z
    lxor_ops = 12
    chk_ops = Mp * z * 3 * dc_max * lxor_ops
    return var_ops + chk_ops
