"""The ('dp', 'sec') device mesh over torch.distributed ranks.

Counterpart of `ldpc_sparc_tpu/parallel/mesh.py`. The framework's two
parallel axes (SURVEY.md section 2, parallelism table):

  dp  : independent Monte Carlo trials (codewords), the reference's
        grid-engine job fan-out (ldpc_jossy/py/ldpc_awgn.py:125-131)
  sec : SPARC column blocks of the spatially coupled base matrix, the
        tensor-parallel split of the design matrix
        (sparc_public/sparc.py:831-875); see `parallel/sharded.py`

Where JAX runs one controller over a mesh of devices, here every rank is a
process: the mesh is a `torch.distributed.device_mesh.DeviceMesh` over the
ranks of the default process group, and collectives go through its
per-axis groups. Rank r's device is `cuda:{local rank % device count}`,
or the CPU when the caller asks for it (gloo); several ranks on one card
need the gloo backend, since NCCL refuses two ranks on one device.

`make_mesh()` in a plain process needs no launcher: it makes a one-rank
group itself. Under `torchrun`, `maybe_distributed_init` reads RANK,
WORLD_SIZE, MASTER_ADDR and MASTER_PORT. `run_ranks` spawns N local ranks
that meet through a file store (no port) and returns each rank's result.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device


def default_backend(device_type: str) -> str:
    """NCCL for ranks on cards, gloo for ranks on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's rank on its host (torchrun's LOCAL_RANK, else its
    global rank)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def maybe_distributed_init(device=None, backend: Optional[str] = None) -> bool:
    """Initialise the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) if it is set and no group
    exists yet; returns whether a group exists afterwards."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    device_type = resolve_device(device).type
    dist.init_process_group(backend or default_backend(device_type),
                            init_method="env://")
    return True


def make_mesh(dp: Optional[int] = None, sec: int = 1, device=None,
              backend: Optional[str] = None) -> DeviceMesh:
    """A (dp, sec) mesh named ('dp', 'sec') over every rank of the default
    process group, which is made first when there is none (from torchrun's
    environment, else as a group of this one process). dp defaults to
    world // sec; dp * sec must be the world size. `device`: 'cpu' for
    ranks on the CPU; by default each rank takes its card."""
    device_type = resolve_device(device).type
    if not maybe_distributed_init(device, backend):
        dist.init_process_group(backend or default_backend(device_type),
                                store=dist.HashStore(), world_size=1, rank=0)
    world = dist.get_world_size()
    if dp is None:
        if world % sec:
            raise ValueError(f"sec={sec} must divide the world size {world}")
        dp = world // sec
    if dp * sec != world:
        raise ValueError(f"a {dp} x {sec} mesh needs {dp * sec} ranks, the "
                         f"world has {world}")
    if device_type == "cuda":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
        # with CUDA initialised, DeviceMesh keeps this device rather than
        # taking LOCAL_RANK's, which does not exist when ranks share a card
        torch.cuda.init()
    return init_device_mesh(device_type, (dp, sec), mesh_dim_names=("dp", "sec"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in `mesh`."""
    if mesh.device_type != "cuda":
        return torch.device(mesh.device_type)
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def axis(mesh: DeviceMesh, name: str) -> tuple:
    """(size, this rank's index, process group) of axis `name`."""
    return (mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name),
            mesh.get_group(name))


# --------------------------------------------------------------------------
# spawning local ranks
# --------------------------------------------------------------------------

def _rank_main(fn, rank, world, store_path, backend, threads, queue, args):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # plain pickle: a tensor must not travel as shared memory whose
        # owner exits
        queue.put((rank, True, pickle.dumps(out)))
    except Exception:
        queue.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, nprocs: int, *args, backend: str = "gloo",
              threads: Optional[int] = 1, timeout: float = 600.0) -> list:
    """Run fn(*args) in `nprocs` fresh processes that form one process group
    (`backend`; they meet through a file store in a temporary directory).
    fn must be importable by name; it makes its own mesh (`make_mesh`).
    `threads` pins torch's CPU threads in each rank. Returns the list of the
    ranks' results; raises with the first failing rank's traceback, or when
    `timeout` seconds pass, after stopping every rank."""
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="ldpc_ranks_")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, os.path.join(tmp, "store"), backend,
                               threads, queue, args), daemon=True)
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        results, failed = {}, None
        deadline = time.monotonic() + timeout
        while len(results) < nprocs and failed is None:
            if not queue.empty():
                rank, ok, out = queue.get()
                if ok:
                    results[rank] = pickle.loads(out)
                else:
                    failed = f"rank {rank} failed:\n{out}"
                continue
            if time.monotonic() > deadline:
                failed = f"ranks timed out after {timeout} s"
            elif any(p.exitcode not in (None, 0) for p in procs) and queue.empty():
                codes = [p.exitcode for p in procs]
                failed = f"a rank exited without a result: exit codes {codes}"
            else:
                time.sleep(0.01)
        if failed is not None:
            raise RuntimeError(failed)
        for p in procs:
            p.join(timeout=30)
        return [results[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
