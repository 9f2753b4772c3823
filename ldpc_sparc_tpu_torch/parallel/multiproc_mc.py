"""Multi-process Monte Carlo over a mesh of ranks.

    python -m ldpc_sparc_tpu_torch.parallel.multiproc_mc --nprocs 2 --device cpu
    python -m ldpc_sparc_tpu_torch.parallel.multiproc_mc --nprocs 2 --sec 2 --sharded \\
        --L 2048 --M 512 --R 1.5 --omega 6 --Lambda 32 --t-max 40 --trials 64 \\
        --backend gloo

Counterpart of `examples/multihost_mc.py`. The launcher starts N worker
copies of this module with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR=127.0.0.1 and a free MASTER_PORT); each worker
builds the (N / sec, sec) mesh (`make_mesh`, which reads that environment)
and runs its share: `sparc_mc_counts` on the mesh, or with `--sharded` the
section-sharded step (`parallel/sharded.py`, trial t seeded (seed, t)).
Rank 0 prints one JSON line: the counters, the mesh, the backend, the
seconds of the timed call (after one untimed call) and the launches of
each kernel wrapper in rank 0 during that call. The launcher then runs
the same work in one process without a mesh (`--sharded`: on a mesh of
one rank) and prints "multi-process run OK" when the counters are equal,
else exits 1. `--no-reference` skips that run.

Each rank runs torch on one CPU thread. Ranks take the card unless
`--device cpu` (gloo); `--backend` overrides
the backend (NCCL on cards, which refuses two ranks on one card: take
gloo there).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

TIMEOUT_S = 600       # a rank that takes longer is stopped and the launch fails

def _params(args):
    from ..config import DecodeParams, SparcParams
    kw = dict(P=args.P, R=args.R, L=args.L, M=args.M)
    if args.omega:
        kw.update(spatially_coupled=True, omega=args.omega, Lambda=args.Lambda)
    return SparcParams(**kw), DecodeParams(t_max=args.t_max)


def run(args, mesh) -> dict:
    """This rank's share of the configured work on `mesh` (None: one
    process, no mesh); returns the counters, the timed call's seconds and
    the kernel launches it made."""
    import torch
    from ..device import resolve_device
    from ..utils import tracing
    from .mesh import mesh_device
    from .montecarlo import sparc_mc_counts
    from .sharded import make_sharded_sim_step

    params, decode = _params(args)
    dev = mesh_device(mesh) if mesh is not None else resolve_device(args.device)
    if args.sharded:
        step, _ = make_sharded_sim_step(params, decode, args.awgn_var, mesh,
                                        seed=args.seed)
        seeds = [(args.seed, t) for t in range(args.trials)]
        work = lambda: step(seeds)            # noqa: E731
    else:
        work = lambda: sparc_mc_counts(       # noqa: E731
            params, decode, args.awgn_var, args.seed, args.trials, device=dev,
            mesh=mesh)
    work()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tracing.reset("k1.launches", "k3.launches")
    t0 = time.perf_counter()
    counts = work()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launched = tracing.counters()
    return {"counts": counts, "seconds": time.perf_counter() - t0,
            "launches": {"fwht_signed": launched["k1.launches"],
                         "fused_denoise_update": launched["k3.launches"]}}


def worker(args) -> None:
    import torch
    import torch.distributed as dist
    from .mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(sec=args.sec, device=args.device, backend=args.backend)
    out = run(args, mesh)
    if dist.get_rank() == 0:
        print(json.dumps({"processes": dist.get_world_size(),
                          "mesh": list(mesh.shape), "backend": dist.get_backend(),
                          **out}), flush=True)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, argv) -> int:
    port = _free_port()
    cmd = [sys.executable, "-m", "ldpc_sparc_tpu_torch.parallel.multiproc_mc",
           *argv, "--worker"]
    procs = []
    for r in range(args.nprocs):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(args.nprocs), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        for r, (o, e) in enumerate(outs):
            if procs[r].returncode:
                sys.stderr.write(f"rank {r} exited {procs[r].returncode}:\n{o}{e}\n")
        return 1
    line = outs[0][0].strip().splitlines()[-1]
    print(line, flush=True)
    if args.no_reference:
        return 0
    got = json.loads(line)["counts"]
    if args.sharded:
        from .mesh import make_mesh
        ref = run(args, make_mesh(device=args.device, backend=args.backend))
    else:
        ref = run(args, None)
    print(json.dumps({"processes": 1, "reference": True, **ref}), flush=True)
    if ref["counts"] != got:
        sys.stderr.write(f"counters differ from the one-process run: {got} vs "
                         f"{ref['counts']}\n")
        return 1
    print("multi-process run OK", flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="multiproc_mc")
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--sec", type=int, default=1)
    ap.add_argument("--device", default=None,
                   help="'cpu' for ranks on the CPU (default: each rank's card)")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: by device)")
    ap.add_argument("--sharded", action="store_true",
                    help="the section-sharded step instead of sparc_mc_counts")
    ap.add_argument("--P", type=float, default=15.0)
    ap.add_argument("--R", type=float, default=1.3)
    ap.add_argument("--L", type=int, default=64)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--omega", type=int, default=0,
                    help="spatially coupled with this omega (0: plain)")
    ap.add_argument("--Lambda", type=int, default=8)
    ap.add_argument("--t-max", type=int, default=10)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--awgn-var", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-reference", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    return launch(args, argv)


if __name__ == "__main__":
    sys.exit(main())
