"""Check and time K4, the whole-decode BP kernel, variant by variant on the card.

    python -m ldpc_sparc_tpu_torch.time_k4
    python -m ldpc_sparc_tpu_torch.time_k4 --code 802.16 1/2 27 A --batch 512 \
        --max-iters 200 --snr-db 1.5 2.5

For a code, a batch and each SNR (random codewords, BPSK over AWGN, made
on the CPU from --seed): both variants of the check phase ("check_thread",
"split"; see `ops/bp_cuda.py`), each with the kernel compiled for two
blocks an SM and the one compiled for one, must give `torch.equal`
iterations and APP; then each is timed by CUDA events, with the table's
own choice marked. Last, the latency of one dependent Lxor (a chain on one
warp), which with the slowest codeword's chain gives the decode's second
bound. With --out the numbers are also written as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from . import get_code
from .ops import bp_cuda
from .time_fwht import cuda_ms


def inputs(code, snr_db: float, batch: int, seed: int, dev) -> torch.Tensor:
    """LLRs of `batch` random codewords at sigma^2 = 10^(-snr_db / 10)."""
    gen = torch.Generator().manual_seed(seed)
    x = code.encode(torch.randint(0, 2, (batch, code.K), generator=gen))
    sigma2 = 10 ** (-snr_db / 10)
    y = (1 - 2 * x.float()) + sigma2 ** 0.5 * torch.randn(batch, code.N, generator=gen)
    return (2 / sigma2 * y).to(dev)


def lxor_latency_us(correction: bool = True) -> float:
    """Microseconds of one dependent Lxor: the difference of two chains."""
    lo, hi = 20_000, 120_000
    t = [min(bp_cuda.lxor_chain_ms(n, correction) for _ in range(3)) for n in (lo, hi)]
    return 1e3 * (t[1] - t[0]) / (hi - lo)


def run_point(code, method: str, snr_db: float, batch: int, max_iters: int, seed: int,
              reps: int) -> dict:
    dev = torch.device("cuda")
    g = code.graph
    corr = method != "minsum"
    llr = inputs(code, snr_db, batch, seed, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table = bp_cuda.k4_variant(g)
    table_two = bp_cuda.two_blocks_an_sm(table, bp_cuda.block_threads(g, table), batch,
                                         sms, g.dc_max)
    ref = None
    out = {"snr_db": snr_db, "times": []}
    for variant in bp_cuda.VARIANTS:
        if bp_cuda.shared_bytes(g, variant) > bp_cuda.MAX_SHARED:
            continue
        threads = bp_cuda.block_threads(g, variant)
        fits_two = threads <= bp_cuda.TWO_BLOCK_THREADS[variant]
        for two in ((True, False) if fits_two else (False,)):
            def call():
                return bp_cuda.bp_decode_kernel(llr, g, max_iters, corr, 0.7,
                                                variant=variant, two_blocks=two)
            res = call()
            torch.cuda.synchronize()
            if ref is None:
                ref = res
                out["iterations_mean"] = float(res.iterations.float().mean())
                out["iterations_max"] = int(res.iterations.max())
                out["capped"] = int((res.iterations >= max_iters).sum())
            elif not (torch.equal(res.app, ref.app)
                      and torch.equal(res.iterations, ref.iterations)):
                raise AssertionError(f"K4 {variant} two_blocks={two} differs from "
                                     f"the first variant")
            ms = cuda_ms(call, reps)
            chosen = variant == table and two == table_two
            out["times"].append({"variant": variant, "threads": threads,
                                 "two_blocks": two, "ms": ms, "table": chosen})
            print(f"  {snr_db:g} dB {variant:12s} {threads:4d} threads, "
                  f"{'two blocks' if two else 'one block'} an SM: {ms:.4f} ms"
                  f"{'  <- table' if chosen else ''}", flush=True)
    print(f"  {snr_db:g} dB: all equal; iterations mean {out['iterations_mean']:.2f} "
          f"max {out['iterations_max']}, {out['capped']} of {batch} at the cap",
          flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--code", nargs=4, default=["802.11n", "1/2", "27", "A"],
                    metavar=("STANDARD", "RATE", "Z", "CLASS"))
    ap.add_argument("--method", default="sumprod", choices=("sumprod", "minsum"))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--snr-db", type=float, nargs="+", default=[2.0])
    ap.add_argument("--seed", type=int, nargs="+", default=[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_k4: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cfg = (args.code[0], args.code[1], int(args.code[2]), args.code[3])
    code = get_code(*cfg)
    deg = (code.graph.chk_edges >= 0).sum(1)
    print(f"{cfg} {args.method} batch {args.batch} <= {args.max_iters} iterations: "
          f"{code.graph.Nc} checks of degree {int(deg.min())}-{int(deg.max())}, "
          f"shared bytes check_thread "
          f"{bp_cuda.shared_bytes(code.graph, 'check_thread')}, split "
          f"{bp_cuda.shared_bytes(code.graph, 'split')}", flush=True)
    result = {"card": card, "code": cfg, "method": args.method, "batch": args.batch,
              "max_iters": args.max_iters, "points": []}
    for seed in args.seed:
        for snr in args.snr_db:
            print(f" seed {seed}:", flush=True)
            pt = run_point(code, args.method, snr, args.batch, args.max_iters, seed,
                           args.reps)
            pt["seed"] = seed
            result["points"].append(pt)
    result["lxor_latency_us"] = {"sumprod": lxor_latency_us(True),
                                 "minsum": lxor_latency_us(False)}
    print(f"one dependent Lxor: {result['lxor_latency_us']['sumprod']:.4f} us "
          f"(sum-product), {result['lxor_latency_us']['minsum']:.4f} us (min-sum)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
