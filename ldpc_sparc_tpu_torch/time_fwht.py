"""Check and time K1, the signed FWHT, route by route on the card.

    python -m ldpc_sparc_tpu_torch.time_fwht --log-w 15 --rows 12288 --E 192 --k 332
    python -m ldpc_sparc_tpu_torch.time_fwht --log-w 19 --rows 256 --k 9216 --route cluster

For every route that takes the width ("block", "cluster", "two_pass"; see
`ops/wht_cuda.py`), or the one named by --route: `fwht_signed` with
pre-signs, post-signs and no signs against its plain version, bit for bit
on rows with entries in {-1, 0, 1} and within 1e-5 of the largest entry on
Gaussian rows, then its time by CUDA events. The two fused SRHT products
(`srht_scatter_fwht`, `srht_fwht_gather`) are checked and timed the same
way beside their plain versions on the routes that keep a row on chip.
Each time stands beside the least the card could take for the bytes the
function must move (inputs once, outputs once) at 3.35 TB/s. --ptxas
prints the compiler's register and shared-memory report of K1's kernels.
With --out the numbers are also written as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from . import _build
from .ops import wht_cuda

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
REL_BOUND = 1e-5


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _close(got, want, exact: bool, what: str) -> float:
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if exact and not torch.equal(got, want):
        raise AssertionError(f"{what}: not bit-equal on ternary rows (max|d| {err})")
    if not err <= REL_BOUND * float(want.abs().max()):
        raise AssertionError(f"{what}: max|d| {err} > {REL_BOUND} max|ref|")
    return err


def run_width(log_w: int, rows: int, E: int, k: int, routes, reps: int) -> dict:
    dev = torch.device("cuda")
    w = 1 << log_w
    k = min(k, w)
    gen = torch.Generator(device=dev).manual_seed(log_w)
    signs = (torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1).float()
    idx = torch.stack([torch.randperm(w, generator=gen, device=dev)[:k].sort().values
                       for _ in range(E)]).to(torch.int32)
    x = {"ternary": torch.randint(-1, 2, (rows, w), generator=gen, device=dev).float(),
         "gaussian": torch.randn(rows, w, generator=gen, device=dev)}
    vals = {"ternary": torch.randint(-1, 2, (rows, k), generator=gen, device=dev).float(),
            "gaussian": torch.randn(rows, k, generator=gen, device=dev)}
    modes = {"pre": (signs, True), "post": (signs, False), "none": (None, False)}
    out = {"log_w": log_w, "rows": rows, "E": E, "k": k, "routes": {}}
    plain_ms = {m: cuda_ms(lambda: wht_cuda.fwht_signed_ref(x["gaussian"], sg, pre),
                           max(2, reps // 4)) for m, (sg, pre) in modes.items()}
    bound_ms = 8 * rows * w / HBM_BYTES_PER_S * 1e3
    for route in routes:
        res = {}
        for m, (sg, pre) in modes.items():
            for kind, xx in x.items():
                want = wht_cuda.fwht_signed_ref(xx, sg, pre)
                got = wht_cuda.fwht_signed(xx, sg, pre, route=route)
                err = _close(got, want, kind == "ternary",
                             f"fwht_signed 2^{log_w} {route} {m} {kind}")
                del got, want
            ms = cuda_ms(lambda: wht_cuda.fwht_signed(x["gaussian"], sg, pre,
                                                      route=route), reps)
            res[m] = {"ms": ms, "plain_ms": plain_ms[m], "bound_ms": bound_ms,
                      "max_abs_err": err}
            print(f"2^{log_w} ({rows} rows, E={E}) {route:8s} {m:4s}: {ms:.4f} ms "
                  f"(bound {bound_ms:.4f} ms, {100 * bound_ms / ms:.0f} %; plain "
                  f"{plain_ms[m]:.4f} ms) max|d| {err:.2e}", flush=True)
        if route != "two_pass":
            fused_bound = 4 * rows * (w + k) / HBM_BYTES_PER_S * 1e3
            for kind in x:
                want = wht_cuda.srht_scatter_fwht_ref(vals[kind], idx, signs, w)
                got = wht_cuda.srht_scatter_fwht(vals[kind], idx, signs, w,
                                                 route=route)
                e_s = _close(got, want, kind == "ternary",
                             f"srht_scatter_fwht 2^{log_w} {route} {kind}")
                del got, want
                want = wht_cuda.srht_fwht_gather_ref(x[kind], signs, idx)
                got = wht_cuda.srht_fwht_gather(x[kind], signs, idx, route=route)
                e_g = _close(got, want, kind == "ternary",
                             f"srht_fwht_gather 2^{log_w} {route} {kind}")
                del got, want
            for name, fn, ref, err in (
                    ("scatter", lambda: wht_cuda.srht_scatter_fwht(
                        vals["gaussian"], idx, signs, w, route=route, validate=False),
                     lambda: wht_cuda.srht_scatter_fwht_ref(vals["gaussian"], idx,
                                                            signs, w), e_s),
                    ("gather", lambda: wht_cuda.srht_fwht_gather(
                        x["gaussian"], signs, idx, route=route, validate=False),
                     lambda: wht_cuda.srht_fwht_gather_ref(x["gaussian"], signs,
                                                           idx), e_g)):
                ms, pms = cuda_ms(fn, reps), cuda_ms(ref, max(2, reps // 4))
                res[name] = {"ms": ms, "plain_ms": pms, "bound_ms": fused_bound,
                             "max_abs_err": err}
                print(f"2^{log_w} ({rows} rows, E={E}, k={k}) {route:8s} {name:7s}: "
                      f"{ms:.4f} ms (bound {fused_bound:.4f} ms, "
                      f"{100 * fused_bound / ms:.0f} %; plain {pms:.4f} ms) "
                      f"max|d| {err:.2e}", flush=True)
        else:
            # the same products composed around the two passes in device memory
            def two_pass(xx, sg, apply_pre):
                return wht_cuda.fwht_signed(xx, sg, apply_pre, route="two_pass")
            for name, fn in (
                    ("scatter", lambda: wht_cuda.srht_scatter_fwht_ref(
                        vals["gaussian"], idx, signs, w, transform=two_pass)),
                    ("gather", lambda: wht_cuda.srht_fwht_gather_ref(
                        x["gaussian"], signs, idx, transform=two_pass))):
                ms = cuda_ms(fn, reps)
                res[name] = {"ms": ms}
                print(f"2^{log_w} ({rows} rows, E={E}, k={k}) {route:8s} {name:7s}: "
                      f"{ms:.4f} ms (zero fill, scatter_ or gather in device "
                      f"memory around the two passes)", flush=True)
        out["routes"][route] = res
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-w", type=int, nargs="+", default=[15])
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--E", type=int, default=1, help="sign and index rows")
    ap.add_argument("--k", type=int, default=332, help="indices per row")
    ap.add_argument("--route", choices=wht_cuda.ROUTES, default=None,
                    help="one route (default: every route that takes the width)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_fwht: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _, log = _build.build()
    if args.ptxas:
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and "fwht_" in ln:
                print(" / ".join(s.strip() for s in lines[i:i + 3]
                                 if "Used" in s or "Compiling" in s or "spill" in s))
    result = {"card": card, "widths": []}
    for log_w in args.log_w:
        routes = [args.route] if args.route else [
            r for r in wht_cuda.ROUTES
            if wht_cuda.ROUTE_LOG_W[r][0] <= log_w <= wht_cuda.ROUTE_LOG_W[r][1]]
        if any(r == "cluster" for r in routes):
            print(f"2^{log_w}: the card holds {wht_cuda.active_clusters(log_w)} "
                  f"clusters of {1 << (log_w - wht_cuda.SEG_LOG_W)} blocks at once")
        result["widths"].append(run_width(log_w, args.rows, args.E, args.k, routes,
                                          args.reps))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
