"""Check and time K2, the signed FWHT as two tensor-core products, on the card.

    python -m ldpc_sparc_tpu_torch.time_k2 --log-w 15 --rows 12288 --E 192
    python -m ldpc_sparc_tpu_torch.time_k2 --log-w 19 --rows 256 --kernel wgmma

For every kernel that takes the width ("mma" up to 2^15, "wgmma" from 2^12; see
`ops/wht_cuda.py`), or the one named by --kernel: `fwht_signed_2mm` with
pre-signs, post-signs and no signs against `fwht_signed_ref`, bit for bit
on rows with entries in {-1, 0, 1}, and against its plain version
`fwht_signed_2mm_ref` on Gaussian rows (relative Frobenius error at most
1e-3: both round to bf16 where the kernel does, and only an entry of the
intermediate that sits on a rounding boundary differs); then its time by
CUDA events. Above 2^15 the two launches of the wide layout are also timed
singly. Each time stands beside the least the card could take: the bytes
(x and y once, the signs once) at 3.35 TB/s and the two products'
2 R (a b^2 + a^2 b) operations at 989 TFLOP/s, and beside the pair of
cuBLAS bf16 products `ha @ (x @ hb)` on operands already in bf16 (a
yardstick; the port never calls it). --ptxas prints the compiler's
register and shared-memory report of K2's kernels and any note that it
runs a kernel's wgmma instructions one at a time. With --out the numbers
are also written as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from . import _build
from .ops import wht_cuda
from .time_fwht import HBM_BYTES_PER_S, cuda_ms

BF16_FLOPS = 989e12         # H100 SXM, NVIDIA's data sheet, dense bf16
REL_BOUND = 1e-3


def bounds_ms(rows: int, log_w: int, E: int) -> dict:
    """The byte and operation bounds of one transform of (rows, 2^log_w)."""
    w = 1 << log_w
    a, b = wht_cuda.split_ab(w)
    return {"bytes_ms": 4e3 * (2 * rows * w + E * w) / HBM_BYTES_PER_S,
            "bytes_unsigned_ms": 8e3 * rows * w / HBM_BYTES_PER_S,
            "operations_ms": 2e3 * rows * (a * b * b + a * a * b) / BF16_FLOPS}


def run_width(log_w: int, rows: int, E: int, kernels, reps: int) -> dict:
    dev = torch.device("cuda")
    w = 1 << log_w
    gen = torch.Generator(device=dev).manual_seed(log_w)
    signs = (torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1).float()
    xt = torch.randint(-1, 2, (rows, w), generator=gen, device=dev).float()
    xg = torch.randn(rows, w, generator=gen, device=dev)
    modes = {"pre": (signs, True), "post": (signs, False), "none": (None, False)}
    out = {"log_w": log_w, "rows": rows, "E": E, **bounds_ms(rows, log_w, E),
           "kernels": {}}
    a, b = wht_cuda.split_ab(w)
    ha = wht_cuda.hadamard_factor(a, torch.bfloat16, dev)
    hb = wht_cuda.hadamard_factor(b, torch.bfloat16, dev)
    xb = xg.reshape(rows, a, b).to(torch.bfloat16)
    out["library_ms"] = cuda_ms(lambda: ha @ (xb @ hb), reps)
    del xb
    print(f"2^{log_w} ({rows} rows, E={E}): bound bytes {out['bytes_ms']:.4f} ms "
          f"({out['bytes_unsigned_ms']:.4f} without signs), operations "
          f"{out['operations_ms']:.4f} ms; cuBLAS bf16 pair {out['library_ms']:.4f} ms",
          flush=True)
    for kernel in kernels:
        res = {}
        for m, (sg, pre) in modes.items():
            got = wht_cuda.fwht_signed_2mm(xt, sg, pre, kernel=kernel)
            want = wht_cuda.fwht_signed_ref(xt, sg, pre)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"K2 2^{log_w} {kernel} {m}: not bit-equal on "
                                     f"ternary rows ({bad} of {got.numel()} entries)")
            got = wht_cuda.fwht_signed_2mm(xg, sg, pre, kernel=kernel)
            want = wht_cuda.fwht_signed_2mm_ref(xg, sg, pre)
            torch.cuda.synchronize()
            rel = float((got - want).norm() / want.norm())
            del got, want
            if not rel <= REL_BOUND:
                raise AssertionError(f"K2 2^{log_w} {kernel} {m}: relative error "
                                     f"{rel} > {REL_BOUND}")
            ms = cuda_ms(lambda: wht_cuda.fwht_signed_2mm(xg, sg, pre, kernel=kernel),
                         reps)
            res[m] = {"ms": ms, "rel_err": rel}
            text = f"2^{log_w} {kernel:5s} {m:4s}: {ms:.4f} ms, rel {rel:.2e}"
            if log_w > wht_cuda.TILE_MAX_LOG_W_2MM:
                for p in (1, 2):
                    res[m][f"launch{p}_ms"] = cuda_ms(
                        lambda: wht_cuda.fwht_signed_2mm(xg, sg, pre, kernel=kernel,
                                                         passes=p), reps)
                text += (f" (launch 1 {res[m]['launch1_ms']:.4f}, launch 2 "
                         f"{res[m]['launch2_ms']:.4f})")
            print(text, flush=True)
        out["kernels"][kernel] = res
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-w", type=int, nargs="+", default=[15])
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--E", type=int, default=1, help="sign rows")
    ap.add_argument("--kernel", choices=wht_cuda.K2_KERNELS, default=None,
                    help="one kernel (default: every kernel that takes the width)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_k2: needs a CUDA device")
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
            if "Compiling entry" in ln and ("fwht2mm" in ln or "pack_signs" in ln):
                print(" / ".join(s.strip() for s in lines[i:i + 4]
                                 if "Used" in s or "Compiling" in s or "spill" in s))
        # ptxas says so when it runs a kernel's wgmma one at a time
        for ln in lines:
            if "fwht2mm" in ln and "serialized" in ln:
                print(ln.strip())
    result = {"card": card, "widths": []}
    for log_w in args.log_w:
        kernels = [args.kernel] if args.kernel else [
            k for k, (lo, hi) in (("mma", (wht_cuda.MIN_LOG_W_2MM,
                                           wht_cuda.TILE_MAX_LOG_W_2MM)),
                                  ("wgmma", (wht_cuda.WGMMA_MIN_LOG_W,
                                             wht_cuda.MAX_LOG_W_2MM)))
            if lo <= log_w <= hi]
        result["widths"].append(run_width(log_w, args.rows, args.E, kernels, args.reps))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
