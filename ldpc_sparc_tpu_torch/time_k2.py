"""Check and time K2, the signed FWHT as two tensor-core products, on the card.

    python -m ldpc_sparc_tpu_torch.time_k2 --log-w 15 --rows 12288 --E 192
    python -m ldpc_sparc_tpu_torch.time_k2 --log-w 19 --rows 256 --kernel wgmma
    python -m ldpc_sparc_tpu_torch.time_k2 --log-w 15 --rows 12288 --E 192 --mm-dtype float32

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

--mm-dtype float32 runs K2 with float32 operands (by default both kernels
that take the width: "wgmma", from 2^12, one launch to 2^15 and two above,
and "mma", the pass kernels, two launches at every width; where a kernel
makes two launches each is timed singly too) against its plain version
`fwht_signed_2mm_ref(..., "float32")` within 2.5e-6 of the largest entry
(both float32; the sums run in another order), and the two kernels bit for
bit against each other on ternary rows. Its bound is the transform's own
work: the bytes as above and w log2 w float32 adds a row at 67 TFLOP/s (as
K1's `fwht_signed` counts them); beside it stands the reckoning of three
full bf16 products (one a plane) at 989 TFLOP/s, and its yardstick is the
pair of cuBLAS float32 products with TF32 off. Beside each reading stands
a control's: the plain version with both products' operands cut to their
two upper bf16 planes (`two_plane_ref`), what K2 computes if it drops the
lo plane. A sound limit lies between the two readings.
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
F32_FLOPS = 67e12           # the same, float32 outside the tensor cores
REL_BOUND = 1e-3
F32_ABS_BOUND = 2.5e-6      # float32 operands: max|d| / max|ref|
PLANES = {"bfloat16": 1, "float32": 3}   # bf16 products a float32 product takes


def bounds_ms(rows: int, log_w: int, E: int, mm_dtype: str = "bfloat16") -> dict:
    """The byte and operation bounds of one transform of (rows, 2^log_w):
    the two products' operations (three bf16 products each with float32
    operands) and, for float32 operands, the transform's own w log2 w adds
    a row."""
    w = 1 << log_w
    a, b = wht_cuda.split_ab(w)
    out = {"bytes_ms": 4e3 * (2 * rows * w + E * w) / HBM_BYTES_PER_S,
           "bytes_unsigned_ms": 8e3 * rows * w / HBM_BYTES_PER_S,
           "operations_ms": 2e3 * PLANES[mm_dtype] * rows * (a * b * b + a * a * b)
           / BF16_FLOPS}
    if mm_dtype == "float32":
        out["transform_operations_ms"] = 1e3 * rows * w * log_w / F32_FLOPS
    return out


def two_launches(log_w: int, kernel: str, mm_dtype: str) -> bool:
    """Whether the kernel makes two launches at the width (then each is
    timed singly)."""
    return (log_w > wht_cuda.TILE_MAX_LOG_W_2MM
            or (mm_dtype == "float32" and kernel == "mma"))


def two_plane_ref(x: torch.Tensor, signs: torch.Tensor | None,
                  apply_pre: bool) -> torch.Tensor:
    """`fwht_signed_2mm_ref(x, signs, apply_pre, "float32")` with X and T
    each cut to hi + mid, hi = bf16(v), mid = bf16(v - hi)."""
    def two(v):
        hi = v.to(torch.bfloat16).float()
        return hi + (v - hi).to(torch.bfloat16).float()

    R, w = x.shape
    a, b = wht_cuda.split_ab(w)
    E = 1 if signs is None else signs.shape[0]
    xv = x.reshape(R // E, E, a, b)
    sv = None if signs is None else signs.reshape(E, a, b)
    if sv is not None and apply_pre:
        xv = xv * sv
    ha = wht_cuda.hadamard_factor(a, torch.float32, x.device)
    hb = wht_cuda.hadamard_factor(b, torch.float32, x.device)
    y = ha @ two(two(xv) @ hb)
    if sv is not None and not apply_pre:
        y = y * sv
    return y.reshape(R, w)


def run_width(log_w: int, rows: int, E: int, kernels, reps: int,
              mm_dtype: str = "bfloat16") -> dict:
    dev = torch.device("cuda")
    w = 1 << log_w
    gen = torch.Generator(device=dev).manual_seed(log_w)
    signs = (torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1).float()
    xt = torch.randint(-1, 2, (rows, w), generator=gen, device=dev).float()
    xg = torch.randn(rows, w, generator=gen, device=dev)
    modes = {"pre": (signs, True), "post": (signs, False), "none": (None, False)}
    f32 = mm_dtype == "float32"
    out = {"log_w": log_w, "rows": rows, "E": E, "mm_dtype": mm_dtype,
           **bounds_ms(rows, log_w, E, mm_dtype), "kernels": {}}
    a, b = wht_cuda.split_ab(w)
    mm = wht_cuda.MM_DTYPES[mm_dtype]
    ha = wht_cuda.hadamard_factor(a, mm, dev)
    hb = wht_cuda.hadamard_factor(b, mm, dev)
    xb = xg.reshape(rows, a, b).to(mm)
    out["library_ms"] = cuda_ms(lambda: ha @ (xb @ hb), reps)
    del xb
    ops = (f"the transform's w log2 w adds {out['transform_operations_ms']:.4f} ms, "
           f"three bf16 products {out['operations_ms']:.4f} ms" if f32
           else f"operations {out['operations_ms']:.4f} ms")
    print(f"2^{log_w} ({rows} rows, E={E}, {mm_dtype} operands): bound bytes "
          f"{out['bytes_ms']:.4f} ms ({out['bytes_unsigned_ms']:.4f} without signs), "
          f"{ops}; cuBLAS {mm_dtype} pair {out['library_ms']:.4f} ms", flush=True)
    ternary = {}
    for kernel in kernels:
        res = {}
        for m, (sg, pre) in modes.items():
            got = wht_cuda.fwht_signed_2mm(xt, sg, pre, mm_dtype, kernel=kernel)
            want = wht_cuda.fwht_signed_ref(xt, sg, pre)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"K2 2^{log_w} {kernel} {m}: not bit-equal on "
                                     f"ternary rows ({bad} of {got.numel()} entries)")
            if m in ternary and not torch.equal(got, ternary[m]):
                raise AssertionError(f"K2 2^{log_w} {m}: the kernels differ on "
                                     f"ternary rows")
            ternary[m] = got
            got = wht_cuda.fwht_signed_2mm(xg, sg, pre, mm_dtype, kernel=kernel)
            want = wht_cuda.fwht_signed_2mm_ref(xg, sg, pre, mm_dtype)
            torch.cuda.synchronize()
            ctl = None
            if f32:
                rel = float((got - want).abs().max() / want.abs().max())
                bound = F32_ABS_BOUND
                ctl = float((two_plane_ref(xg, sg, pre) - want).abs().max()
                            / want.abs().max())
            else:
                rel, bound = float((got - want).norm() / want.norm()), REL_BOUND
            del got, want
            if not rel <= bound:
                raise AssertionError(f"K2 2^{log_w} {kernel} {m}: relative error "
                                     f"{rel} > {bound}")
            ms = cuda_ms(lambda: wht_cuda.fwht_signed_2mm(xg, sg, pre, mm_dtype,
                                                          kernel=kernel), reps)
            res[m] = {"ms": ms, "rel_err": rel}
            text = f"2^{log_w} {kernel:5s} {m:4s}: {ms:.4f} ms, rel {rel:.2e}"
            if ctl is not None:
                res[m]["control_rel_err"] = ctl
                text += f" (control without the lo plane {ctl:.2e})"
            if two_launches(log_w, kernel, mm_dtype):
                for p in (1, 2):
                    res[m][f"launch{p}_ms"] = cuda_ms(
                        lambda: wht_cuda.fwht_signed_2mm(xg, sg, pre, mm_dtype,
                                                         kernel=kernel, passes=p), reps)
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
    ap.add_argument("--mm-dtype", choices=sorted(wht_cuda.MM_DTYPES), default="bfloat16",
                    help="K2's operand type")
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
        mma_top = (wht_cuda.MAX_LOG_W_2MM if args.mm_dtype == "float32"
                   else wht_cuda.TILE_MAX_LOG_W_2MM)
        kernels = [args.kernel] if args.kernel else [k for k, (lo, hi) in (
            ("wgmma", (wht_cuda.WGMMA_MIN_LOG_W, wht_cuda.MAX_LOG_W_2MM)),
            ("mma", (wht_cuda.MIN_LOG_W_2MM, mma_top))) if lo <= log_w <= hi]
        result["widths"].append(run_width(log_w, args.rows, args.E, kernels, args.reps,
                                          args.mm_dtype))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
