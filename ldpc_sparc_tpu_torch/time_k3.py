"""Check and time K3, the fused AMP denoiser tail, on the card.

    python -m ldpc_sparc_tpu_torch.time_k3
    python -m ldpc_sparc_tpu_torch.time_k3 --shape 256 64 8192 --shape 4 8 1048576

For each (batch, sections, M): `fused_denoise_update` against its plain
version `fused_denoise_update_ref` on the inputs chip_smoke.py's phase 21
makes (beta a softmax of 3 randn per section, azo 2 randn, tau in [0.5, 2)):
s bit-equal, beta_new and the energies within rtol 1e-5 (atol 1e-12, so
every entry of a long section is held); then both timed by CUDA events,
beside the least the card could take for the bytes (beta and azo read,
s and beta_new written, tau and the energies once) at 3.35 TB/s. With --out
the numbers are also written as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .ops import denoiser_cuda
from .time_fwht import HBM_BYTES_PER_S, cuda_ms

SHAPES = ((256, 64, 1 << 13), (64, 32, 1 << 14), (32, 16, 1 << 15),
          (16, 16, 1 << 16), (4, 8, 1 << 20))


def run_shape(B: int, L: int, M: int, reps: int) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(M)
    beta = torch.softmax(3 * torch.randn(B, L, M, generator=gen, device=dev),
                         -1).reshape(B, -1)
    azo = 2 * torch.randn(B, L * M, generator=gen, device=dev)
    tau = 0.5 + 1.5 * torch.rand(B, L, generator=gen, device=dev)
    got = denoiser_cuda.fused_denoise_update(beta, azo, tau, M)
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"K3 ({B}, {L}, {M}): s is not bit-equal")
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-12)
    rel = [float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
           for g, w in zip(got[1:], want[1:])]
    del got, want
    n = B * L * M
    out = {"shape": [B, L, M], "bound_ms": 1e3 * 4 * (4 * n + 2 * B * L) / HBM_BYTES_PER_S,
           "ms": cuda_ms(lambda: denoiser_cuda.fused_denoise_update(beta, azo, tau, M), reps),
           "plain_ms": cuda_ms(lambda: denoiser_cuda.fused_denoise_update_ref(
               beta, azo, tau, M), max(1, reps // 4)),
           "rel_err_beta_new": rel[0], "rel_err_sec_en": rel[1]}
    print(f"({B}, {L}, 2^{M.bit_length() - 1}): {out['ms']:.4f} ms (plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms by bytes), max rel "
          f"err beta_new {rel[0]:.2e} sec_en {rel[1]:.2e}", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, action="append", default=None,
                    metavar=("B", "L", "M"), help="default: " + str(SHAPES))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_k3: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    result = {"card": card,
              "shapes": [run_shape(B, L, M, args.reps) for B, L, M in args.shape or SHAPES]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
