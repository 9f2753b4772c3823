"""Check and time K3, the fused AMP denoiser tail, on the card, route by route.

    python -m ldpc_sparc_tpu_torch.time_k3
    python -m ldpc_sparc_tpu_torch.time_k3 --shape 256 64 8192 --shape 4 8 1048576

For each (batch, sections, M) and each route that takes M ("block" at
every M, "cluster" from 2^16): `fused_denoise_update` against its plain
version `fused_denoise_update_ref` on the inputs chip_smoke.py's phase 21
makes (beta a softmax of 3 randn per section, azo 2 randn, tau in [0.5, 2)):
s bit-equal, beta_new and the energies within rtol 1e-5 (atol 1e-12, so
every entry of a long section is held), and a second run bit-equal to the
first; then every route and the plain version timed by CUDA events on the
same inputs, in turns, beside the least the card could take for the bytes
(beta and azo read, s and beta_new written, tau and the energies once) at
3.35 TB/s and each route's share of it. Then the AMP loop's freeze at
(256, 1024, 512), the flagship's step: the call with `stopped` on 0 %,
67 % and 100 % of the rows (a stopped row reads beta and the last s and
writes s and beta_new, the same 16 bytes an entry as a live one), checked
against the call without it and timed in turns beside it and the same
bound. With --out the numbers are also written as JSON. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from .ops import denoiser_cuda
from .time_fwht import HBM_BYTES_PER_S, cuda_ms

FREEZE_SHAPE, FREEZE_SHARES = (256, 1024, 512), (0, 67, 100)
SHAPES = ((256, 64, 1 << 13), (64, 32, 1 << 14), (32, 16, 1 << 15),
          (16, 16, 1 << 16), (8, 8, 1 << 17), (4, 4, 1 << 19), (4, 8, 1 << 20),
          (1, 4, 1 << 22))


def _inputs(B: int, L: int, M: int):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(M)
    beta = torch.softmax(3 * torch.randn(B, L, M, generator=gen, device=dev),
                         -1).reshape(B, -1)
    azo = 2 * torch.randn(B, L * M, generator=gen, device=dev)
    tau = 0.5 + 1.5 * torch.rand(B, L, generator=gen, device=dev)
    return gen, beta, azo, tau


def bound_ms(B: int, L: int, M: int) -> float:
    """The least time by bytes: 16 an entry, 8 a section, at HBM bandwidth."""
    return 1e3 * 4 * (4 * B * L * M + 2 * B * L) / HBM_BYTES_PER_S


def run_shape(B: int, L: int, M: int, reps: int) -> dict:
    _, beta, azo, tau = _inputs(B, L, M)
    routes = [r for r in denoiser_cuda.ROUTES
              if r == "block" or M >= denoiser_cuda.CLUSTER_MIN_M]
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    rel = {}
    for route in routes:
        got = denoiser_cuda.fused_denoise_update(beta, azo, tau, M, route)
        again = denoiser_cuda.fused_denoise_update(beta, azo, tau, M, route)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"K3 {route} ({B}, {L}, {M}): s is not bit-equal")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"K3 {route} ({B}, {L}, {M}): two runs differ")
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-12)
        rel[route] = [float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
                      for g, w in zip(got[1:], want[1:])]
        del got, again
    del want
    bound = bound_ms(B, L, M)
    ms = {r: float("inf") for r in routes}
    for turn in (routes, routes[::-1]):   # in turns: a, b, b, a
        for r in turn:
            ms[r] = min(ms[r], cuda_ms(lambda: denoiser_cuda.fused_denoise_update(
                beta, azo, tau, M, r), reps))
    out = {"shape": [B, L, M], "bound_ms": bound, "default": denoiser_cuda.k3_route(M),
           "routes": {r: {"ms": ms[r], "share": bound / ms[r], "rel_err_beta_new": rel[r][0],
                          "rel_err_sec_en": rel[r][1]} for r in routes},
           "plain_ms": cuda_ms(lambda: denoiser_cuda.fused_denoise_update_ref(
               beta, azo, tau, M), max(1, reps // 4))}
    print(f"({B}, {L}, 2^{M.bit_length() - 1}): " + ", ".join(
        f"{r} {v['ms']:.4f} ms ({100 * v['share']:.0f} % of the bound; max rel err "
        f"beta_new {v['rel_err_beta_new']:.2e} sec_en {v['rel_err_sec_en']:.2e})"
        for r, v in out["routes"].items())
        + f"; plain {out['plain_ms']:.4f} ms, bound {bound:.4f} ms by bytes; default "
        f"{out['default']}", flush=True)
    return out


def run_freeze(B: int, L: int, M: int, reps: int) -> dict:
    """The call with `stopped` on each share of FREEZE_SHARES of the rows
    against the call without it: live rows bit-equal, stopped rows copied;
    then all timed in turns, writing into the same two buffers."""
    gen, beta, azo, tau = _inputs(B, L, M)
    s_prev = torch.randn(B, L * M, generator=gen, device=beta.device)
    out = (torch.empty_like(beta), torch.empty_like(beta))
    want = denoiser_cuda.fused_denoise_update(beta, azo, tau, M)
    masks = {}
    for share in FREEZE_SHARES:
        stopped = torch.zeros(B, dtype=torch.bool, device=beta.device)
        stopped[torch.randperm(B, generator=gen, device=beta.device)[:round(B * share / 100)]] = True
        got = denoiser_cuda.fused_denoise_update(beta, azo, tau, M, stopped=stopped,
                                                 s_prev=s_prev, out=out)
        live = ~stopped
        if not (all(torch.equal(g[live], w[live]) for g, w in zip(got, want))
                and torch.equal(got[0][stopped], s_prev[stopped])
                and torch.equal(got[1][stopped], beta[stopped])):
            raise AssertionError(f"K3 with {share} % of the rows stopped: not the "
                                 "unmasked call's live rows and the stopped rows' copy")
        masks[share] = stopped
    del want, got
    calls = {"none": lambda: denoiser_cuda.fused_denoise_update(beta, azo, tau, M, out=out)}
    for share, stopped in masks.items():
        calls[f"{share}%"] = (lambda st: lambda: denoiser_cuda.fused_denoise_update(
            beta, azo, tau, M, stopped=st, s_prev=s_prev, out=out))(stopped)
    ms = {k: float("inf") for k in calls}
    for turn in (list(calls), list(calls)[::-1]):
        for k in turn:
            ms[k] = min(ms[k], cuda_ms(calls[k], reps))
    bound = bound_ms(B, L, M)
    res = {"shape": [B, L, M], "bound_ms": bound,
            "stopped": {k: {"ms": v, "share": bound / v} for k, v in ms.items()}}
    print(f"freeze ({B}, {L}, 2^{M.bit_length() - 1}), rows stopped: " + ", ".join(
        f"{k} {v['ms']:.4f} ms ({100 * v['share']:.1f} % of the bound)"
        for k, v in res["stopped"].items()) + f"; bound {bound:.4f} ms by bytes", flush=True)
    return res


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
              "shapes": [run_shape(B, L, M, args.reps) for B, L, M in args.shape or SHAPES],
              "freeze": run_freeze(*FREEZE_SHAPE, args.reps)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
