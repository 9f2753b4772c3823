"""Where the time of one batched decode goes on the card.

    python -m ldpc_sparc_tpu_torch.profile_decode [--path amp|sc|mod|bp|concat] [--batch 256] [--out FILE]

Builds the problem of the path: for `amp` (the default) `bench.py`'s plain
SPARC at L=1024, M=512, R=1.0, P=15, awgn_var 1, t_max 25, seed 0; for
`sc` the spatially coupled SPARC of `chip_smoke.py` phase 10 (L=2048,
M=512, omega=6, Lambda=32, R=1.5, P=15, awgn_var 1, t_max 40, seed 0); for
`mod` the complex K=4 PSK code of `chip_smoke.py` phase 14 (L=2048, M=8,
R=2.6, P=15, awgn_var 1, t_max 25, seed 0, `--batch` codewords, 128 unless
given); for `bp` 802.11n r=1/2 z=27 codewords at sigma^2 = 10^-0.2, decoded by
sumprod2 for at most 50 iterations; for `concat` the z=150 concatenated
point `bench.py` times (802.16 r=1/2, mults=4, M=2, L=14,400, P=19.44,
R=1.0, t_max 25, awgn_var P/3.8, seed (3, 0), `--batch` trials, 20 unless
given), made as the Monte Carlo makes it and decoded by `decode_batch`
with the `integrated` decoder. It decodes once to warm up, then traces
one decode of each kernel path (for `sc`: K1+K3 and K2+K3) and one of the
plain path with `torch.profiler`.
For each it prints the wall time (host clock around a synchronised decode),
the device time summed over kernels, the device's idle share of the wall
time, and the kernels by device time. With --out it also writes the
numbers as JSON. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import (ConcatCodec, DecodeParams, LdpcParams, SparcDesign, SparcParams,
               get_code, param_calc)
from .models.sparc import awgn_channel, decode_batch
from .parallel.montecarlo import concat_mc_designs, concat_mc_transmit
from .utils import bits as bitops


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _trace(fn) -> dict:
    fn()                                   # warm: build, allocator, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only: kernels, memsets, copies (the aten:: ops that
    # launched them carry the same time again; "Command Buffer Full" marks
    # host stalls on a full launch queue, not device work)
    rows = [(e.key, e.count, _device_us(e) / 1e3) for e in prof.key_averages()
            if not e.key.startswith(("aten::", "cuda"))
            and e.key != "Command Buffer Full"]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "launches": sum(r[1] for r in rows),
            "ops": [{"name": k, "count": c, "device_ms": ms} for k, c, ms in rows]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("amp", "sc", "mod", "bp", "concat"), default="amp")
    ap.add_argument("--batch", type=int, default=None,
                    help="codewords or trials a decode (256; mod: 128; concat: 20)")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_decode: needs a CUDA device")
    if args.batch is None:
        args.batch = {"concat": 20, "mod": 128}.get(args.path, 256)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": torch.cuda.get_device_name(0), "path": args.path,
           "batch": args.batch}
    if args.path in ("amp", "sc", "mod"):
        params, decode, awgn_var = SparcParams(P=15.0, R=1.0, L=1024, M=512), \
            DecodeParams(t_max=25), 1.0
        if args.path == "sc":
            params = SparcParams(P=15.0, R=1.5, L=2048, M=512, spatially_coupled=True,
                                 omega=6, Lambda=32)
            decode = DecodeParams(t_max=40)
        elif args.path == "mod":
            params = SparcParams(P=15.0, R=2.6, L=2048, M=8, modulated=True, K=4,
                                 is_complex=True)
            out["iterations"] = decode.t_max - 1
        design = SparcDesign.for_params(params, awgn_var, seed=0, device=dev)
        bits = bitops.random_bits(gen, args.batch * params.bit_len).reshape(
            args.batch, params.bit_len)
        y = awgn_channel(design.ab(bitops.bits_to_msg_vector(bits, params.M, params.K)),
                         awgn_var, gen)
        paths = {"kernel": lambda: decode_batch(y, design, params, decode, awgn_var),
                 **({"kernel-2mm": lambda: decode_batch(
                     y, design, params, decode, awgn_var, fwht_mode="2mm")}
                    if args.path == "sc" else {}),
                 "plain": lambda: decode_batch(y, design, params, decode, awgn_var,
                                               fused_denoiser=False,
                                               fwht_kernel=False)}
    elif args.path == "concat":
        ldpc = LdpcParams("802.16", "1/2", 150)
        _, _, L, lengths = param_calc(4, 1, ldpc, 0.5, 1.0, get_code("802.16", "1/2", 150).K)
        codec = ConcatCodec(SparcParams(P=19.44, R=1.0, L=L, M=2), ldpc, lengths, True)
        decode, awgn_var, seed = DecodeParams(t_max=25), 19.44 / 3.8, (3, 0)
        designs = concat_mc_designs(codec, seed, args.batch, device=dev)
        _, ys = concat_mc_transmit(codec, designs, awgn_var, seed)
        out["iterations"] = decode.t_max
        paths = {"kernel": lambda: codec.decode_batch(ys, designs, decode, "integrated"),
                 "plain": lambda: codec.decode_batch(ys, designs, decode, "integrated",
                                                     fwht_kernel=False, bp_kernel=False)}
    else:
        code = get_code("802.11n", "1/2", 27)
        x = code.encode(torch.randint(0, 2, (args.batch, code.K), generator=gen,
                                      device=dev))
        sigma2 = 10 ** -0.2
        llr = 2 / sigma2 * ((1 - 2 * x.float()) + sigma2 ** 0.5 * torch.randn(
            args.batch, code.N, generator=gen, device=dev))
        paths = {"kernel": lambda: code.decode(llr, 50, "sumprod2"),
                 "plain": lambda: code.decode(llr, 50, "sumprod2", bp_kernel=False)}
    for path, fn in paths.items():
        res = _trace(fn)
        out[path] = res
        print(f"{args.path} {path} path, batch {args.batch}: wall {res['wall_ms']:.3f} "
              f"ms, device {res['device_ms']:.3f} ms, idle {res['idle_share']:.3f}"
              + (f", {res['launches']} device launches, "
                 f"{res['launches'] / out['iterations']:.1f} an iteration"
                 if "iterations" in out else ""))
        for op in res["ops"][:args.top]:
            print(f"  {op['device_ms']:10.3f} ms {op['count']:6d}x  "
                  f"{op['name'][:100]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
