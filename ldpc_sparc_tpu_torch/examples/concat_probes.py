"""Per-AMP-iteration BER probes of the interleaved and integrated decoders.

    python -m ldpc_sparc_tpu_torch.examples.concat_probes [--small]
        [--seeds 3] [--snr 3.14] [--device cpu] [--out concat_probes.png]
        [--json concat_probes.json]

Counterpart of the JAX package's `examples/concat_probes.py` (the
reference's instrumented `*_test` decoders): `ConcatCodec.decode_instrumented`
gives the user-bit decisions before and after the inner BP pass at every
AMP iteration, and this script averages their error rates over --seeds
trials at the reference's working configuration, 802.16 r=1/2 z=150,
mults 4, M=2, t_max 25 (--small: z=12, mults 2, t_max 8). Trial `seed`:
the design, the user bits and the noise from that seed, as
`ConcatCodec.encode(seed)` and the generator of (seed, CHANNEL) draw them.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import save_figure, wall

DECODERS = ("naive", "integrated")


def problem(small: bool):
    """(codec, decode params) of the working configuration or the small one."""
    from ldpc_sparc_tpu_torch import (ConcatCodec, DecodeParams, LdpcParams,
                                      SparcParams, get_code, param_calc)
    if small:
        ldpc, mults, t_max = LdpcParams(standard="802.16", rate="1/2", z=12), 2, 8
    else:
        ldpc, mults, t_max = LdpcParams(standard="802.16", rate="1/2", z=150), 4, 25
    code = get_code(ldpc.standard, ldpc.rate, ldpc.z)
    _, _, L, lengths = param_calc(mults=mults, logM=1, ldpc=ldpc,
                                  int_rate=ldpc.rate_float, R_sparc_ldpc=1.0,
                                  ldpc_K=code.K)
    sp = SparcParams(P=19.44, R=1.0, L=L, M=2)
    return ConcatCodec(sp, ldpc, lengths, ldpc_protected=True), DecodeParams(t_max=t_max)


def trial(codec, dec, seed, awgn_var, decoder, device, **decode_kw):
    """(user bits, decode_instrumented's probes) of trial `seed`; decode_kw
    goes to decode_instrumented (fwht_kernel, bp_kernel)."""
    from ldpc_sparc_tpu_torch.models.sparc import awgn_channel
    from ldpc_sparc_tpu_torch.utils import rng as rngmod
    user_bits, _, _, x, design = codec.encode(seed, device=device)
    y = awgn_channel(x, awgn_var, rngmod.root_generator(
        rngmod.derive(seed, rngmod.CHANNEL), device))
    return user_bits, codec.decode_instrumented(y, design, dec, decoder, **decode_kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--small", action="store_true", help="z=12: a CPU run")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--snr", type=float, default=3.14,
                    help="linear snr (awgn_var = P/snr), mid-waterfall")
    ap.add_argument("--out", default="concat_probes.png")
    ap.add_argument("--json", default=None, help="write the probes here")
    args = ap.parse_args(argv)

    from ldpc_sparc_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    codec, dec = problem(args.small)
    awgn_var = codec.sparc.P / args.snr
    probes, walls = {}, {}
    for decoder in DECODERS:
        pre, post = np.zeros(dec.t_max), np.zeros(dec.t_max)

        def run():
            for seed in range(args.seeds):
                ub, out = trial(codec, dec, seed, awgn_var, decoder, dev)
                pre[:] += (out["pre_bp"] != ub).double().mean(-1).cpu().numpy()
                post[:] += (out["post_bp"] != ub).double().mean(-1).cpu().numpy()

        _, walls[decoder] = wall(run, dev)
        probes[decoder] = {"pre_bp": (pre / args.seeds).tolist(),
                           "post_bp": (post / args.seeds).tolist()}
        print(f"{decoder}: first pre-BP BER {probes[decoder]['pre_bp'][0]:.4g}, "
              f"final post-BP BER {probes[decoder]['post_bp'][-1]:.4g} "
              f"({walls[decoder]:.2f} s for {args.seeds} seeds)", flush=True)
    ld = codec.ldpc_params
    result = {"device": str(dev),
              "config": {"standard": ld.standard, "rate": ld.rate, "z": ld.z,
                         "mults": codec.lengths.mults, "logM": 1, "snr": args.snr,
                         "t_max": dec.t_max, "seeds": args.seeds,
                         "user_bits": codec.user_bits_len},
              "wall_s": walls, "probes": probes}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.json}")

    def draw(plt):
        fig, axes = plt.subplots(1, 2, figsize=(11, 4), sharey=True)
        floor = 1e-5
        for ax, decoder in zip(axes, probes):
            p = probes[decoder]
            ax.semilogy(np.array(p["pre_bp"]) + floor, "o-", label="pre-BP (after MMSE)")
            ax.semilogy(np.array(p["post_bp"]) + floor, "s-",
                        label="post-BP (after inner BP)")
            ax.set_title(f"{decoder} decoder")
            ax.set_xlabel("AMP iteration")
            ax.grid(True, which="both", alpha=0.3)
            ax.legend()
        axes[0].set_ylabel(f"user-bit BER + {floor:g}")
        fig.suptitle(f"Per-iteration BER probes, {ld.standard} {ld.rate} z={ld.z}, "
                     f"snr={args.snr}")
        return fig

    save_figure(draw, args.out)
    return result


if __name__ == "__main__":
    main()
