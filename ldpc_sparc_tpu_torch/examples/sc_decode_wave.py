"""Spatially coupled decoding wave.

    python -m ldpc_sparc_tpu_torch.examples.sc_decode_wave [--small]
        [--reps 1] [--fwht-mode ms] [--device cpu] [--out sc_decode_wave.png]
        [--json sc_decode_wave.json]

Counterpart of the JAX package's `examples/sc_decode_wave.py` (the
reference's sc_decode_wave notebook, Fig. 3 of Rush, Hsieh, Venkataramanan
2021): for the large SC SPARC (L=2048, M=512, omega=6, Lambda=32, R=1.5,
t_max 40) the per-column-block NMSE psi_c collapses first at the coupling
boundaries and the wave travels inward. One trial a run through
`sparc_sim` (a fresh design each run, as the notebook draws a fresh A);
the first run includes the kernels' build. --small is the JAX script's
L=256, M=32, omega=3, Lambda=8, R=1.4, t_max 20.
"""

from __future__ import annotations

import argparse
import json

from . import save_figure, wall

REFERENCE_CPU_S = (17.4, 24.8)   # the notebook's stored per-run wall clock


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--small", action="store_true", help="reduced size for a CPU run")
    ap.add_argument("--reps", type=int, default=1,
                    help="timed runs after the first")
    ap.add_argument("--fwht-mode", choices=("ms", "2mm", "2mm_f32"), default="ms")
    ap.add_argument("--out", default="sc_decode_wave.png")
    ap.add_argument("--json", default=None, help="write the run's numbers here")
    args = ap.parse_args(argv)

    from ldpc_sparc_tpu_torch import DecodeParams, SparcParams, sparc_sim
    from ldpc_sparc_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    if args.small:
        p = SparcParams(P=15.0, R=1.4, L=256, M=32, spatially_coupled=True,
                        omega=3, Lambda=8)
        t_max = 20
    else:
        p = SparcParams(P=15.0, R=1.5, L=2048, M=512, spatially_coupled=True,
                        omega=6, Lambda=32)
        t_max = 40
    dec = DecodeParams(t_max=t_max)
    awgn_var = 1.0

    def run(seed):
        return sparc_sim(p, dec, awgn_var, seed=seed, device=dev,
                         fwht_mode=args.fwht_mode)

    res, first = wall(lambda: run(0), dev)
    steady = []
    for s in range(args.reps):
        res, dt = wall(lambda: run(s + 1), dev)
        steady.append(dt)
    nmse = res["nmse"].cpu().numpy()   # (t_max, Lc)
    t_final = int(res["t_final"])
    print(f"decode: {first:.2f} s first run (with the build)"
          + (f", {min(steady):.3f} s steady" if steady else "")
          + f", {t_final} iterations, BER {float(res['ber']):.3g} "
          f"(reference CPU: {REFERENCE_CPU_S[0]}-{REFERENCE_CPU_S[1]} s at 33-36 "
          f"iterations)", flush=True)
    result = {"device": str(dev),
              "config": {"L": p.L, "M": p.M, "omega": p.omega, "Lambda": p.Lambda,
                         "R": p.R, "t_max": t_max, "fwht_mode": args.fwht_mode},
              "wall_s_first_run": first, "wall_s_steady": steady,
              "iterations": t_final, "ber": float(res["ber"]),
              "psi_wave": nmse.tolist(), "reference_cpu_s": list(REFERENCE_CPU_S)}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.json}")

    def draw(plt):
        fig, ax = plt.subplots(figsize=(7, 4))
        for t in range(0, nmse.shape[0], max(1, nmse.shape[0] // 10)):
            ax.plot(nmse[t], label=f"t={t}")
        ax.set_xlabel("column block c")
        ax.set_ylabel("NMSE psi_c")
        ax.set_title("SC SPARC decoding wave")
        ax.legend(fontsize=7)
        ax.grid(alpha=0.3)
        return fig

    save_figure(draw, args.out)
    return result


if __name__ == "__main__":
    main()
