"""SPARC demo: the four code families with state-evolution overlays.

    python -m ldpc_sparc_tpu_torch.examples.sparc_demo [--runs 5] [--small]
        [--device cpu] [--out sparc_demo.png] [--json sparc_demo.json]

Counterpart of the JAX package's `examples/sparc_demo.py` (the reference's
sparc_demo notebook): regular, power-allocated, spatially coupled and
modulated complex (K=4 PSK) SPARC runs through `sparc_sim`, each family's
mean NMSE trajectory beside `sparc_se`'s. --small cuts L to 256 (and the
power allocation to 8 blocks) for a CPU run.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import save_figure, wall


def configs(small: bool) -> dict:
    """The four families at the JAX example's sizes, or cut for --small."""
    from ldpc_sparc_tpu_torch import SparcParams
    L, B = (256, 8) if small else (1024, 32)
    return {
        f"regular (L={L},M=32,R=1.3)": SparcParams(P=15.0, R=1.3, L=L, M=32),
        f"power-allocated (B={B},R=1.4)": SparcParams(
            P=15.0, R=1.4, L=L, M=32, power_allocated=True, B=B, R_PA_ratio=1.0),
        "spatially-coupled (w=2,La=8,R=1.4)": SparcParams(
            P=15.0, R=1.4, L=L, M=32, spatially_coupled=True, omega=2, Lambda=8),
        "modulated complex (M=8,K=4,R=2.6)": SparcParams(
            P=15.0, R=2.6, L=2 * L, M=8, is_complex=True, modulated=True, K=4),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--small", action="store_true", help="L=256: a CPU run")
    ap.add_argument("--out", default="sparc_demo.png")
    ap.add_argument("--json", default=None, help="write the per-run numbers here")
    args = ap.parse_args(argv)

    from ldpc_sparc_tpu_torch import DecodeParams, sparc_se, sparc_sim
    from ldpc_sparc_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    dec = DecodeParams(t_max=25)
    awgn_var = 1.0
    stats, curves = {}, {}
    for name, p in configs(args.small).items():
        trajs, times, bers, tf = [], [], [], []
        for seed in range(args.runs):
            r, dt = wall(lambda: sparc_sim(p, dec, awgn_var, seed=seed, device=dev), dev)
            times.append(dt)
            trajs.append(r["nmse"].mean(-1).cpu().numpy())
            bers.append(float(r["ber"]))
            tf.append(int(r["t_final"]))
            print(f"{name}: run {seed}: ber={bers[-1]:.4g} t_final={tf[-1]} "
                  f"{dt:.3f}s", flush=True)
        psi_se, _ = sparc_se(awgn_var, p, dec.t_max, 4000, seed=0, device=dev)
        emp = np.mean(trajs, axis=0)
        se = np.asarray(psi_se).mean(-1)
        curves[name] = (emp, se)
        stats[name] = {"wall_s_per_run": times, "ber": bers, "t_final": tf,
                       "nmse": emp.tolist(), "se_psi": se.tolist()}
    result = {"device": str(dev), "runs_per_config": args.runs, "t_max": dec.t_max,
              "note": "the first run of a family includes the kernels' build "
                      "and warm-up", "configs": stats}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.json}")

    def draw(plt):
        fig, axes = plt.subplots(1, len(curves), figsize=(16, 3.5))
        for ax, (name, (emp, se)) in zip(axes, curves.items()):
            ax.semilogy(emp + 1e-8, "o-", label="AMP (empirical)")
            ax.semilogy(se + 1e-8, "--", label="state evolution")
            ax.set_title(name, fontsize=8)
            ax.set_xlabel("iteration")
            ax.legend(fontsize=7)
            ax.grid(alpha=0.3)
        axes[0].set_ylabel("NMSE")
        return fig

    save_figure(draw, args.out)
    return result


if __name__ == "__main__":
    main()
