"""Command-line entry point of the port: the SPARC BER sweep.

    python -m ldpc_sparc_tpu_torch.cli sparc-sweep --L 1024 --M 32 --R 1.3 ...

Counterpart of `ldpc_sparc_tpu/cli.py`'s `sparc-sweep`, with its flags less
`--platform` (here `--device`) and the complex `dft` design engine, plus
`--fwht-mode {ms,2mm}`. Rows go to the resumable JSONL store
`<out>/sparc_sweep.jsonl` under the JAX CLI's keys, so a sweep rerun into
the same `--out` returns the stored rows instead of decoding them again,
whichever package wrote them. `fwht_mode` joins the configuration key only
when it is not "ms": K2's bf16 operands are a different computation.
The other subcommands are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import hashlib
import json
from pathlib import Path

import numpy as np


def _config_key(**fields) -> str:
    """Short stable hash of the full sweep configuration (the JAX CLI's)."""
    blob = json.dumps({k: repr(v) for k, v in sorted(fields.items())},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def sparc_params_from_args(args):
    from .config import SparcParams
    kwargs = dict(P=args.P, R=args.R, L=args.L, M=args.M)
    if args.spatially_coupled:
        kwargs.update(spatially_coupled=True, omega=args.omega, Lambda=args.Lambda)
    if args.power_allocated:
        kwargs.update(power_allocated=True, B=args.B, R_PA_ratio=args.R_PA_ratio)
    if args.modulated:
        kwargs.update(modulated=True, K=args.K, is_complex=args.complex or args.K > 2)
    elif args.complex:
        kwargs.update(is_complex=True)
    return SparcParams(**kwargs)


def sweep_config_key(args, params) -> str:
    """The resume key's configuration hash, as the JAX CLI computes it: the
    engine and the FWHT mode join it only when not at their defaults."""
    extra = {} if args.design_engine == "srht" else {"engine": args.design_engine}
    if args.fwht_mode != "ms":
        extra["fwht_mode"] = args.fwht_mode
    return _config_key(params=params, t_max=args.t_max, trials=args.trials, **extra)


def cmd_sparc_sweep(args):
    from .config import DecodeParams
    from .device import resolve_device
    from .io.results import ResultsStore
    from .parallel.montecarlo import sparc_ber_sweep

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"sparc-sweep: {err}")
    params = sparc_params_from_args(args)
    decode = DecodeParams(t_max=args.t_max)
    snrs = np.linspace(args.snr_start, args.snr_stop, args.num_snrs)
    store = ResultsStore(Path(args.out) / "sparc_sweep.jsonl")
    cfg_key = sweep_config_key(args, params)
    rows = []
    for snr in snrs:
        key = f"sparc:{cfg_key}:snr{snr:.3f}:s{args.seed}"
        if store.has(key):
            rows.append(store.get(key))
            continue
        [row] = sparc_ber_sweep(params, decode, [params.P / snr], args.seed,
                                args.trials, engine=args.design_engine,
                                fwht_mode=args.fwht_mode, device=device)
        row["snr_db"] = float(10 * np.log10(snr))
        row["snr"] = float(snr)
        store.append(key, row)
        rows.append({"key": key, **row})
        print(json.dumps({"snr": float(snr), "ber": row["ber"], "ser": row["ser"]}),
              flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ldpc_sparc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sparc-sweep", help="SPARC AMP BER sweep")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="results")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; an error when "
                        "there is none; 'cpu' asks for the CPU)")
    p.add_argument("--P", type=float, default=15.0)
    p.add_argument("--R", type=float, default=1.3)
    p.add_argument("--L", type=int, default=1024)
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--t-max", type=int, default=25)
    p.add_argument("--trials", type=int, default=64)
    p.add_argument("--num-snrs", type=int, default=8)
    p.add_argument("--snr-start", type=float, default=6.0)
    p.add_argument("--snr-stop", type=float, default=20.0)
    p.add_argument("--spatially-coupled", action="store_true")
    p.add_argument("--omega", type=int, default=6)
    p.add_argument("--Lambda", type=int, default=32)
    p.add_argument("--power-allocated", action="store_true")
    p.add_argument("--B", type=int, default=32)
    p.add_argument("--R-PA-ratio", type=float, default=1.0)
    p.add_argument("--modulated", action="store_true",
                   help="K-PSK modulated SPARC (not ported: raises)")
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--complex", action="store_true",
                   help="complex design (not ported: raises)")
    p.add_argument("--design-engine", choices=("srht",), default="srht",
                   help="design ensemble: the real SRHT (the complex 'dft' "
                        "engine is not ported)")
    p.add_argument("--fwht-mode", choices=("ms", "2mm"), default="ms",
                   help="design-product transform: ms = K1 (float32), "
                        "2mm = K2 (bf16 operands, two tensor-core products)")
    p.set_defaults(fn=cmd_sparc_sweep)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
