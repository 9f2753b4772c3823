"""Command-line entry points of the port: the SPARC BER sweep and the
concatenated LDPC-SPARC decoder sweep.

    python -m ldpc_sparc_tpu_torch.cli sparc-sweep --L 1024 --M 32 --R 1.3 ...
    python -m ldpc_sparc_tpu_torch.cli concat-sweep --z 150 --runs 20 ...

Counterparts of `ldpc_sparc_tpu/cli.py`'s `sparc-sweep` and `concat-sweep`,
with their flags less `--platform` (here `--device`), plus
`--fwht-mode {ms,2mm}` and `--no-fused-denoiser` on `sparc-sweep`, which
takes every family: `--modulated --K 2|4|8` (K > 2 is complex),
`--complex`, and `--design-engine dft` for complex plain codes. Rows go to
the resumable JSONL stores `<out>/sparc_sweep.jsonl` and
`<out>/concat_sweep[_semi].jsonl` under the JAX CLI's keys, so a sweep
rerun into the same `--out` returns the stored rows instead of decoding
them again, whichever package wrote them. The design engine, `fwht_mode`
and the denoiser tail join the SPARC configuration key only when they are
not the defaults: another ensemble, K2's bf16 operands and the plain
tail's stop are different computations. `concat-sweep` writes no figure
yet (the plotting functions are not ported). The other subcommands are
not ported yet (ROADMAP.md).
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


def _add_common(p):
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="results")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; an error when "
                        "there is none; 'cpu' asks for the CPU)")


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
    engine, the FWHT mode and the denoiser tail join it only when not at
    their defaults."""
    extra = {} if args.design_engine == "srht" else {"engine": args.design_engine}
    if args.fwht_mode != "ms":
        extra["fwht_mode"] = args.fwht_mode
    if args.no_fused_denoiser:
        extra["fused_denoiser"] = False
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
                                fwht_mode=args.fwht_mode, device=device,
                                fused_denoiser=False if args.no_fused_denoiser
                                else None)
        row["snr_db"] = float(10 * np.log10(snr))
        row["snr"] = float(snr)
        store.append(key, row)
        rows.append({"key": key, **row})
        line = {"snr": float(snr), "ber": row["ber"], "ser": row["ser"]}
        if "ler" in row:
            line.update(ler=row["ler"], ver=row["ver"])
        print(json.dumps(line), flush=True)
    return rows


def concat_setup(args):
    """(ldpc, sp_plain, sp_ldpc, lengths, overall rate, L_sparc) of a
    concat-sweep's arguments: the fully protected bookkeeping, or the
    second configuration block of performance_plots_general.py:50-65."""
    from .config import (LdpcParams, SparcParams, param_calc,
                         param_calc_semi_protected)
    from .models.ldpc import get_code
    ldpc = LdpcParams(standard=args.standard, rate=args.rate, z=args.z)
    code = get_code(args.standard, args.rate, args.z)
    if args.semi_protected:
        L_sparc, R_sparc_ldpc, L_sparc_ldpc, lengths, rate = \
            param_calc_semi_protected(args.R_sparc, args.mults,
                                      args.percent_protected, 2 ** args.logM,
                                      ldpc, ldpc.rate_float, code.K)
    else:
        rate, L_sparc, L_sparc_ldpc, lengths = param_calc(
            args.mults, args.logM, ldpc, ldpc.rate_float, args.R_sparc, code.K)
        R_sparc_ldpc = args.R_sparc
    sp_plain = SparcParams(P=args.P, R=rate, L=L_sparc, M=2 ** args.logM)
    sp_ldpc = SparcParams(P=args.P, R=R_sparc_ldpc, L=L_sparc_ldpc,
                          M=2 ** args.logM)
    return ldpc, sp_plain, sp_ldpc, lengths, rate, L_sparc


def concat_config_key(args, ldpc, sp_plain, sp_ldpc, lengths) -> str:
    """The concat-sweep resume key's configuration hash, the JAX CLI's
    (store_version=2: rows under the linear-SNR convention with both 'snr'
    and 'snr_db')."""
    return _config_key(ldpc=ldpc, sp_plain=sp_plain, sp_ldpc=sp_ldpc,
                       lengths=lengths, t_max=args.t_max, runs=args.runs,
                       semi=args.semi_protected, store_version=2)


def concat_meta(args, rate, L_sparc, sp_ldpc, lengths) -> dict:
    """The one meta record per configuration that makes a store describe
    itself."""
    return {"config": {
        "standard": args.standard, "rate": args.rate, "z": args.z,
        "P": args.P, "mults": args.mults, "logM": args.logM,
        "R_sparc": args.R_sparc, "t_max": args.t_max, "runs": args.runs,
        "semi_protected": bool(args.semi_protected),
        "percent_protected": (float(args.percent_protected)
                              if args.semi_protected else 1.0),
        "overall_rate": float(rate), "L_sparc": int(L_sparc),
        "L_sparc_ldpc": int(sp_ldpc.L),
        "lengths": {"k_ldpc": int(lengths.k_ldpc), "mults": int(lengths.mults),
                    "L_unprotected": int(lengths.L_unprotected)}}}


def cmd_concat_sweep(args):
    from .config import DecodeParams
    from .device import resolve_device
    from .io.results import ResultsStore
    from .parallel.montecarlo import concat_ber_point

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"concat-sweep: {err}")
    ldpc, sp_plain, sp_ldpc, lengths, rate, L_sparc = concat_setup(args)
    decode = DecodeParams(t_max=args.t_max)
    decoders = args.decoders.split(",")
    snrs = np.linspace(args.snr_start, args.snr_stop, args.num_snrs)
    stem = "concat_sweep_semi" if args.semi_protected else "concat_sweep"
    store = ResultsStore(Path(args.out) / f"{stem}.jsonl")
    cfg_key = concat_config_key(args, ldpc, sp_plain, sp_ldpc, lengths)
    meta_key = f"meta:{cfg_key}"
    if not store.has(meta_key):
        store.append(meta_key, concat_meta(args, rate, L_sparc, sp_ldpc, lengths))
    series = {d: [] for d in decoders}
    for snr in snrs:
        awgn_var = args.P / snr          # the concat axis is linear SNR
        for d in decoders:
            key = f"concat:{cfg_key}:{d}:snr{snr:.3f}:s{args.seed}"
            if store.has(key):
                series[d].append(store.get(key))
                continue
            sp = sp_plain if d == "amp_only" else sp_ldpc
            row = concat_ber_point(sp, ldpc, lengths, d != "amp_only", decode,
                                   awgn_var, (args.seed, 0), n_trials=args.runs,
                                   decoder=d, device=device)
            row.update({"snr": float(snr), "snr_db": float(10 * np.log10(snr)),
                        "decoder": d})
            store.append(key, row)
            series[d].append(row)
            print(json.dumps(row), flush=True)
    if args.save_npz:
        # the reference plotting script's snapshot layout
        # (performance_plots_general.py:138-139): (num_sims, num_snrs) arrays
        np.savez(args.save_npz, snr_store=snrs, **{
            name: np.array([[r[col] for r in series[d]] for d in decoders])
            for name, col in (("ber_store_averages", "ber"),
                              ("ber_store_max", "ber_max"),
                              ("ber_store_min", "ber_min"))})
    return series


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ldpc_sparc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sparc-sweep", help="SPARC AMP BER sweep")
    _add_common(p)
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
                   help="K-PSK modulated SPARC (K > 2 implies --complex)")
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--complex", action="store_true",
                   help="complex SPARC (complex channel)")
    p.add_argument("--design-engine", choices=("srht", "dft"), default="srht",
                   help="design ensemble: the real SRHT (every family) or the "
                        "reference's complex subsampled DFT (complex plain codes)")
    p.add_argument("--fwht-mode", choices=("ms", "2mm"), default="ms",
                   help="design-product transform: ms = K1 (float32), "
                        "2mm = K2 (bf16 operands, two tensor-core products)")
    p.add_argument("--no-fused-denoiser", action="store_true",
                   help="take the plain denoiser tail, whose stop fires where "
                        "the JAX package's does (the fused tail K3 may stop one "
                        "iteration later)")
    p.set_defaults(fn=cmd_sparc_sweep)

    p = sub.add_parser("concat-sweep", help="concatenated decoder BER sweep")
    _add_common(p)
    p.add_argument("--standard", default="802.16")
    p.add_argument("--rate", default="1/2")
    p.add_argument("--z", type=int, default=150)
    p.add_argument("--P", type=float, default=19.44)
    p.add_argument("--mults", type=int, default=4)
    p.add_argument("--logM", type=int, default=1)
    p.add_argument("--R-sparc", type=float, default=1.0)
    p.add_argument("--t-max", type=int, default=25)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--num-snrs", type=int, default=10)
    p.add_argument("--snr-start", type=float, default=2.0)
    p.add_argument("--snr-stop", type=float, default=6.0)
    p.add_argument("--decoders", default="amp_only,sequential,naive,integrated")
    p.add_argument("--semi-protected", action="store_true",
                   help="unprotected section prefix + LDPC-protected rest "
                        "(performance_plots_general.py semi_protected=True)")
    p.add_argument("--percent-protected", type=float, default=0.6)
    p.add_argument("--save-npz", default=None,
                   help="also save the reference's Test_N.npz snapshot layout "
                        "(performance_plots_general.py:138-139)")
    p.set_defaults(fn=cmd_concat_sweep)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
