"""Command-line entry points of the port.

    python -m ldpc_sparc_tpu_torch.cli sparc-sweep   --L 1024 --M 32 --R 1.3 ...
    python -m ldpc_sparc_tpu_torch.cli ldpc-campaign --sim-id 7 ...
    python -m ldpc_sparc_tpu_torch.cli concat-sweep  --z 150 --runs 20 ...
    python -m ldpc_sparc_tpu_torch.cli results2csv   results.txt results.csv [--native]
    python -m ldpc_sparc_tpu_torch.cli plot-results  results.txt waterfall.pdf

Counterparts of `ldpc_sparc_tpu/cli.py`'s five subcommands, with their
flags less `--platform` (here `--device`: the card by default, an error
where there is none, `--device cpu` for the CPU), plus `--fwht-mode
{ms,2mm,2mm_f32}` and `--no-fused-denoiser` on `sparc-sweep`, which takes every
family: `--modulated --K 2|4|8` (K > 2 is complex), `--complex`, and
`--design-engine dft` for complex plain codes. Rows go to the resumable
JSONL stores `<out>/sparc_sweep.jsonl`, `<out>/ldpc_campaign.jsonl` and
`<out>/concat_sweep[_semi].jsonl` under the JAX CLI's keys, so a rerun
into the same `--out` returns the stored rows instead of decoding them
again, whichever package wrote them. The design engine, `fwht_mode` and
the denoiser tail join the SPARC configuration key only when they are not
the defaults: another ensemble, K2's bf16 or float32 operands and the
plain tail's stop are different computations.

`ldpc-campaign` resumes after the last stored point of its configuration
and then rewrites `<out>/results.txt` and `<out>/results.csv` from the
store, so a rerun duplicates no line; `waterfall.png` follows, and
`concat-sweep` writes `<out>/<stem>.png`. The figures need matplotlib:
without it the records are written all the same and one line on stderr
says that no figure was written.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np


def _config_key(**fields) -> str:
    """Short stable hash of the full sweep configuration (the JAX CLI's)."""
    blob = json.dumps({k: repr(v) for k, v in sorted(fields.items())},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _figure(plot, *args, **kw) -> bool:
    """Draw a figure with `plot` (an `io.results` function); where
    matplotlib is missing, say on stderr that no figure was written and
    return False."""
    try:
        plot(*args, **kw)
    except ModuleNotFoundError as err:
        if (err.name or "").split(".")[0] != "matplotlib":
            raise
        print(f"no figure written to {args[-1] if args else kw.get('out_path')}: "
              f"matplotlib is not installed", file=sys.stderr, flush=True)
        return False
    return True


def _device(args, cmd: str):
    from .device import resolve_device
    try:
        return resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"{cmd}: {err}")


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
    from .io.results import ResultsStore
    from .parallel.montecarlo import sparc_ber_sweep

    device = _device(args, "sparc-sweep")
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


# The reference's 36-entry grid-engine parameter table
# (ldpc_jossy/py/ldpc_awgn.py:6-43), selectable with --sim-id 1..36.
SIM_PARAM_TABLE = [
    (std, rate, z, pt)
    for std, zs in [("802.16", [3, 27, 54, 81]), ("802.11n", [27, 54, 81])]
    for z in zs
    for rate, pts in [("1/2", ["A"]),
                      ("2/3", ["A", "B"] if std == "802.16" else ["A"]),
                      ("3/4", ["A", "B"] if std == "802.16" else ["A"]),
                      ("5/6", ["A"])]
    for pt in pts
]


def campaign_params(args):
    """The LdpcParams of an ldpc-campaign's arguments (`--sim-id` picks a
    row of SIM_PARAM_TABLE over --standard/--rate/--z/--ptype)."""
    from .config import LdpcParams
    if args.sim_id is not None:
        if not 1 <= args.sim_id <= len(SIM_PARAM_TABLE):
            raise SystemExit(f"ldpc-campaign: --sim-id must be in 1..{len(SIM_PARAM_TABLE)}")
        args.standard, args.rate, args.z, args.ptype = SIM_PARAM_TABLE[args.sim_id - 1]
    return LdpcParams(standard=args.standard, rate=args.rate, z=args.z, ptype=args.ptype)


def campaign_config_key(args, params) -> str:
    """The campaign store's configuration hash, the JAX CLI's."""
    return _config_key(params=params, points=args.points, min_errors=args.min_errors,
                       max_blocks=args.max_blocks, batch=args.batch,
                       dectype=args.dectype, max_iters=args.max_iters, seed=args.seed)


def cmd_ldpc_campaign(args):
    from .io.results import (ResultsStore, plot_waterfalls, record_to_tuple_line,
                             records_to_csv)
    from .parallel.montecarlo import ldpc_waterfall_campaign

    device = _device(args, "ldpc-campaign")
    params = campaign_params(args)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    # one cell per (configuration, point), holding the state a resume needs
    # (the next adaptive SNR and the running codeword counter)
    store = ResultsStore(out / "ldpc_campaign.jsonl")
    cfg_key = campaign_config_key(args, params)
    start_point, start_snr, start_ctr = 0, None, 0
    for p in range(args.points):
        prev = store.get(f"ldpc:{cfg_key}:p{p}")
        if prev is None:
            break
        start_point, start_snr, start_ctr = p + 1, prev["next_snr"], prev["ctr"]

    def on_point(rec, state):
        store.append(f"ldpc:{cfg_key}:p{state['point']}",
                     {"record": list(rec), **state})
        print(json.dumps({"point": state["point"], "snr": rec[4],
                          "blocks": rec[5], "block_errs": rec[6]}), flush=True)

    ldpc_waterfall_campaign(
        params, seed=args.seed, n_measurements=args.points,
        min_errors=args.min_errors, max_blocks=args.max_blocks, batch=args.batch,
        dectype=args.dectype, max_iters=args.max_iters, on_point=on_point,
        start_point=start_point, start_snr=start_snr, start_ctr=start_ctr,
        device=device)

    # the reference-format files, regenerated from the whole store (every
    # configuration sharing this --out, in measurement order)
    recs = [tuple(r["record"]) for r in store.records() if "record" in r]
    (out / "results.txt").write_text("".join(record_to_tuple_line(r) + "\n"
                                             for r in recs))
    records_to_csv(recs, out / "results.csv")
    _figure(plot_waterfalls, recs, out / "waterfall.png")
    return recs


def cmd_results2csv(args):
    if args.native:
        from .native.tools import results2csv_native
        out = results2csv_native(args.input, args.output)
    else:
        from .io.results import results_txt_to_csv
        out = results_txt_to_csv(args.input, args.output)
    if args.output is None:
        sys.stdout.write(out)


def cmd_plot_results(args):
    from .io.results import load_records, plot_waterfalls
    records = load_records(args.input)
    if not records:
        raise SystemExit(f"no measurement records found in {args.input}")
    if not _figure(plot_waterfalls, records, args.output, metric=args.metric):
        raise SystemExit(1)
    print(json.dumps({"records": len(records), "out": args.output,
                      "metric": args.metric}))


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
    from .io.results import ResultsStore, plot_ber_sweep
    from .parallel.montecarlo import concat_ber_point

    device = _device(args, "concat-sweep")
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
    _figure(plot_ber_sweep, [series[d] for d in decoders], decoders,
            Path(args.out) / f"{stem}.png")
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
    p.add_argument("--fwht-mode", choices=("ms", "2mm", "2mm_f32"), default="ms",
                   help="design-product transform: ms = K1 (float32), "
                        "2mm = K2 (bf16 operands, two tensor-core products), "
                        "2mm_f32 = K2 with float32 operands; K2 only on full "
                        "offset-0 windows of 2^14 to 2^20, K1 elsewhere")
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

    p = sub.add_parser("ldpc-campaign", help="LDPC BER waterfall campaign")
    _add_common(p)
    p.add_argument("--sim-id", type=int, default=None,
                   help="row 1..36 of the reference's grid-engine table "
                        "(overrides --standard/--rate/--z/--ptype)")
    p.add_argument("--standard", default="802.11n")
    p.add_argument("--rate", default="1/2")
    p.add_argument("--z", type=int, default=27)
    p.add_argument("--ptype", default="A")
    p.add_argument("--points", type=int, default=24)
    p.add_argument("--min-errors", type=int, default=100)
    p.add_argument("--max-blocks", type=int, default=400000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dectype", default="sumprod2")
    p.add_argument("--max-iters", type=int, default=200)
    p.set_defaults(fn=cmd_ldpc_campaign)

    p = sub.add_parser("results2csv", help="convert reference results.txt to CSV")
    p.add_argument("input")
    p.add_argument("output", nargs="?", default=None)
    p.add_argument("--native", action="store_true",
                   help="use the native C++ converter (native/results2csv.cpp, "
                        "built with g++) instead of the Python one")
    p.set_defaults(fn=cmd_results2csv)

    p = sub.add_parser("plot-results",
                       help="waterfall plots from results.txt or results.csv "
                            "(the reference's py/disp_res.py)")
    p.add_argument("input", help="results.txt (tuple lines) or results.csv")
    p.add_argument("output", nargs="?", default="waterfalls.pdf",
                   help=".pdf = multi-page per (standard, rate); .png = one figure")
    p.add_argument("--metric", choices=("ber", "bler"), default="ber",
                   help="y-axis metric (BLER is computed from the same records)")
    p.set_defaults(fn=cmd_plot_results)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
