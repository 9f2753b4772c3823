"""Resumable results store and the reference-format record helpers.

Counterpart of `ldpc_sparc_tpu/io/results.py`, with its three figures
(`plot_waterfalls`, `plot_standard_comparison`, `plot_ber_sweep`), which
import matplotlib inside the function: a machine without it keeps every
other function here and raises ImportError only when asked for a figure.
The JSONL store
format is the JAX package's, so either package reads a store the other
wrote: one JSON object per line, `{"key": ..., **record}`, the last line of
a key winning on load. The tuple-line and CSV helpers are copies of the
originals and give the same text.
"""

from __future__ import annotations

import ast
import csv
import io
import json
import math
from pathlib import Path
from typing import Iterable, List, Optional, Tuple


# Shannon-limit Eb/N0 anchors used by the reference plots
# (ldpc_jossy/py/disp_res.py:47)
SHANNON_EBN0_DB = {0.5: 3.1721, 0.667: 4.0926, 0.75: 4.6693, 0.833: 5.3941}


class ResultsStore:
    """Append-only JSONL store with (key -> record) resume semantics."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._seen = {}
        if self.path.exists():
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    self._seen[rec["key"]] = rec

    def has(self, key: str) -> bool:
        return key in self._seen

    def get(self, key: str):
        return self._seen.get(key)

    def append(self, key: str, record: dict):
        rec = {"key": key, **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        self._seen[key] = rec

    def records(self) -> List[dict]:
        return list(self._seen.values())


# --------------------------------------------------------------------------
# reference tuple format (results.txt / results.csv)
#
# The reference has TWO tuple schemas in the wild:
#   * the historical 10-field one with the protograph type, used by the
#     archived data/results.txt and parsed by src/results2csv.c:49-50:
#       (standard, rate, z, ptype, snr, nblocks, nblockerrors, nbits,
#        nbiterrors, niterations)
#   * the 9-field one (no ptype) that the reference campaign script writes
#     (ldpc_jossy/py/ldpc_awgn.py:110-113).
# We normalize everything to the 10-field schema (9-field lines get
# ptype='A', the only type the 9-field script ever ran).
# --------------------------------------------------------------------------

FIELDS = ("standard", "rate", "z", "ptype", "snr", "nblocks", "nblockerrors",
          "nbits", "nbiterrors", "niterations")


def normalize_record(rec: Tuple) -> Tuple:
    """Accept a 9- or 10-field measurement tuple; return the 10-field form."""
    if len(rec) == 10:
        return tuple(rec)
    if len(rec) == 9:
        std, rate, z, snr, nblocks, nblk, nbits, nbit, nit = rec
        return (std, rate, z, "A", snr, nblocks, nblk, nbits, nbit, nit)
    raise ValueError(f"measurement tuple has {len(rec)} fields, want 9 or 10")


def record_to_tuple_line(rec: Tuple) -> str:
    """One measurement as the reference's results.txt tuple line
    (the 10-field schema of data/results.txt:1 / results2csv.c:49-50)."""
    return repr(normalize_record(rec))


def parse_tuple_line(line: str) -> Optional[Tuple]:
    """Parse a results.txt tuple line, either schema (results2csv.c:48-74
    handles the 10-field form; ldpc_awgn.py:110 emits the 9-field form)."""
    line = line.strip()
    if not (line.startswith("(") and line.endswith(")")):
        return None

    try:
        t = ast.literal_eval(line)
    except (ValueError, SyntaxError):
        return None
    if len(t) in (9, 10):
        return normalize_record(t)
    return None


def _rate_float(rate) -> float:
    num, den = str(rate).split("/")
    return int(num) / int(den)


def records_to_csv(records: Iterable[Tuple], path=None,
                   style: str = "reference") -> str:
    """Measurement tuples -> CSV (replaces src/results2csv.c).

    style="reference" reproduces results2csv.c's exact numeric schema
    (results2csv.c:62-72, consumed by py/disp_res.py:23-44): no header,
    standard as 16/11, rate as a decimal, ptype as 0 (A) / 1 (B), then
    z, snr, nblocks, nblockerrors, nbits, nbiterrors, niterations.
    style="named" writes a self-describing CSV with a FIELDS header row.
    """
    buf = io.StringIO()
    if style == "named":
        wr = csv.writer(buf)
        wr.writerow(FIELDS)
        for rec in records:
            wr.writerow(normalize_record(rec))
    elif style == "reference":
        for rec in records:
            std, rate, z, ptype, snr, nblocks, nblk, nbits, nbit, nit = \
                normalize_record(rec)
            std_num = 16 if str(std).endswith("6") else 11
            buf.write("%d, %g, %d, %d, %g, %d, %d, %d, %d, %d\n" % (
                std_num, _rate_float(rate), 0 if ptype == "A" else 1,
                int(z), float(snr), int(nblocks), int(nblk), int(nbits),
                int(nbit), int(nit)))
    else:
        raise ValueError(f"unknown CSV style {style!r}")
    out = buf.getvalue()
    if path is not None:
        Path(path).write_text(out)
    return out


def results_txt_to_csv(txt_path, csv_path=None,
                       style: str = "reference") -> str:
    """Convert a reference-format results.txt (either tuple schema) to CSV."""
    records = []
    with open(txt_path) as f:
        for line in f:
            t = parse_tuple_line(line)
            if t is not None:
                records.append(t)
    return records_to_csv(records, csv_path, style=style)


_CSV_RATES = {0.5: "1/2", 2 / 3: "2/3", 0.75: "3/4", 5 / 6: "5/6"}


def parse_csv_line(line: str) -> Optional[Tuple]:
    """Parse one numeric CSV row (the results2csv.c:62-72 output schema that
    py/disp_res.py:23-44 consumes) back into the 10-field tuple record.

    The decimal rate is snapped to the nearest IEEE code rate (the four
    rates of the 802.11n/802.16 standards are the only ones that exist)."""
    parts = [p.strip() for p in line.strip().split(",")]
    if len(parts) != 10:
        return None
    try:
        std_num = int(parts[0])
        rate_f = float(parts[1])
        ptype_num = int(parts[2])
        z = int(parts[3])
        snr = float(parts[4])
        ints = [int(p) for p in parts[5:]]
    except ValueError:
        return None
    std = "802.16" if std_num == 16 else "802.11n"
    rate = min(_CSV_RATES, key=lambda r: abs(r - rate_f))
    return (std, _CSV_RATES[rate], z, "B" if ptype_num else "A", snr, *ints)


def load_records(path) -> List[Tuple]:
    """Read measurement records from a results file: tuple-line .txt
    (either schema), the reference's numeric .csv, or our named-header
    .csv — auto-detected per line."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.split(",")[0] == FIELDS[0]:
                continue  # blank or named-CSV header
            t = parse_tuple_line(line)
            if t is None and not line.startswith("("):
                parts = [p.strip() for p in line.split(",")]
                if len(parts) == 10 and not parts[0].isdigit():
                    # named-CSV row: FIELDS order, textual standard/rate
                    try:
                        t = normalize_record((
                            parts[0], parts[1], int(parts[2]), parts[3],
                            float(parts[4]), *[int(p) for p in parts[5:]]))
                    except ValueError:
                        t = None
                else:
                    t = parse_csv_line(line)
            if t is not None:
                records.append(t)
    return records


# --------------------------------------------------------------------------
# derived metrics + plotting (disp_res.py:7-131 equivalents)
# --------------------------------------------------------------------------

def waterfall_metrics(rec: Tuple) -> dict:
    """BER / BLER / Eb/N0 for one measurement (disp_res.py derivations)."""
    std, rate, z, ptype, snr, nblocks, nblk, nbits, nbit, nit = \
        normalize_record(rec)
    R = _rate_float(rate)
    return {
        "standard": std, "rate": rate, "z": z, "ptype": ptype, "snr_db": snr,
        "ber": nbit / nbits if nbits else 0.0,
        "bler": nblk / nblocks if nblocks else 0.0,
        "ebn0_db": snr - 10.0 * math.log10(R),
        "avg_iters": nit / nblocks if nblocks else 0.0,
    }


def plot_waterfalls(records: Iterable[Tuple], out_path,
                    title: str = "LDPC BER waterfalls", metric: str = "ber"):
    """BER- (or BLER-) vs-Eb/N0 plot with Shannon-limit anchors
    (disp_res.py:40-131).

    A .pdf out_path produces a multi-page document, one page per
    (standard, rate) group (the reference's multi-page PDF export,
    disp_res.py:7-13); any other extension writes a single combined figure.
    metric: 'ber' (default) or 'bler' — waterfall_metrics computes both.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    assert metric in ("ber", "bler"), metric
    groups = {}
    for rec in records:
        m = waterfall_metrics(rec)
        key = (m["standard"], m["rate"], m["z"], m["ptype"])
        groups.setdefault(key, []).append(m)

    def draw(ax, keys):
        for (std, rate, z, ptype) in keys:
            ms = sorted(groups[(std, rate, z, ptype)],
                        key=lambda m: m["ebn0_db"])
            label = f"{std} {rate} z={z}"
            if ptype != "A":
                label += f" type {ptype}"
            ax.semilogy([m["ebn0_db"] for m in ms],
                        [max(m[metric], 1e-9) for m in ms],
                        "o-", label=label)
            R = round(_rate_float(rate), 3)
            if R in SHANNON_EBN0_DB:
                ax.axvline(SHANNON_EBN0_DB[R], ls=":", color="gray", lw=1)
        ax.set_xlabel("Eb/N0 (dB)")
        ax.set_ylabel(metric.upper())
        ax.grid(True, which="both", alpha=0.3)
        ax.legend(fontsize=8)

    if str(out_path).endswith(".pdf"):
        from matplotlib.backends.backend_pdf import PdfPages
        pages = {}
        for k in groups:
            pages.setdefault(k[:2], []).append(k)
        with PdfPages(out_path) as pdf:
            for (std, rate), keys in sorted(pages.items()):
                fig, ax = plt.subplots(figsize=(8, 5))
                draw(ax, sorted(keys))
                ax.set_title(f"{title}: {std} rate {rate}")
                fig.tight_layout()
                pdf.savefig(fig)
                plt.close(fig)
        return out_path

    fig, ax = plt.subplots(figsize=(8, 5))
    draw(ax, sorted(groups))
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_standard_comparison(records: Iterable[Tuple], out_path,
                             metric: str = "ber"):
    """The reference's SECOND disp_res figure family (disp_res.py:96-123):
    one page per expansion factor z, a 2x2 grid of rate panels, each
    overlaying the 802.11n and 802.16 (type A/B) waterfalls for that
    (z, rate) with the Shannon-limit anchor. Pages are emitted for every
    z present in the records (the reference hardcodes z in {27,54,81}).

    out_path ending in .pdf -> multi-page; otherwise one figure for the
    z with the most measurements.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    assert metric in ("ber", "bler")
    ms = [waterfall_metrics(rec) for rec in records]
    zs = sorted({m["z"] for m in ms})
    rates = sorted({round(_rate_float(m["rate"]), 3) for m in ms})

    def draw_page(fig, z, page_rates):
        for i, R in enumerate(page_rates):
            ax = fig.add_subplot(2, 2, i + 1)
            for std in ("802.11n", "802.16"):
                ptypes = sorted({m["ptype"] for m in ms
                                 if m["standard"] == std and m["z"] == z
                                 and abs(_rate_float(m["rate"]) - R) < 0.01})
                for ptype in ptypes:
                    sel = sorted(
                        (m for m in ms
                         if m["standard"] == std and m["z"] == z
                         and abs(_rate_float(m["rate"]) - R) < 0.01
                         and m["ptype"] == ptype),
                        key=lambda m: m["ebn0_db"])
                    if not sel:
                        continue
                    # the reference labels the bare standard unless both
                    # protograph types exist for this (z, rate)
                    label = std if len(ptypes) == 1 \
                        else f"{std} type {ptype}"
                    ax.semilogy([m["ebn0_db"] for m in sel],
                                [max(m[metric], 1e-9) for m in sel],
                                "o-", ms=3, label=label)
            if R in SHANNON_EBN0_DB:
                ax.axvline(SHANNON_EBN0_DB[R], color="r", lw=1,
                           label="Shannon limit")
            ax.set_title(f"Z={z}, R={R:.3f}")
            ax.set_xlabel("Eb/N0 (dB)")
            ax.set_ylabel(metric.upper())
            ax.grid(True, which="both", alpha=0.3)
            ax.legend(fontsize=7)

    # paginate rates in chunks of four so >4 distinct rates get extra
    # pages instead of silently disappearing from the 2x2 grid
    rate_chunks = [rates[i:i + 4] for i in range(0, len(rates), 4)]

    if str(out_path).endswith(".pdf"):
        from matplotlib.backends.backend_pdf import PdfPages
        with PdfPages(out_path) as pdf:
            for z in zs:
                for chunk in rate_chunks:
                    fig = plt.figure(figsize=(10, 11))
                    draw_page(fig, z, chunk)
                    fig.suptitle(f"Standard comparison, Z={z}")
                    fig.tight_layout()
                    pdf.savefig(fig)
                    plt.close(fig)
        return out_path
    best_z = max(zs, key=lambda z: sum(m["z"] == z for m in ms))
    fig = plt.figure(figsize=(10, 11))
    draw_page(fig, best_z, rate_chunks[0])
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_ber_sweep(rows, labels, out_path, title="BER vs SNR"):
    """Multi-decoder BER sweep plot (performance_plots_general.py:141-155).

    rows: list (one per decoder) of lists of dicts with 'ber' and an SNR
    axis — 'snr' (linear, the reference's concat-sweep convention,
    performance_plots_general.py:96-98) preferred, else 'snr_db'. Rows
    that also carry 'ber_min'/'ber_max' get the reference's asymmetric
    min/max error bars (performance_plots_general.py:141-155).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(10, 4))
    floor = 1e-9

    def row_snr(r):
        # linear snr row by row, so that a series never mixes units; rows
        # without 'snr' come from older concat stores, which kept the
        # LINEAR snr under 'snr_db', so the fallback reads it as linear
        return r["snr"] if "snr" in r else r["snr_db"]

    for series, label in zip(rows, labels):
        snr = [row_snr(r) for r in series]
        ber = [max(r["ber"], floor) for r in series]
        if series and "ber_min" in series[0] and "ber_max" in series[0]:
            lo = [max(b - max(r["ber_min"], floor), 0.0)
                  for r, b in zip(series, ber)]
            hi = [max(max(r["ber_max"], floor) - b, 0.0)
                  for r, b in zip(series, ber)]
            ax.errorbar(snr, ber, yerr=[lo, hi], fmt="o-", capsize=3,
                        label=label)
            ax.set_yscale("log")
        else:
            ax.semilogy(snr, ber, "o-", label=label)
    ax.set_xlabel("SNR (linear)")
    ax.set_ylabel("BER")
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
