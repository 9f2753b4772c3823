"""Build and run the native tools.

Counterpart of `ldpc_sparc_tpu/native/tools.py`, on the port's own copies
of the sources: `results2csv.cpp`, the C++ counterpart of the reference's
src/results2csv.c, and `bp_selftest.cpp`, the oracle's standalone
self-test (the reference kernel's __DEBUG__ main,
ldpc_jossy/src/c_ldpc.c:404-449). Both are built by g++ at first use into
the package's `_build/` directory, as the oracle is (`oracle.gxx_build`).
"""

from __future__ import annotations

import subprocess
from pathlib import Path
from typing import Optional

from .oracle import HERE, gxx_build


def build_results2csv() -> Path:
    """The native converter's binary, built if missing."""
    return gxx_build("results2csv", [HERE / "results2csv.cpp"], ["-O2", "-std=c++17"])


def build_bp_selftest() -> Path:
    """The standalone BP self-test (bp_selftest.cpp with the oracle's
    translation unit), built if missing."""
    return gxx_build("bp_selftest", [HERE / "bp_selftest.cpp", HERE / "bp_ref.cpp"],
                     ["-O2", "-std=c++17"], deps=[HERE / "bp_selftest_data.h"])


def run_bp_selftest() -> str:
    """Build and run the self-test; returns its output (raises
    CalledProcessError when it reports FAIL)."""
    proc = subprocess.run([str(build_bp_selftest())], check=True,
                          capture_output=True, text=True)
    return proc.stdout


def results2csv_native(txt_path, csv_path: Optional[Path] = None) -> str:
    """Run the native converter on `txt_path`; returns the CSV text (and
    writes it to `csv_path` when given). The same bytes as
    `io.results.results_txt_to_csv(style="reference")`."""
    argv = [str(build_results2csv()), str(txt_path)]
    if csv_path is not None:
        subprocess.run(argv + [str(csv_path)], check=True, capture_output=True)
        return Path(csv_path).read_text()
    return subprocess.run(argv, check=True, capture_output=True, text=True).stdout
