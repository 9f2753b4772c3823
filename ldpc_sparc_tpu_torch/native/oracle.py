"""ctypes loader for the native BP oracle (bp_ref.cpp).

Counterpart of `ldpc_sparc_tpu/native/oracle.py`, on the port's own copy of
the source: a float64 C++ port of the reference's C decoder
(ldpc_jossy/src/c_ldpc.c), the oracle the BP kernel K4 is held to. g++
builds it at first use into the package's `_build/` directory, under a
name that hashes the source and flags, so an edited source is rebuilt and
an unchanged one is not; a build is written to a temporary name and moved
into place, so processes that build at once never load half a file. The
library is loaded once per process, under a lock. A failed build raises
with the compiler's message.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parent / "_build"
_lock = threading.Lock()
_lib = None


def gxx_build(name: str, sources: Sequence[Path], flags: Sequence[str],
              deps: Sequence[Path] = ()) -> Path:
    """Compile `sources` (hashed with `deps`, the headers they include)
    with g++ into `_build/`, as `name` with the hash before its suffix,
    unless that file exists; returns its path."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in (*sources, *deps):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    name = Path(name)
    path = BUILD_DIR / f"{name.stem}-{h.hexdigest()[:16]}{name.suffix}"
    if path.exists():
        return path
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = ["g++", *flags, "-o", str(tmp), *map(str, sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)
    return path


def build() -> Path:
    """The oracle's shared library, built if missing."""
    return gxx_build("libbp_ref.so", [HERE / "bp_ref.cpp"],
                     ["-O2", "-shared", "-fPIC", "-std=c++17"])


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ct.CDLL(str(build()))
            pd, pl, i64 = ct.POINTER(ct.c_double), ct.POINTER(ct.c_int64), ct.c_int64
            for name in ("ref_sumprod", "ref_sumprod2"):
                fn = getattr(lib, name)
                fn.restype = ct.c_int
                fn.argtypes = [pd, pl, pl, pl, i64, i64, i64, pd, ct.c_int]
            lib.ref_minsum.restype = ct.c_int
            lib.ref_minsum.argtypes = [pd, pl, pl, pl, i64, i64, i64, pd,
                                       ct.c_double, ct.c_int]
            lib.ref_lxor.restype = ct.c_double
            lib.ref_lxor.argtypes = [ct.c_double, ct.c_double, ct.c_int]
            lib.ref_lxfb.restype = ct.c_double
            lib.ref_lxfb.argtypes = [pd, i64, ct.c_int]
            _lib = lib
    return _lib


def decode(ch: np.ndarray, vdeg: np.ndarray, cdeg: np.ndarray,
           intrlv: np.ndarray, max_itcount: int = 200,
           dectype: str = "sumprod2",
           corr_factor: float = 0.7) -> Tuple[np.ndarray, int]:
    """Decode one codeword's LLRs in float64. Returns (app, iterations)."""
    lib = _load()
    ch = np.ascontiguousarray(ch, dtype=np.float64)
    vdeg = np.ascontiguousarray(vdeg, dtype=np.int64)
    cdeg = np.ascontiguousarray(cdeg, dtype=np.int64)
    intrlv = np.ascontiguousarray(intrlv, dtype=np.int64)
    nv, nc, nmsg = vdeg.size, cdeg.size, intrlv.size
    assert ch.size == nv, "channel LLRs inconsistent with variable degrees"
    app = np.zeros(nv, dtype=np.float64)
    pd, pl = ct.POINTER(ct.c_double), ct.POINTER(ct.c_int64)
    args = (ch.ctypes.data_as(pd), vdeg.ctypes.data_as(pl),
            cdeg.ctypes.data_as(pl), intrlv.ctypes.data_as(pl),
            nv, nc, nmsg, app.ctypes.data_as(pd))
    if dectype == "sumprod":
        it = lib.ref_sumprod(*args, max_itcount)
    elif dectype == "sumprod2":
        it = lib.ref_sumprod2(*args, max_itcount)
    elif dectype == "minsum":
        it = lib.ref_minsum(*args, ct.c_double(corr_factor), max_itcount)
    else:
        raise ValueError(f"unknown decoder type {dectype!r}")
    return app, it


def lxor(a: float, b: float, correct: int = 1) -> float:
    """Pairwise LLR-XOR of the reference's C decoder, in float64."""
    return _load().ref_lxor(a, b, correct)


def lxfb(L: np.ndarray, correct: int = 1) -> Tuple[float, np.ndarray]:
    """(aggregate, extrinsic LLRs) of one check's incoming LLRs, in float64."""
    L = np.ascontiguousarray(L, dtype=np.float64).copy()
    total = _load().ref_lxfb(L.ctypes.data_as(ct.POINTER(ct.c_double)),
                             L.size, correct)
    return total, L
