"""Build the port's CUDA kernels from `csrc/` at first use and load them.

`nvcc` compiles every `csrc/*.cu` for sm_90a (Hopper), one process per
source, all started together, and links the objects into one shared
library with a plain C interface, which `ctypes` loads. The library lands
in `_build/` beside this file, named by a hash of the sources and flags,
so a second run with unchanged sources loads it without compiling.

Nothing here runs on import: `load()` is called by a kernel wrapper the
first time it is given a CUDA tensor. A failed build, a failed load or a
non-zero launch status raises with the compiler's or CUDA's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libldpc_sparc_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels are built on a machine with the "
                           "CUDA toolkit")
    return nvcc


def build() -> tuple[Path, str]:
    """Compile the library unless it is already built.

    Returns (path, compiler output); the output, which holds ptxas's
    register and shared-memory report, is empty when nothing was built.
    """
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    srcs = [f for f in _sources() if f.suffix == ".cu"]
    objs = [tmp.with_name(f"{tmp.name}.{f.stem}.o") for f in srcs]
    nvcc = _nvcc()
    # one nvcc per source, all running at once; then one link
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)]
            for f, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    link = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:"
                                   f"\n{' '.join(cmd)}\n{log}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return path, "".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.ldpc_fwht_signed.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32,
                                             i32, ptr]
            lib.ldpc_fwht_signed.restype = i32
            lib.ldpc_srht_scatter_fwht.argtypes = [ptr, ptr, ptr, ptr, i64, i32,
                                                   i32, i32, i32, i32, ptr]
            lib.ldpc_srht_scatter_fwht.restype = i32
            lib.ldpc_srht_fwht_gather.argtypes = [ptr, ptr, ptr, ptr, i64, i32,
                                                  i32, i32, i32, i32, ptr]
            lib.ldpc_srht_fwht_gather.restype = i32
            lib.ldpc_fwht_active_clusters.argtypes = [i32]
            lib.ldpc_fwht_active_clusters.restype = i32
            lib.ldpc_fwht_2mm.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32, i32,
                                          i32, i32, i32, ptr]
            lib.ldpc_fwht_2mm.restype = i32
            lib.ldpc_fwht_2mm_f32.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i32,
                                              i32, i32, i32, i32, ptr]
            lib.ldpc_fwht_2mm_f32.restype = i32
            lib.ldpc_denoise_update.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                                i64, i32, i32, ptr]
            lib.ldpc_denoise_update.restype = i32
            lib.ldpc_bp_decode.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                           i32, i32, i32, i32, ctypes.c_float,
                                           i32, i32, i32, ptr]
            lib.ldpc_bp_decode.restype = i32
            lib.ldpc_bp_lxor_chain.argtypes = [ptr, i32, i32, ptr]
            lib.ldpc_bp_lxor_chain.restype = i32
            lib.ldpc_cuda_error_string.argtypes = [i32]
            lib.ldpc_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a launch returned a non-zero CUDA status."""
    if status != 0:
        msg = load().ldpc_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status}: {msg}")
