"""K3's share of its roofline, in percent: the fused denoiser tail's least
time over the device time of K3's kernels (`csrc/denoise_update.cu`).

A call on B rows of L sections of M entries reads beta and A^T z and writes
s and beta_new (16 bytes an entry), reads tau and writes the section
energies (8 bytes a section), at HBM bandwidth; its 8 float32 operations an
entry take far less at the float32 instruction rate.
"""

import re

from perfbench.peaks import FLOAT32_OPS_PER_S, HBM_BYTES_PER_S

KERNEL = re.compile(r"\bdenoise_update\w*_kernel\b")


def call_least_s(work: dict) -> float:
    B, L, M = work["rows"], work["L"], work["M"]
    return max(16 * B * L * M / HBM_BYTES_PER_S + 8 * B * L / HBM_BYTES_PER_S,
               8 * B * L * M / FLOAT32_OPS_PER_S)


def read(run):
    t = run.trace
    if t is None:
        return None
    launches, sec = t.kernel_time(KERNEL.search)
    if launches == 0 or sec <= 0:
        return None
    return 100.0 * launches * call_least_s(run.work) / sec
