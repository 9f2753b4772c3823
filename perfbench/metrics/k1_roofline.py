"""K1's share of its roofline, in percent: the design products' least time
over the device time of K1's kernels (`csrc/fwht_signed.cu`).

A product (A beta or A^T z) of B rows through E blocks of width w needs
E B w log2(w) float32 adds, and reads its input vector and writes its
output vector once (4 B (L M + n) bytes) with the design's signs as bits
(E w / 8 bytes); its least time is the larger of operations over the
float32 instruction rate (an add is one instruction a lane, not half an
FMA) and bytes over HBM bandwidth. Products are counted as K1's
launches, one a product on the fused routes these cells take (a route of
two launches a product would read low, never high).
"""

import math
import re

from perfbench.peaks import FLOAT32_OPS_PER_S, HBM_BYTES_PER_S

KERNEL = re.compile(r"\bfwht_\w*_kernel\b")


def product_least_s(work: dict) -> float:
    B, E, w = work["rows"], work["E"], work["w"]
    ops = E * B * w * math.log2(w)
    nbytes = 4 * B * (work["LM"] + work["n"]) + E * w / 8
    return max(ops / FLOAT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def read(run):
    t = run.trace
    if t is None:
        return None
    launches, sec = t.kernel_time(KERNEL.search)
    if launches == 0 or sec <= 0:
        return None
    return 100.0 * launches * product_least_s(run.work) / sec
