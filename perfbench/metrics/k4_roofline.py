"""K4's share of its roofline, in percent: the least time of the BP
iterations the campaign counted over the device time of K4's kernels
(`csrc/bp_decode.cu`) in the profiled points.

One BP iteration of one codeword runs, for each check of degree d, the
forward-backward Lxor trellis: d - 2 forward prefixes, d - 1 backward
suffixes (the last the parity aggregate) and d - 2 extrinsic values, 3d - 5
Lxors, each 14 float32 operations (a sign product, a min, two corrections
of an exp and a log1p each, taken as one operation apiece); and two adds an
edge (the variable sum and the extrinsic difference). Its least time is
those operations over the float32 instruction rate; the messages stay in
shared memory, so bytes bound nothing. The check degrees are those of the
benchmark's own table (`reference/ldpc.py`, through the driver's `work()`).

The work is the program's counter `campaign.codeword_iters` (the
iterations of the counted batches) per point, `campaign.points`, times
the profiled points. A codeword that stops runs one iteration more than it
counts, and each point's discarded speculative batch is device time and
no work, so the share can read low and never high. None where there is
no trace or the program counts no campaign.
"""

import re

from perfbench.peaks import FLOAT32_OPS_PER_S

KERNEL = re.compile(r"bp_decode\w*kernel")
LXOR_OPS = 14          # float32 operations of one Lxor (PERF.md's K4 count)
EDGE_ADDS = 2          # float32 adds an edge an iteration


def codeword_iter_ops(work: dict) -> int:
    """Float32 operations of one BP iteration of one codeword."""
    lxors = sum(3 * d - 5 for d in work["check_degrees"]) * work["z"]
    return LXOR_OPS * lxors + EDGE_ADDS * work["edges"]


def read(run):
    try:
        from ldpc_sparc_tpu_torch.utils.tracing import counters
    except ImportError:                  # a program without counters
        return None
    t, c = run.trace, counters()
    if t is None or c["campaign.points"] <= 0 or c["campaign.codeword_iters"] <= 0:
        return None
    launches, sec = t.kernel_time(KERNEL.search)
    if launches == 0 or sec <= 0:
        return None
    iters = c["campaign.codeword_iters"] / c["campaign.points"] * t.points
    return 100.0 * iters * codeword_iter_ops(run.work) / FLOAT32_OPS_PER_S / sec
