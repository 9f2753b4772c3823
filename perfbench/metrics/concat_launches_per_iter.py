"""Device ops launched in the profiled points (kernels, copies, fills) per
step of the concatenated decode's AMP + BP loop: points x (steps a decode),
steps a decode from the program's counters `concat.iters` / `concat.decodes`
(`utils/tracing.py`; one decode a point). Every op of the point counts, the
designs' upload, the draws, the encode and the counts as well as the loop's,
so the metric belongs to the point as much as to the loop. None where there
is no trace or the program counts no concatenated decode."""


def read(run):
    try:
        from ldpc_sparc_tpu_torch.utils.tracing import counters
    except ImportError:                  # a program without counters
        return None
    t, c = run.trace, counters()
    if t is None or t.launches == 0 or c["concat.decodes"] <= 0:
        return None
    return t.launches / (t.points * c["concat.iters"] / c["concat.decodes"])
