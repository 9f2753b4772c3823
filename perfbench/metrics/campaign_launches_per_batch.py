"""Device ops launched in the profiled points (kernels, copies, fills) per
batch the campaign dispatched: points x (batches a point), batches a point
from the program's counters `campaign.batches` / `campaign.points`
(`utils/tracing.py`; each point's discarded speculative batch counts, as
its launches do). None where there is no trace or the program counts no
campaign."""


def read(run):
    try:
        from ldpc_sparc_tpu_torch.utils.tracing import counters
    except ImportError:                  # a program without counters
        return None
    t, c = run.trace, counters()
    if t is None or t.launches == 0 or c["campaign.points"] <= 0 \
            or c["campaign.batches"] <= 0:
        return None
    return t.launches / (t.points * c["campaign.batches"] / c["campaign.points"])
