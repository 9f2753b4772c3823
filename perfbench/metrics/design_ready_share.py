"""The share of the point's designs that were drawn before the point asked
for them, in percent: 100 x (the program's counter `mc.designs_built` -
`mc.designs_waited`) / `mc.designs_built`, over the whole run, the
warm-up point included. Each point waits for its first design, so a point
of 8 designs reads at most 87.5. A counter of the program
(`utils/tracing.py`), read in the traced run; None where there is no trace
or the program has no such counter."""


def read(run):
    try:
        from ldpc_sparc_tpu_torch.utils.tracing import counters
    except ImportError:                  # a program without counters
        return None
    c = counters()
    if run.trace is None or c["mc.designs_built"] <= 0:
        return None
    return 100.0 * (c["mc.designs_built"] - c["mc.designs_waited"]) / c["mc.designs_built"]
