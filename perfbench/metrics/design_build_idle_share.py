"""The card's idle share of the profiled points spent while the program
built the point's designs, in percent: the seconds of the idle gaps named
by the program's span `mc.designs` (`utils/tracing.py`), over the points'
host-clock length. A gap named by a torch op inside the span (the upload's
`aten::copy_`) keeps that op's name and is not counted.

0.0 where the program has spans and none of these idles the card; None
where there is no trace or the program has no spans."""

SPANS = ("mc.designs",)


def read(run):
    try:
        import ldpc_sparc_tpu_torch.utils.tracing  # noqa: F401
    except ImportError:                  # a program without spans
        return None
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * sum(sec for name, sec in t.gaps if name in SPANS) / t.window_s
