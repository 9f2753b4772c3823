"""The card's idle share of the profiled points spent in the host's Python
of the integrated decoder's BP-composed denoiser, in percent: the seconds
of the idle gaps named by the program's span `concat.eta`
(`utils/tracing.py`: MMSE, bits, inner BP, sections, the Onsager
derivative), over the points' host-clock length. A gap named by a torch op
inside the span keeps that op's name and is not counted.

0.0 where the program has the span and none of these idles the card; None
where there is no trace or the program counts no concatenated decode."""

SPANS = ("concat.eta",)


def read(run):
    try:
        from ldpc_sparc_tpu_torch.utils.tracing import counters
    except ImportError:                  # a program without spans
        return None
    t = run.trace
    if t is None or t.window_s <= 0 or counters()["concat.decodes"] <= 0:
        return None
    return 100.0 * sum(sec for name, sec in t.gaps if name in SPANS) / t.window_s
