"""The AMP loop's useful share of its row work, in percent: of the rows
its iterations computed (the program's counter `amp.row_iters`), those
still running (`amp.live_row_iters`, the decodes' iterations run), over
the whole run, the warm-up point included. A counter of the program
(`utils/tracing.py`), read in the traced run; None where there is no
trace or the program has no such counter."""


def read(run):
    try:
        from ldpc_sparc_tpu_torch.utils.tracing import counters
    except ImportError:                  # a program without counters
        return None
    c = counters()
    if run.trace is None or c["amp.row_iters"] <= 0:
        return None
    return 100.0 * c["amp.live_row_iters"] / c["amp.row_iters"]
