"""Monte Carlo trials completed in the window over the window's seconds
(host clock; the window closes at the end of a whole point)."""


def read(run):
    return run.trials / run.window_s if run.window_s > 0 else None
