"""Device ops launched in the profiled points (kernels, copies, fills) per
AMP iteration run: points x decodes a point x (t_max - 1). Every op of the
Monte Carlo point counts, the per-trial draws, the encode and the counters
as well as the AMP loop's, so the metric belongs to the point's layer."""


def read(run):
    t, w = run.trace, run.work
    if t is None or t.launches == 0:
        return None
    return t.launches / (t.points * w["decodes"] * (w["t_max"] - 1))
