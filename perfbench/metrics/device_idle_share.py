"""The device's idle share of the profiled points, in percent:
1 - (union of device-op intervals) / (host-clock length of those points)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
