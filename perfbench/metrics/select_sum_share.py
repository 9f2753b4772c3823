"""Device time of the design products' block select (`index_select`) and
segment sum (`index_add_`) over device-busy time, in percent."""

OPS = ("aten::index_select", "aten::index_add_", "aten::index_add")


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    sec = sum(t.ops.get(op, 0.0) for op in OPS)
    return 100.0 * sec / t.busy_s if sec > 0 else None
