"""Reduce a `torch.profiler` trace, kept in memory, to what the per-layer
metrics read: device busy time, launches, device time by kernel and by the
torch op that launched it, and the idle gaps by what the host was doing.

Device ops are the trace's CUDA-side events (kernels, copies, fills), not
the device-side copies of host spans. A torch op's device time is that of
the kernels the profiler links to it or to the ops it calls (kernels
launched through `ctypes` link to none).
Busy time is the union of the device ops' intervals. An idle gap is a
stretch between two device ops in which none ran; it is named by the
innermost host-side span open at its middle (a torch op, or the harness's
span around a call into the program, which then means host Python
outside any torch op).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field

from torch.autograd import DeviceType

HOST_SPAN = "host in "      # the harness's spans around calls into the program


@dataclass
class Trace:
    window_s: float                 # host clock over the profiled points
    points: int                     # whole points profiled
    busy_s: float = 0.0
    launches: int = 0
    kernels: dict = field(default_factory=dict)   # name -> [count, seconds]
    ops: dict = field(default_factory=dict)       # torch op -> device seconds
    gaps: list = field(default_factory=list)      # [name, seconds], longest first

    def kernel_time(self, match) -> tuple[int, float]:
        """(launches, device seconds) of the kernels whose name `match`
        accepts."""
        n = s = 0
        for name, (count, sec) in self.kernels.items():
            if match(name):
                n, s = n + count, s + sec
        return n, s

    def top_kernels(self, k: int = 10) -> list:
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name, sec] for name, (_, sec) in rows]


def _device_events(events):
    """Device ops, without the device-side copies of host spans that
    `record_function` leaves in the trace."""
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(HOST_SPAN)]


def _outermost_op(e):
    """The outermost torch op around host event `e` (index_select, not the
    gather it calls)."""
    while e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::"):
        e = e.cpu_parent
    return e.name


def summarize(events, window_s: float, points: int) -> Trace:
    """The `Trace` of profiler `events` (`prof.events()`), taken over
    `points` whole points that lasted `window_s` seconds by the host clock."""
    tr = Trace(window_s=window_s, points=points)
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in _device_events(events)), key=lambda r: r[0])
    tr.launches = len(dev)
    kernels = defaultdict(lambda: [0, 0.0])
    gaps, busy_us, cur_end = [], 0.0, None
    for start, end, name in dev:
        kernels[name][0] += 1
        kernels[name][1] += (end - start) * 1e-6
        if cur_end is None:
            busy_us += end - start
            cur_end = end
            continue
        if start > cur_end:
            gaps.append((0.5 * (start + cur_end), start - cur_end))
        busy_us += max(0.0, end - max(start, cur_end))
        cur_end = max(cur_end, end)
    tr.busy_s = busy_us * 1e-6
    tr.kernels = dict(kernels)
    ops = defaultdict(float)
    host = [e for e in events if e.device_type == DeviceType.CPU]
    for e in host:
        if e.kernels:
            ops[_outermost_op(e)] += sum(k.duration for k in e.kernels) * 1e-6
    tr.ops = dict(ops)
    tr.gaps = _name_gaps(gaps, host)
    return tr


def _name_gaps(gaps, host) -> list:
    """Sum the gaps (middle, length in us) by the innermost host span open
    at their middle, on the thread that holds most spans."""
    if not gaps:
        return []
    main = Counter(e.thread for e in host).most_common(1)[0][0] if host else None
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in host
                   if e.thread == main and not e.name.startswith("cuda"))
    totals = defaultdict(float)
    stack, j = [], 0
    for mid, length in sorted(gaps):
        while j < len(spans) and spans[j][0] <= mid:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        totals[stack[-1][2] if stack else "outside the profiled points"] += length * 1e-6
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])]
