"""The traced window: torch.profiler over the window, reduced to a record.

`Spans` times the harness's own calls into the program on the host clock
and marks them in the trace (`record_function`), so the profiler's idle
gaps can be put down to what the host was doing.  `reduce(prof, ...)`
turns the profiler's events into what the per-layer readers take: device
time by operation, the busy share of the window (the union of the device
intervals), and the idle gaps by the innermost span open when each gap
began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

TOP = 10  # entries of each list of the breakdown
NESTING = 8  # spans looked back through for the one open at a gap


class Spans:
    """With `on`, the host-clock duration of each named call, which is also
    a `record_function` range in the trace; else nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.durations: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench::{name}"):
            yield
        self.durations[name].append(time.perf_counter() - t0)


def _union(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def reduce(prof, window_s: float) -> dict:
    """Device time by operation, busy seconds, and idle gaps by span."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith("bench::"):
            # a range also shows on the device's timeline, where it is no work
            if e.device_type != DeviceType.CUDA:
                spans.append((start, end, e.name[len("bench::"):]))
        elif e.device_type == DeviceType.CUDA:
            device.append((start, end, e.name))
    by_op: dict[str, float] = defaultdict(float)
    for a, b, name in device:
        by_op[name] += b - a
    intervals = sorted((a, b) for a, b, _ in device)
    busy = _union(intervals)
    gaps: dict[str, float] = defaultdict(float)
    spans.sort()
    starts = [a for a, _, _ in spans]
    end = intervals[0][1] if intervals else 0.0
    for a, b in intervals[1:]:
        if a > end:
            gaps[_innermost(spans, starts, end)] += a - end
        end = max(end, b)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])
    return {
        "busy_s": busy,
        "window_s": window_s,
        "device_ops": dict(by_op),
        "breakdown": {
            "device_ops": [[n[:64], s] for n, s in ops[:TOP]],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }


def _innermost(spans, starts, t):
    """The latest-starting of the spans open at time t (spans nest, so it
    is the innermost), or 'other'."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - NESTING, -1), -1):
        if spans[j][1] >= t:
            return spans[j][2]
    return "other"


def kernel_seconds(record: dict, *fragments: str) -> float:
    """Device seconds of the operations whose names hold any fragment."""
    return sum(s for name, s in record["device_ops"].items() if any(f in name for f in fragments))
