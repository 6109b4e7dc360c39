"""Profiling: the program's spans, a `torch.profiler` trace of a block, and
per-step timing.

Counterpart of the JAX package's `utils/profiling.py`: `profile_trace`
wraps `torch.profiler` where the JAX one wraps `jax.profiler`, and writes a
Chrome trace (open it in Perfetto or `chrome://tracing`); `StepTimer` is the
same arithmetic, steady-state steps/s with the first (warm-up) steps
skipped.

Spans: the train step and the serving call mark their phases with
`span(name)` (`train_step` > `augment`, `encode`, `forward`, `loss`,
`backward`, `optimizer`; `serve` > `forward`, `decode`).  They are off by
default: `span` then returns one shared null context after a single flag
check, and touches neither the profiler nor CUDA.  Inside
`tracing(True)` (and inside `profile_trace`) each span keeps its name, the
host clock at entry and exit (`time.perf_counter_ns`), its parent and the
sequence number of its root span (one per step or serving call) in a
bounded in-memory buffer (`recorded_spans`), and is a
`torch.profiler.record_function` range named `port::<name>`, so in a
profiler's trace the kernels, runtime calls and idle gaps of the card can
be put down to the span open at the time (`trace_spans`).  Spans are no-ops
while `torch.compile` or `torch.export` traces the code, so an exported
serving graph holds no profiler node.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

SPAN_CAPACITY = 100_000  # spans kept in memory; the oldest are dropped first
RANGE_PREFIX = "port::"  # the profiler range of span `name` is `port::<name>`

# CUDA API calls that launch a kernel, and those that may block
# the calling host thread until the card (or a copy) is done.
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")
BLOCKING_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemcpyAsync", "cudaFree", "cudaMalloc",
})
# the CPU op around each backward function the autograd engine runs (on a
# thread of its own for a CUDA device)
AUTOGRAD_OP_PREFIX = "autograd::engine::evaluate_function"
# device activities that are copies or fills, not kernels
_DEVICE_COPIES = ("Memcpy", "Memset")


class Span(NamedTuple):
    """One closed span: host clock in ns; `parent` is the enclosing span's
    `seq` (-1 for a root) and `root` the root span's `seq`."""

    name: str
    start_ns: int
    end_ns: int
    seq: int
    parent: int
    root: int


_TRACING = False
_NULL = contextlib.nullcontext()
_SPANS: collections.deque[Span] = collections.deque(maxlen=SPAN_CAPACITY)
_SEQ = itertools.count()
_OPEN = threading.local()  # each thread's stack of open spans


class _OpenSpan:
    __slots__ = ("name", "seq", "parent", "root", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open_stack()
        self.seq = next(_SEQ)
        if stack:
            self.parent, self.root = stack[-1].seq, stack[-1].root
        else:
            self.parent, self.root = -1, self.seq
        stack.append(self)
        self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _open_stack().pop()
        _SPANS.append(Span(self.name, self.start, end, self.seq, self.parent, self.root))
        return False


def _open_stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


def span(name: str):
    """A context manager that marks `name` as a span while tracing is on
    (see the module docstring), else one shared null context."""
    if not _TRACING:
        return _NULL
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _NULL
    return _OpenSpan(name)


@contextlib.contextmanager
def tracing(on: bool = True):
    """Turn the program's spans on (or off) for the enclosed block; the
    previous setting comes back after it."""
    global _TRACING
    before = _TRACING
    _TRACING = on
    try:
        yield
    finally:
        _TRACING = before


def recorded_spans() -> list[Span]:
    """The spans closed while tracing was on, oldest first (at most the last
    `SPAN_CAPACITY`)."""
    return list(_SPANS)


def clear_spans() -> None:
    _SPANS.clear()


class TraceEvent(NamedTuple):
    """A profiler event as `trace_spans` reads it: clock in ns, the host
    thread, the CUPTI correlation id (a runtime call shares it with the
    device work it started), whether it ran on the card, and whether it is
    a `record_function` range (on the card: the range's projection)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    correlation: int
    on_device: bool
    annotation: bool


def trace_events(prof) -> list[TraceEvent]:
    """The events of a finished `torch.profiler.profile`."""
    cuda = torch.autograd.DeviceType.CUDA
    return [TraceEvent(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id(),
                       e.correlation_id(), e.device_type() == cuda, e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _stacks_at(ranges, times):
    """For each of the sorted `times`, the ranges open at that time, the
    innermost last.  `ranges` are (start, end, name) sorted by start and
    nest (a range that starts inside another ends inside it)."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        # a range that ended before t is above every range still open
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append([r for r in stack if r[1] >= t])
    return out


def attribute(events) -> dict:
    """Put a trace's work down to the program's spans.

    For each span name: `calls` and `host_s` (its `port::` ranges), the
    kernel `launches` made while it was open (nested spans count for each
    name open), `device_s`, the card's time in the kernels those launches
    started (matched by correlation id), and `syncs` / `sync_s`, the
    blocking runtime calls (`BLOCKING_CALLS`) and the host time in them.  A
    call belongs to the spans open on its own thread; a call with none open
    there that runs inside a backward op of the autograd engine's own
    thread belongs to the spans open elsewhere at the time (the thread
    waiting in `backward()`), and any other call to none.  Besides: every
    kernel of the trace (`kernels`, `kernel_s`) and the card's idle gaps,
    each put down to the innermost span open when it began (`idle_gaps`,
    seconds by name; "other" where none was)."""
    ranges_by_thread = collections.defaultdict(list)
    calls_by_thread = collections.defaultdict(list)
    autograd_by_thread = collections.defaultdict(list)
    kernels, device = {}, []
    for e in events:
        if e.annotation:
            if not e.on_device and e.name.startswith(RANGE_PREFIX):
                ranges_by_thread[e.thread].append(
                    (e.start_ns, e.end_ns, e.name[len(RANGE_PREFIX):]))
        elif e.on_device:
            device.append((e.start_ns, e.end_ns))
            if not e.name.startswith(_DEVICE_COPIES):
                kernels[e.correlation] = kernels.get(e.correlation, 0) + e.end_ns - e.start_ns
        elif e.name.startswith(LAUNCH_PREFIXES) or e.name in BLOCKING_CALLS:
            calls_by_thread[e.thread].append(e)
        elif e.name.startswith(AUTOGRAD_OP_PREFIX):
            autograd_by_thread[e.thread].append((e.start_ns, e.end_ns))

    table = collections.defaultdict(lambda: dict.fromkeys(
        ("calls", "host_s", "launches", "device_s", "syncs", "sync_s"), 0))

    def count(e, stack):
        for name in {r[2] for r in stack}:
            row = table[name]
            if e.name in BLOCKING_CALLS:
                row["syncs"] += 1
                row["sync_s"] += (e.end_ns - e.start_ns) / 1e9
            else:
                row["launches"] += 1
                row["device_s"] += kernels.get(e.correlation, 0) / 1e9

    for ranges in ranges_by_thread.values():
        ranges.sort()
        for start, end, name in ranges:
            table[name]["calls"] += 1
            table[name]["host_s"] += (end - start) / 1e9
    borrowed = []
    for thread, calls in calls_by_thread.items():
        calls.sort(key=lambda e: e.start_ns)
        backward = _union(autograd_by_thread.get(thread, ()))
        starts = [a for a, _ in backward]
        own = _stacks_at(ranges_by_thread.get(thread, []), [e.start_ns for e in calls])
        for e, stack in zip(calls, own):
            if stack:
                count(e, stack)
            else:
                i = bisect.bisect_right(starts, e.start_ns) - 1
                if i >= 0 and backward[i][1] >= e.start_ns:
                    borrowed.append(e)
    everywhere = sorted(r for rs in ranges_by_thread.values() for r in rs)
    borrowed.sort(key=lambda e: e.start_ns)
    for e, stack in zip(borrowed, _stacks_at(everywhere, [e.start_ns for e in borrowed])):
        count(e, stack)

    return {"spans": dict(table), "kernels": len(kernels),
            "kernel_s": sum(kernels.values()) / 1e9,
            "idle_gaps": _idle_gaps(device, everywhere)}


def _union(intervals) -> list:
    """Sorted disjoint intervals covering `intervals`."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _idle_gaps(device, ranges) -> dict:
    device.sort()
    starts, end = [], None
    for a, b in device:
        if end is not None and a > end:
            starts.append((end, a))
        end = b if end is None else max(end, b)
    gaps = collections.defaultdict(float)
    for (t, nxt), stack in zip(starts, _stacks_at(ranges, [g[0] for g in starts])):
        gaps[stack[-1][2] if stack else "other"] += (nxt - t) / 1e9
    return dict(gaps)


def trace_spans(prof) -> dict:
    """`attribute` on the events of a finished `torch.profiler.profile`."""
    return attribute(trace_events(prof))


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the enclosed block with `torch.profiler`, the program's spans
    on, and write `logdir/trace.json` (Chrome trace format) and
    `logdir/spans.json` (`trace_spans`: host, launches, device and blocking
    time by span, and the idle gaps).  CPU activity is always recorded,
    CUDA activity when a card is there, so a trace of work on the card holds
    its kernels.  Yields the profiler (`key_averages()` reads the totals)."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(True), torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(trace_spans(prof), f, indent=1)


class StepTimer:
    """Track per-step wall time; skips the first `skip` (warm-up) steps."""

    def __init__(self, skip: int = 1):
        self.skip = skip
        self._times: list[float] = []
        self._last: float | None = None
        self._seen = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.skip:
                self._times.append(now - self._last)
        self._last = now

    @property
    def mean_step_s(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def steps_per_sec(self) -> float:
        m = self.mean_step_s
        return 1.0 / m if m == m and m > 0 else 0.0
