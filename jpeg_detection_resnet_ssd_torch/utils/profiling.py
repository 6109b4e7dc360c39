"""Profiling: a `torch.profiler` trace of a block, and per-step timing.

Counterpart of the JAX package's `utils/profiling.py`: `profile_trace`
wraps `torch.profiler` where the JAX one wraps `jax.profiler`, and writes a
Chrome trace (open it in Perfetto or `chrome://tracing`); `StepTimer` is the
same arithmetic, steady-state steps/s with the first (warm-up) steps
skipped.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Trace the enclosed block with `torch.profiler` and write
    `logdir/trace.json` (Chrome trace format).  CPU activity is always
    recorded, CUDA activity when a card is there, so a trace of work on the
    card holds its kernels.  Yields the profiler (`key_averages()` reads
    the totals)."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
