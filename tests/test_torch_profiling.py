"""The port's `utils/profiling.py` against the JAX package's on the CPU."""

import json

import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.utils import profiling as jax_profiling
from jpeg_detection_resnet_ssd_torch.utils import StepTimer, profile_trace


@pytest.mark.parametrize("skip", [0, 1, 3])
def test_step_timer_matches_jax_under_one_clock(monkeypatch, skip):
    ticks = iter([0.0, 0.5, 0.75, 1.0, 1.5, 1.625, 2.0, 2.5, 2.75, 3.0, 3.5, 3.625])
    now = {"t": 0.0}
    monkeypatch.setattr("time.perf_counter", lambda: now["t"])
    ours, ref = StepTimer(skip), jax_profiling.StepTimer(skip)
    for t in list(ticks)[:6]:
        now["t"] = t
        ours.tick()
        ref.tick()
    assert ours.mean_step_s == ref.mean_step_s
    assert ours.steps_per_sec() == ref.steps_per_sec()
    assert ours.steps_per_sec() > 0


def test_step_timer_without_steps_matches_jax():
    ours, ref = StepTimer(), jax_profiling.StepTimer()
    ours.tick()
    ref.tick()
    assert ours.steps_per_sec() == ref.steps_per_sec() == 0.0
    assert ours.mean_step_s != ours.mean_step_s  # nan, as JAX's


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profile_trace(str(tmp_path / "trace")) as prof:
        for _ in range(3):
            x = torch.mm(x, x).tanh()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
