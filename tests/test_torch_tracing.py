"""The port's spans (`utils/profiling.py`) on the CPU: off by default, the
train step's and the serving call's phases when on, the bounded buffer, an
export that captures no profiler node, and the attribution of a trace's
launches, device time, blocking calls and idle gaps to the spans."""

import json

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
from jpeg_detection_resnet_ssd_torch.serve import build_serving_fn, export_serving_artifact
from jpeg_detection_resnet_ssd_torch.serve import load_serving_artifact
from jpeg_detection_resnet_ssd_torch.serve.export import ServingModule
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig
from jpeg_detection_resnet_ssd_torch.train.loop import build_trainer
from jpeg_detection_resnet_ssd_torch.utils import profiling
from jpeg_detection_resnet_ssd_torch.utils.profiling import TraceEvent, attribute
from torch_cases import gt_batch

TRAIN_CHILDREN = {"detection": ["augment", "encode", "forward", "loss", "backward", "optimizer"],
                  "classification": ["augment", "forward", "loss", "backward", "optimizer"]}


@pytest.fixture(autouse=True)
def no_spans_left():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def steps():
    """A detection and a classification trainer on the CPU (float32, an
    identity augment hook) and a batch for each."""
    rng = np.random.default_rng(0)

    def identity(batch, generator):
        return batch

    det, _, _ = build_trainer(
        ExperimentConfig(compute_dtype="float32"), augment_fn=identity, device="cpu",
        target_encoder=TargetEncoder(AnchorSpec(), ssd_predictor_sizes("resnet_custom"),
                                     device="cpu"))
    gt, mask = gt_batch(rng, [3])
    det_batch = {"inputs": (rng.normal(0, 100, (1, 38, 38, 64)).astype(np.float32),
                            rng.normal(0, 30, (1, 19, 19, 128)).astype(np.float32)),
                 "gt": gt, "gt_mask": mask}
    cls, _, _ = build_trainer(
        ExperimentConfig(model="resnet50_dct_cb5_only", task="classification",
                         compute_dtype="float32", model_kwargs={"num_classes": 10}),
        augment_fn=identity, device="cpu")
    cls_batch = {"inputs": (rng.normal(0, 100, (2, 16, 16, 64)).astype(np.float32),
                            rng.normal(0, 30, (2, 8, 8, 128)).astype(np.float32)),
                 "labels": np.array([1, 7], np.int32)}
    return {"detection": (det, det_batch), "classification": (cls, cls_batch)}


@pytest.mark.parametrize("task", ["detection", "classification"])
def test_spans_off_keep_nothing_and_enter_no_profiler_range(steps, task, monkeypatch):
    original = torch.profiler.record_function

    def record_function(name, *args):
        # torch.optim opens ranges of its own; the program's must not open
        if name.startswith(profiling.RANGE_PREFIX):
            raise AssertionError(f"{name} entered with the spans off")
        return original(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", record_function)
    trainer, batch = steps[task]
    metrics = trainer.train_step(batch, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(metrics["total_loss"]))
    assert profiling.recorded_spans() == []
    assert profiling.span("a") is profiling.span("b")  # one shared null context


@pytest.mark.parametrize("task", ["detection", "classification"])
def test_train_step_records_its_phases_under_one_root(steps, task):
    trainer, batch = steps[task]
    with profiling.tracing(True):
        trainer.train_step(batch, torch.Generator().manual_seed(0))
    spans = profiling.recorded_spans()
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["train_step"]
    root = roots[0]
    children = sorted((s for s in spans if s.parent != -1), key=lambda s: s.start_ns)
    assert [s.name for s in children] == TRAIN_CHILDREN[task]
    for s in children:
        assert s.parent == root.seq and s.root == root.seq
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns
    assert root.root == root.seq
    # tracing is off again after the block
    trainer.train_step(batch, torch.Generator().manual_seed(1))
    assert len(profiling.recorded_spans()) == len(spans)


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.linear = torch.nn.Linear(8, 6)

    def forward(self, x):
        return self.linear(x)


def _top2(out):
    values, idx = torch.topk(out, 2, dim=-1)
    return torch.cat([values, idx.float()], -1)


@pytest.mark.parametrize("decode", [_top2, None], ids=["decode", "no_decode"])
def test_serving_call_records_forward_and_decode_under_serve(decode):
    serving = ServingModule(_Net().eval(), decode)
    x = torch.randn(4, 8)
    with profiling.tracing(True), torch.no_grad():
        for _ in range(2):
            serving(x)
    spans = profiling.recorded_spans()
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["serve", "serve"]
    for root in roots:
        children = sorted((s for s in spans if s.root == root.seq and s is not root),
                          key=lambda s: s.start_ns)
        assert [s.name for s in children] == (["forward", "decode"] if decode else ["forward"])
        assert all(s.parent == root.seq for s in children)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in children)
    assert roots[0].seq != roots[1].seq


def test_span_buffer_keeps_the_last_spans():
    n = profiling.SPAN_CAPACITY + 5
    with profiling.tracing(True):
        for _ in range(n):
            with profiling.span("s"):
                pass
    spans = profiling.recorded_spans()
    assert len(spans) == profiling.SPAN_CAPACITY
    assert spans[-1].seq - spans[0].seq == profiling.SPAN_CAPACITY - 1
    assert all(s.parent == -1 and s.root == s.seq for s in spans[:10])


def _profiler_nodes(program):
    return [n for n in program.graph.nodes
            if "profiler" in str(n.target) or "record_function" in str(n.target)]


def test_export_with_tracing_on_captures_no_profiler_node(tmp_path):
    torch.manual_seed(0)
    serving = build_serving_fn(_Net(), decode_fn=_top2)
    x = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    export_serving_artifact(serving, x, str(tmp_path / "off"), device="cpu")
    with profiling.tracing(True):
        export_serving_artifact(serving, x, str(tmp_path / "on"), device="cpu")
    assert profiling.recorded_spans() == []
    programs = {k: torch.export.load(str(tmp_path / k / "model.pt2")) for k in ("off", "on")}
    assert _profiler_nodes(programs["on"]) == [] == _profiler_nodes(programs["off"])
    xt = torch.from_numpy(x)
    off, _ = load_serving_artifact(str(tmp_path / "off"))
    on, _ = load_serving_artifact(str(tmp_path / "on"))
    assert torch.equal(on(xt), off(xt))


def test_profile_trace_turns_spans_on_and_writes_the_span_table(steps, tmp_path):
    trainer, batch = steps["classification"]
    with profiling.profile_trace(str(tmp_path)):
        trainer.train_step(batch, torch.Generator().manual_seed(0))
    table = json.loads((tmp_path / "spans.json").read_text())
    rows = table["spans"]
    assert set(rows) == {"train_step", *TRAIN_CHILDREN["classification"]}
    assert all(r["calls"] == 1 and r["launches"] == 0 for r in rows.values())  # no card
    children = sum(rows[n]["host_s"] for n in TRAIN_CHILDREN["classification"])
    assert 0 < children <= rows["train_step"]["host_s"]
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"port::train_step", "port::backward"} <= names
    assert [s.name for s in profiling.recorded_spans()][-1] == "train_step"
    assert profiling.span("x") is profiling.span("y")  # off again


# --------------------------------------------------------------------------
# Attribution of a trace to the spans, on synthetic events (times in ns).

def _range(name, a, b, thread=1, corr=0):
    return TraceEvent(f"port::{name}", a, b, thread, corr, False, True)


def _call(name, a, b, corr, thread=1):
    return TraceEvent(name, a, b, thread, corr, False, False)


def _kernel(a, b, corr, name="void k()"):
    return TraceEvent(name, a, b, 0, corr, True, False)


def test_idle_gaps_go_to_the_innermost_span_eleven_deep():
    """Eleven nested spans (the depth of a train step inside a harness's
    own spans); a gap while all are open goes to the deepest, one after the
    deepest two close to the ninth, one after the root closes to 'other'."""
    depth = 11
    ranges = [_range(f"d{i}", 10 * i, 10_000 - 10 * i) for i in range(depth)]
    ranges.append(_range("after", 20_000, 21_000))  # opens after the last gap began
    kernels = [
        _kernel(0, 200, 1),
        _kernel(300, 9_905, 2),      # gap from 200: all eleven open -> d10
        _kernel(9_925, 9_945, 3),    # gap from 9905: d10 closed at 9900 -> d9
        _kernel(12_000, 12_500, 4),  # gap from 9945: d6 closed at 9940 -> d5
        _kernel(30_000, 30_010, 5),  # gap from 12500: the root closed -> other
    ]
    gaps = attribute(ranges + kernels)["idle_gaps"]
    assert gaps == pytest.approx({"d10": 100e-9, "d9": 20e-9, "d5": 2_055e-9,
                                  "other": 17_500e-9})


def test_launches_device_time_and_blocking_calls_go_to_every_open_span():
    events = [
        _range("train_step", 0, 1_000, corr=1),
        _range("forward", 10, 400, corr=2),
        _range("backward", 500, 900, corr=3),
        # the range's projection on the card is neither work nor busy time
        TraceEvent("port::forward", 50, 390, 0, 2, True, True),
        _call("cudaLaunchKernel", 20, 25, 1),   # shares its id with the train_step range
        _call("cudaLaunchKernel", 30, 35, 2),
        _call("cudaMemcpyAsync", 40, 140, 3),   # blocks the forward for 100 ns
        _call("cudaLaunchKernel", 600, 610, 4),
        _call("cuLaunchKernelEx", 620, 630, 5),
        _call("cudaStreamSynchronize", 700, 880, 6),
        _call("cudaLaunchKernel", 950, 955, 7),  # in the step, outside its children
        _call("cudaLaunchKernel", 100, 105, 8, thread=2),  # another thread: no span
        _call("cudaLaunchKernel", 1_100, 1_105, 9),        # after the step
        _kernel(50, 150, 1),
        _kernel(150, 170, 2),
        _kernel(170, 180, 3, name="Memcpy HtoD (Pageable -> Device)"),
        _kernel(640, 700, 4),
        _kernel(700, 705, 5),
        _kernel(905, 910, 10),  # started by no call in the trace
        _kernel(960, 1_000, 7),
        _kernel(1_000, 1_010, 8),
        _kernel(1_120, 1_130, 9),
    ]
    out = attribute(events)
    rows = out["spans"]
    assert rows["forward"] == pytest.approx({"calls": 1, "host_s": 390e-9, "launches": 2,
                                             "device_s": 120e-9, "syncs": 1, "sync_s": 100e-9})
    assert rows["backward"] == pytest.approx({"calls": 1, "host_s": 400e-9, "launches": 2,
                                              "device_s": 65e-9, "syncs": 1, "sync_s": 180e-9})
    assert rows["train_step"] == pytest.approx({"calls": 1, "host_s": 1_000e-9, "launches": 5,
                                                "device_s": 225e-9, "syncs": 2,
                                                "sync_s": 280e-9})
    assert out["kernels"] == 8 and out["kernel_s"] == pytest.approx(250e-9)
    # busy 50-180, 640-705, 905-910, 960-1010, 1120-1130: the gaps begin in
    # forward, in backward, in train_step after backward, and after the step
    assert out["idle_gaps"] == pytest.approx(
        {"forward": 460e-9, "backward": 200e-9, "train_step": 50e-9, "other": 110e-9})


def test_launches_of_the_autograd_thread_go_to_the_span_waiting_in_backward():
    """The autograd engine runs a CUDA backward on a thread of its own: its
    calls inside a backward op belong to the spans open on the thread that
    waits in `backward()`; a call between backward ops, or on a copy thread,
    to none."""
    events = [
        _range("train_step", 0, 1_000),
        _range("backward", 100, 900),
        TraceEvent("autograd::engine::evaluate_function: ConvolutionBackward0", 200, 400, 3, 50,
                   False, False),
        _call("cudaLaunchKernel", 210, 215, 11, thread=3),
        _call("cudaMalloc", 220, 260, 12, thread=3),
        _call("cudaLaunchKernel", 450, 455, 13, thread=3),
        _call("cudaMemcpyAsync", 300, 310, 14, thread=2),
        _kernel(230, 330, 11),
        _kernel(460, 470, 13),
    ]
    out = attribute(events)
    for name in ("backward", "train_step"):
        row = out["spans"][name]
        assert (row["launches"], row["syncs"]) == (1, 1)
        assert row["device_s"] == pytest.approx(100e-9)
        assert row["sync_s"] == pytest.approx(40e-9)
    assert out["kernels"] == 2
    assert out["idle_gaps"] == pytest.approx({"backward": 130e-9})
