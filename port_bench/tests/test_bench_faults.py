"""A run with its timed path broken underneath, and the control in the
program's place, come out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a tiny batch: set-up, the compared steps or kept batches, a
short window and the check against the reference.  The faults are those a
one-card cell can have: a step that returns its state unchanged, half of
the batch left out (the mean taken over the rest), and an answer altered
where it is produced.  The control is the reference computed one precision
below the configuration's, judged against the float reference with the
cell's limits.
"""

import pytest
import torch

from port_bench import calibrate, core
from port_bench.tests import tiny

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
TRAIN = [c for c in tiny.CELLS if ".train_" in c]
SERVE = [c for c in tiny.CELLS if ".serve_" in c]


def _half(batch):
    out = dict(batch)
    n = batch["inputs"][0].shape[0] // 2
    out["inputs"] = tuple(t[:n] for t in batch["inputs"])
    for k in ("gt", "gt_mask", "labels"):
        if k in out:
            out[k] = out[k][:n]
    return out


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    out, result = tiny.run(tiny.spec(cell))
    assert result["correct"] is False
    assert out["numbers"]["update_gap"] > 0.9


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out(cell, monkeypatch):
    from jpeg_detection_resnet_ssd_torch.train.trainer import Trainer

    step = Trainer.train_step
    monkeypatch.setattr(Trainer, "train_step",
                        lambda self, batch, *a, **k: step(self, _half(batch), *a, **k))
    _, result = tiny.run(tiny.spec(cell, batch=4))
    assert result["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_an_augmented_image_altered(cell, monkeypatch):
    from jpeg_detection_resnet_ssd_torch.ops import dct_augment

    call = dct_augment.DeviceAugment.__call__

    def altered(self, batch, generator=None):
        out = call(self, batch, generator)
        y, c = out["inputs"]
        out["inputs"] = (torch.cat([y[:1] * 0.5, y[1:]]), c)
        return out

    monkeypatch.setattr(dct_augment.DeviceAugment, "__call__", altered)
    _, result = tiny.run(tiny.spec(cell))
    assert result["correct"] is False and result["checks"]["planes_gap"]["value"] > 0.1


@pytest.mark.parametrize("cell", SERVE)
def test_half_the_batch_left_out_of_serving(cell, monkeypatch):
    from jpeg_detection_resnet_ssd_torch.serve.export import ServingModule

    forward = ServingModule.forward

    def half(self, *inputs):
        n = inputs[0].shape[0] // 2
        out = forward(self, *(t[:n] for t in inputs))
        return torch.cat([out, torch.zeros_like(out)])

    monkeypatch.setattr(ServingModule, "forward", half)
    _, result = tiny.run(tiny.spec(cell, batch=4))
    assert result["correct"] is False


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    from jpeg_detection_resnet_ssd_torch.serve.export import ServingModule

    forward = ServingModule.forward

    def altered(self, *inputs):
        out = forward(self, *inputs).clone()
        if out.shape[-1] == 6:  # a detection's box moves by 30 px
            out[0, 0, 2:] += 30.0
        else:  # the last served class becomes another
            out[0, -1] = (out[0, -1] + 500) % 1000
        return out

    monkeypatch.setattr(ServingModule, "forward", altered)
    _, result = tiny.run(tiny.spec(cell, batch=4))
    assert result["correct"] is False


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_is_not_correct(cell):
    s = tiny.spec(cell, batch=4)
    torch.set_num_threads(4)
    if s["traffic"]["kind"] == "train":
        rows = calibrate.train_control(s, tiny.SEED, torch.device("cpu"), faults=False)
    else:
        rows = calibrate.serve_control(s, tiny.SEED, torch.device("cpu"))
    (_, numbers), = rows
    ok, checks = core.judge(numbers, s["limits"])
    assert ok is False, checks
