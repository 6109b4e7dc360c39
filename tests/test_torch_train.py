"""The port's training package: schedules, config, checkpoints, `fit` (CPU).

Schedules against the JAX package's optax schedules at rtol 1e-6 (float32
there, float64 here); the config's JSON against the JAX package's; and a
few steps of `fit` on the full `ssd300_ssd_custom` at batch 1 on the CPU
(plain versions of the kernels), with checkpoints, the results CSV and a
restart.
"""

import csv
import os

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.train import config as jax_config
from jpeg_detection_resnet_ssd_tpu.train import schedules as jax_schedules
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
from jpeg_detection_resnet_ssd_torch.train import (
    CheckpointManager,
    ExperimentConfig,
    NaNLossError,
    Trainer,
    build_optimizer,
    build_trainer,
    fit,
    make_validation_fn,
    schedules,
)
from jpeg_detection_resnet_ssd_torch.train.config import create_run_dir, find_latest_run
from jpeg_detection_resnet_ssd_torch.train.loop import _schedule_value

from torch_cases import gt_batch

torch.set_num_threads(1)

STEPS = [0, 1, 7, 99, 100, 101, 250, 1000]


@pytest.mark.parametrize("after", [None, "decay"])
def test_warmup_linear_scaling_matches_jax(after):
    tails = {None: (None, None), "decay": (
        jax_schedules.keras_inverse_time_decay(0.4, 1e-3),
        schedules.keras_inverse_time_decay(0.4, 1e-3),
    )}[after]
    ref = jax_schedules.warmup_linear_scaling(0.1, 8, 20, 5, after=tails[0])
    got = schedules.warmup_linear_scaling(0.1, 8, 20, 5, after=tails[1])
    for step in STEPS:
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6)


def test_other_schedules_match_jax():
    for step in STEPS:
        np.testing.assert_allclose(
            schedules.keras_inverse_time_decay(0.1, 1e-4)(step),
            float(jax_schedules.keras_inverse_time_decay(0.1, 1e-4)(step)), rtol=1e-6,
        )
    # No warmup steps: optax's linear schedule is the constant init value.
    assert schedules.warmup_linear_scaling(0.1, 8, 20, 0)(0) == pytest.approx(0.2)
    assert schedules.linear_schedule(1.0, 0.0, 0)(5) == 1.0
    cfg = ExperimentConfig(lr_decay=1e-2, learning_rate=0.5)
    assert _schedule_value(cfg, 10) == pytest.approx(0.5 / 1.1)


def test_config_json_round_trips_with_jax(tmp_path):
    ref = jax_config.ExperimentConfig(
        learning_rate=0.02, pallas_wgrad=True, batch_size=4, output_dir=str(tmp_path / "jax"),
        model_kwargs={"n_classes": 20},
    )
    run_dir = jax_config.create_run_dir(ref)
    got = ExperimentConfig.load(os.path.join(run_dir, "saved_config.json"))
    assert got.to_json() == ref.to_json()
    port_dir = create_run_dir(ExperimentConfig.from_json(got.to_json()), key="ab" * 16)
    back = jax_config.ExperimentConfig.load(os.path.join(port_dir, "saved_config.json"))
    assert back == ref
    assert find_latest_run(got) == port_dir  # the newest run of this project


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    trainer = Trainer(model, loss_fn=None, optimizer=opt, device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert ckpt.latest_step() is None
    for step in (1, 2, 3):
        trainer.step = step
        with torch.no_grad():
            model.weight.fill_(step)
        ckpt.save(step, trainer)
    assert ckpt.all_steps() == [2, 3]
    fresh = Trainer(torch.nn.Linear(3, 2), loss_fn=None,
                    optimizer=torch.optim.SGD(model.parameters(), lr=0.1), device="cpu")
    ckpt.restore(fresh, step=2)
    assert fresh.step == 2 and torch.equal(fresh.model.weight, torch.full((2, 3), 2.0))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt, mask = gt_batch(rng, [int(rng.integers(1, 5))])
        y = rng.normal(0, 100, (1, 38, 38, 64)).astype(np.float32)
        cbcr = rng.normal(0, 30, (1, 19, 19, 128)).astype(np.float32)
        out.append({"inputs": (y, cbcr), "gt": gt, "gt_mask": mask})
    return out


def _encoder():
    return TargetEncoder(AnchorSpec(), ssd_predictor_sizes("resnet_custom"), device="cpu")


def test_fit_writes_history_checkpoints_and_restarts(tmp_path):
    cfg = ExperimentConfig(compute_dtype="float32", batch_size=1, epochs=3, steps_per_epoch=1,
                           output_dir=str(tmp_path))
    run_dir = create_run_dir(cfg)
    batches = _batches(3)
    trainer, history = fit(cfg, batches, run_dir=run_dir, target_encoder=_encoder(),
                           log_every=1, device="cpu")
    assert [r["step"] for r in history] == [1, 2, 3] and trainer.step == 3
    assert all(np.isfinite(r["total_loss"]) and r["lr"] == 1e-3 for r in history)
    with open(os.path.join(run_dir, "results", "results.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["step"]) for r in rows] == [1, 2, 3]
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    assert ckpt.all_steps() == [1, 2, 3]

    cfg.restart, cfg.epochs = True, 4
    resumed, more = fit(cfg, batches, run_dir=run_dir, target_encoder=_encoder(), device="cpu")
    assert [r["epoch"] for r in more] == [3] and resumed.step == 4
    state = torch.load(os.path.join(ckpt.directory, "ckpt_00000003.pt"), weights_only=True)
    # The resumed run started from step 3's weights and momentum.
    assert state["step"] == 3 and len(state["optimizer"]["state"]) > 0
    val = make_validation_fn(resumed, batches[:1])(resumed)
    assert set(val) == {"loss"} and np.isfinite(val["loss"])


def test_fit_nan_guard(tmp_path):
    cfg = ExperimentConfig(compute_dtype="float32", batch_size=1, epochs=1, steps_per_epoch=1)
    batch = _batches(1)[0]
    batch["inputs"] = (np.full_like(batch["inputs"][0], np.nan), batch["inputs"][1])
    with pytest.raises(NaNLossError):
        fit(cfg, [batch], target_encoder=_encoder(), log_every=1, device="cpu")


def test_what_is_not_ported_names_its_roadmap_item():
    for cfg in (ExperimentConfig(momentum_dtype="bfloat16"), ExperimentConfig(remat=True),
                ExperimentConfig(n_model_shards=2), ExperimentConfig(task="classification")):
        with pytest.raises(NotImplementedError, match="ROADMAP A1[235]"):
            build_trainer(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_optimizer(ExperimentConfig(momentum_dtype="bfloat16"), [torch.zeros(1)])
