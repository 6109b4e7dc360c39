"""The port's training package: schedules, config, checkpoints, `fit` (CPU).

Schedules against the JAX package's optax schedules at rtol 1e-6 (float32
there, float64 here); the config's JSON against the JAX package's; and a
few steps of `fit` on the full `ssd300_ssd_custom` at batch 1 on the CPU
(plain versions of the kernels), with checkpoints, the results CSV and a
restart.
"""

import csv
import os
import shutil

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.train import config as jax_config
from jpeg_detection_resnet_ssd_tpu.train import schedules as jax_schedules
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.models import layers
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
from jpeg_detection_resnet_ssd_torch.train import (
    CheckpointManager,
    ExperimentConfig,
    NaNLossError,
    Trainer,
    build_optimizer,
    build_trainer,
    dropout_step_generator,
    fit,
    make_validation_fn,
    schedules,
    step_generator,
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


def test_resumed_fit_draws_what_an_uninterrupted_fit_draws(tmp_path):
    """3 epochs straight against 2 epochs and a restart to 3: the augment
    hook sees the same draw at each step (step 2 must not replay step 0's)."""

    def run(run_dir, epochs, restart=False):
        draws = []

        def augment(batch, generator):
            draws.append(float(torch.rand((), generator=generator)))
            return batch

        cfg = ExperimentConfig(compute_dtype="float32", batch_size=1, epochs=epochs,
                               steps_per_epoch=1, restart=restart)
        fit(cfg, _batches(1), run_dir=str(run_dir), target_encoder=_encoder(),
            augment_fn=augment, device="cpu")
        return draws

    straight = run(tmp_path / "straight", 3)
    first = run(tmp_path / "resumed", 2)
    then = run(tmp_path / "resumed", 3, restart=True)
    assert len(straight) == 3 and len(set(straight)) == 3
    assert first + then == straight


def test_step_generator_is_a_function_of_seed_and_step():
    def draw(seed, step):
        return torch.rand(4, generator=step_generator(seed, step))

    assert torch.equal(draw(1, 5), draw(1, 5))
    assert not torch.equal(draw(1, 5), draw(1, 6))
    assert len({tuple(draw(seed, step).tolist()) for seed in range(4) for step in range(4)}) == 16


def test_fit_nan_guard(tmp_path):
    cfg = ExperimentConfig(compute_dtype="float32", batch_size=1, epochs=1, steps_per_epoch=1)
    batch = _batches(1)[0]
    batch["inputs"] = (np.full_like(batch["inputs"][0], np.nan), batch["inputs"][1])
    with pytest.raises(NaNLossError):
        fit(cfg, [batch], target_encoder=_encoder(), log_every=1, device="cpu")


def test_what_is_not_ported_names_its_roadmap_item():
    """Tensor parallelism (A13b) is ported: in one process a 1x2 mesh
    raises (two model ranks need two processes); the VGG classifiers
    (A12b), the memory levers (A15) and the classification task (A12a)
    build."""
    with pytest.raises(ValueError, match="mesh 0x2 != 1 processes"):
        build_trainer(ExperimentConfig(n_model_shards=2), device="cpu")
    _, vgg, _ = build_trainer(ExperimentConfig(model="vgga", task="classification",
                                               model_kwargs={"num_classes": 7}), device="cpu")
    assert vgg.head.predictions.weight.shape == (7, 4096) and vgg.head.fc1.weight.shape == (4096, 25088)
    from jpeg_detection_resnet_ssd_torch.train import BF16MomentumSGD

    assert isinstance(build_optimizer(ExperimentConfig(momentum_dtype="bfloat16"), [torch.zeros(1)]),
                      BF16MomentumSGD)
    trainer, model, _ = build_trainer(ExperimentConfig(
        model="resnet50_dct_cb5_only", task="classification", remat=True,
        momentum_dtype="bfloat16", model_kwargs={"num_classes": 7}), device="cpu")
    assert model.remat and isinstance(trainer.optimizer, BF16MomentumSGD)
    assert model.fc1000.weight.shape == (7, 2048) and next(model.parameters()).device.type == "cpu"


def _noise_hook(draws):
    """An augment hook whose draws change the step: seeded noise on the luma
    plane; `draws` records each step's first value."""

    def augment(batch, generator):
        noise = torch.randn(batch["inputs"][0].shape, generator=generator)
        draws.append(float(noise.reshape(-1)[0]))
        return {**batch, "inputs": (torch.as_tensor(batch["inputs"][0]) + 10 * noise,
                                    batch["inputs"][1])}

    return augment


def test_grouped_fit_equals_single_step_fit():
    """C2: `fit(steps_per_call=3)` draws and trains exactly as
    `fit(steps_per_call=1)`.  Epochs of 5 steps and max_steps 9: a group of
    3, a 2-step tail before the epoch boundary, a group of 3, then one step
    to max_steps."""

    def run(spc):
        draws = []
        cfg = ExperimentConfig(compute_dtype="float32", batch_size=1, epochs=2, steps_per_epoch=5)
        trainer, history = fit(cfg, _batches(5), target_encoder=_encoder(),
                               augment_fn=_noise_hook(draws), max_steps=9,
                               steps_per_call=spc, log_every=2, device="cpu")
        return trainer, history, draws

    single, single_hist, single_draws = run(1)
    grouped, grouped_hist, grouped_draws = run(3)
    assert grouped_draws == single_draws and len(set(single_draws)) == 9
    assert grouped.step == single.step == 9
    for row_s, row_g in zip(single_hist, grouped_hist, strict=True):
        assert {k: v for k, v in row_s.items() if k != "time_s"} == {
            k: v for k, v in row_g.items() if k != "time_s"}
    for (name, p_s), (_, p_g) in zip(single.model.state_dict().items(),
                                     grouped.model.state_dict().items()):
        assert torch.equal(p_s, p_g), name


def test_grouped_fit_nan_guard():
    cfg = ExperimentConfig(compute_dtype="float32", batch_size=1, epochs=1, steps_per_epoch=3)
    batch = _batches(1)[0]
    batch["inputs"] = (np.full_like(batch["inputs"][0], np.nan), batch["inputs"][1])
    with pytest.raises(NaNLossError, match="step 3"):
        fit(cfg, [batch] * 3, target_encoder=_encoder(), steps_per_call=3, log_every=3,
            device="cpu")


def test_train_steps_draw_what_single_steps_draw():
    """Step s of a `train_steps` call draws from `step_generator(seed, s)`."""
    class Model(torch.nn.Linear):
        def forward(self, inputs):
            return super().forward(inputs[0])

    draws = []
    model = Model(2, 1)
    trainer = Trainer(model, lambda m, out, b: (out.sum() * 0, {}),
                      torch.optim.SGD(model.parameters(), lr=0.1),
                      augment_fn=lambda b, g: draws.append(float(torch.rand((), generator=g))) or b,
                      device="cpu")
    trainer.step = 5
    batch = {"inputs": (np.ones((1, 2), np.float32),), "targets": np.zeros(1, np.float32)}
    trainer.train_steps([batch] * 3, seed=9)
    assert trainer.step == 8
    assert draws == [float(torch.rand((), generator=step_generator(9, s))) for s in (5, 6, 7)]


def _vgg_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"inputs": (rng.normal(0, 100, (1, 28, 28, 64)).astype(np.float32),
                        rng.normal(0, 30, (1, 14, 14, 128)).astype(np.float32)),
             "labels": rng.integers(0, 10, 1).astype(np.int32)} for _ in range(n)]


_DROPOUT_MASK = layers.dropout_mask


def _recording_dropout(monkeypatch):
    """Record every dropout mask the port draws."""
    masks = []

    def record(shape, keep_prob, generator):
        masks.append(_DROPOUT_MASK(shape, keep_prob, generator))
        return masks[-1]

    monkeypatch.setattr(layers, "dropout_mask", record)
    return masks


def _vgg_config(**kw):
    return ExperimentConfig(model="vgga_dct", task="classification", compute_dtype="float32",
                            batch_size=1, learning_rate=1e-2, l2_regularization=0.0,
                            model_kwargs={"num_classes": 10}, **kw)


def test_grouped_fit_draws_the_dropout_masks_of_single_steps(monkeypatch):
    """C2 with dropout: `fit(steps_per_call=3)` on a VGG classifier draws the
    masks of `fit(steps_per_call=1)` and trains to the same weights."""
    runs = []
    for spc in (1, 3):
        masks = _recording_dropout(monkeypatch)
        trainer, _ = fit(_vgg_config(epochs=1, steps_per_epoch=3), _vgg_batches(3),
                         steps_per_call=spc, device="cpu")
        runs.append((trainer, masks))
    (single, single_masks), (grouped, grouped_masks) = runs
    assert len(single_masks) == 6 and all(torch.equal(a, b)
                                          for a, b in zip(single_masks, grouped_masks, strict=True))
    assert not torch.equal(single_masks[0], single_masks[2])  # each step draws anew
    for (name, p_s), (_, p_g) in zip(single.model.state_dict().items(),
                                     grouped.model.state_dict().items()):
        assert torch.equal(p_s, p_g), name


def test_resumed_fit_draws_the_dropout_masks_of_an_uninterrupted_fit(monkeypatch, tmp_path):
    """C1 with dropout: 2 epochs straight against 1 epoch and a restart to
    2; step s draws from `dropout_step_generator(seed + 1, s)`."""

    def run(run_dir, epochs, restart=False):
        masks = _recording_dropout(monkeypatch)
        fit(_vgg_config(epochs=epochs, steps_per_epoch=2, restart=restart), _vgg_batches(2),
            run_dir=run_dir, device="cpu")
        return masks

    straight = run(None, 2)
    run(str(tmp_path), 1)
    then = run(str(tmp_path), 2, restart=True)
    shutil.rmtree(tmp_path)  # two checkpoints of 130M parameters and their momentum
    assert len(straight) == 8 and len(then) == 4
    assert all(torch.equal(a, b) for a, b in zip(straight[4:], then, strict=True))
    want = _DROPOUT_MASK((1, 4096), 0.5, dropout_step_generator(1, 2))
    assert torch.equal(then[0], want)
