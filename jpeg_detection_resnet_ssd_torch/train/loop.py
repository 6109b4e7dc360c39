"""The training loop: epochs, logging, checkpoints, NaN guard, restart.

Counterpart of the JAX package's `train/loop.py` (`build_optimizer`,
`build_trainer`, `fit`, `make_validation_fn`), on one device.  What the JAX
package adds for meshes and memory is not ported yet and raises
`NotImplementedError` naming its ROADMAP item: `n_model_shards > 1` (A13),
`momentum_dtype="bfloat16"` and `remat` (A15); so does the classification
task (A12).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable

import torch

from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables
from jpeg_detection_resnet_ssd_torch.losses import SSDLoss
from jpeg_detection_resnet_ssd_torch.models import build_model
from jpeg_detection_resnet_ssd_torch.train.checkpoints import CheckpointManager
from jpeg_detection_resnet_ssd_torch.train.config import ExperimentConfig
from jpeg_detection_resnet_ssd_torch.train.metrics import MetricWriter
from jpeg_detection_resnet_ssd_torch.train.schedules import (
    constant_schedule,
    keras_inverse_time_decay,
    warmup_linear_scaling,
)
from jpeg_detection_resnet_ssd_torch.train.trainer import Trainer, detection_loss_fn
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class NaNLossError(RuntimeError):
    """TerminateOnNaN."""


def _make_schedule(config: ExperimentConfig, n_replicas: int = 1):
    if config.warmup_epochs > 0 and n_replicas > 1:
        return warmup_linear_scaling(
            config.learning_rate, n_replicas, config.steps_per_epoch, config.warmup_epochs
        )
    if config.lr_decay > 0:
        return keras_inverse_time_decay(config.learning_rate, config.lr_decay)
    return constant_schedule(config.learning_rate)


def _schedule_value(config: ExperimentConfig, step: int, n_replicas: int = 1) -> float:
    return float(_make_schedule(config, n_replicas)(step))


def build_optimizer(config: ExperimentConfig, params, n_replicas: int = 1) -> torch.optim.SGD:
    """SGD with momentum over `params`, at the schedule's step-0 lr (the
    trainer sets each step's lr).  torch's SGD with dampening 0 keeps
    buf = g + momentum * buf (buf = g at the first step) and updates by
    -lr * buf, or by -lr * (g + momentum * buf) with nesterov: optax.sgd's
    trace and update, so the two packages take the same steps."""
    if config.momentum_dtype != "float32":
        raise NotImplementedError(
            f"momentum_dtype={config.momentum_dtype!r} is not ported to PyTorch yet (ROADMAP A15)"
        )
    return torch.optim.SGD(
        params,
        lr=_schedule_value(config, 0, n_replicas),
        momentum=config.momentum,
        nesterov=config.nesterov,
    )


def build_trainer(config: ExperimentConfig, target_encoder=None, augment_fn=None,
                  device: str | torch.device | None = None):
    """(Trainer, module, example_inputs) for `config` on `device` (None means
    CUDA and raises without a card).  Weights are the port's init from
    `torch.Generator` seeded `config.seed`."""
    dev = resolve_device(device)
    if config.n_model_shards > 1:
        raise NotImplementedError("n_model_shards > 1 is not ported to PyTorch yet (ROADMAP A13)")
    if config.remat or config.momentum_dtype != "float32":
        raise NotImplementedError(
            "remat and a bfloat16 momentum are not ported to PyTorch yet (ROADMAP A15)"
        )
    if config.task != "detection":
        raise NotImplementedError(f"task {config.task!r} is not ported to PyTorch yet (ROADMAP A12)")
    model_kwargs = dict(config.model_kwargs)
    model_kwargs.setdefault("dtype", _COMPUTE_DTYPES[config.compute_dtype])
    module, example_inputs = build_model(
        config.model, device=dev, generator=torch.Generator().manual_seed(config.seed),
        **model_kwargs,
    )
    trainer = Trainer(
        model=module,
        loss_fn=detection_loss_fn(SSDLoss(), l2_scale=config.l2_regularization),
        optimizer=build_optimizer(config, module.parameters()),
        schedule=_make_schedule(config),
        target_encoder=target_encoder,
        augment_fn=augment_fn,
        freeze_bn=config.freeze_bn,
        pallas_wgrad=config.pallas_wgrad,
        device=dev,
    )
    return trainer, module, example_inputs


def fit(
    config: ExperimentConfig,
    train_pipeline,
    val_fn: Callable[[Trainer], dict] | None = None,
    run_dir: str | None = None,
    max_steps: int | None = None,
    init_variables=None,
    log_every: int = 50,
    target_encoder=None,
    augment_fn=None,
    save_every: int = 1,
    device: str | torch.device | None = None,
    steps_per_call: int = 1,
) -> tuple[Trainer, list[dict]]:
    """Train per `config`; returns (trainer, one history row per epoch).

    `train_pipeline` is any iterable of batches (`{"inputs": (y, cbcr),
    "gt", "gt_mask"}` with a target encoder, or `"targets"`), iterated once
    per epoch up to `steps_per_epoch`.  `init_variables` are flax-layout
    NumPy variables (`compat.load_flax_variables`).  With `run_dir`, each
    epoch appends a row to `results/results.csv` and every `save_every`-th
    epoch (and the last) writes a checkpoint; `config.restart` resumes from
    the latest one.  The loss is read (a synchronisation) only when the
    step count crosses a multiple of `log_every` and at the end, where a
    non-finite value raises `NaNLossError`.  Step s hands the augment hook
    `step_generator(config.seed + 1, s)`, so a restarted run draws what an
    uninterrupted one draws.

    `steps_per_call` groups that many batches into one `Trainer.train_steps`
    call, with the JAX package's rules: a group never straddles an epoch or
    `max_steps`, the remainder runs as single steps, and the steps draw what
    single steps draw, so the run is the same whatever the group size.
    """
    trainer, module, _ = build_trainer(config, target_encoder, augment_fn, device)
    if init_variables is not None:
        load_flax_variables(module, init_variables)

    writer = MetricWriter(run_dir, tensorboard=config.tensorboard)
    ckpt = None
    start_epoch = 0
    if run_dir is not None:
        ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
        if config.restart and ckpt.latest_step() is not None:
            ckpt.restore(trainer)
            start_epoch = trainer.step // max(config.steps_per_epoch, 1)

    seed = config.seed + 1
    spc = max(int(steps_per_call), 1)
    history = []
    steps_done = 0
    for epoch in range(start_epoch, config.epochs):
        t0 = time.time()
        epoch_metrics: dict[str, list] = {}

        def run(unit):
            """Steps on `unit`'s batches; NaN guard on log_every crossings."""
            nonlocal steps_done
            prev_done = steps_done
            metrics = trainer.train_steps(unit, seed)
            steps_done += len(unit)
            if (steps_done // log_every != prev_done // log_every
                    or (max_steps and steps_done >= max_steps)):
                loss = float(metrics["total_loss"][-1])
                if not math.isfinite(loss):
                    raise NaNLossError(f"non-finite loss at step {steps_done}")
            for k, v in metrics.items():
                epoch_metrics.setdefault(k, []).append(v)

        pending: list = []
        for batch in train_pipeline:
            # A group never straddles the epoch or max_steps boundary (both
            # count single steps); the remainder runs as single steps.
            boundary = config.steps_per_epoch - steps_done % config.steps_per_epoch
            if max_steps:
                boundary = min(boundary, max_steps - steps_done)
            if spc > 1 and boundary >= spc:
                pending.append(batch)
                if len(pending) < spc:
                    continue
                unit, pending = pending, []
            else:
                unit = [batch]
            run(unit)
            if (max_steps and steps_done >= max_steps) or steps_done % config.steps_per_epoch == 0:
                break
        # A pipeline that ends inside a group: its batches run as single steps.
        for batch in pending:
            if max_steps and steps_done >= max_steps:
                break
            run([batch])
        row: dict[str, Any] = {
            "epoch": epoch,
            "step": trainer.step,
            "time_s": round(time.time() - t0, 2),
            "lr": _schedule_value(config, trainer.step),
        }
        for k, v in epoch_metrics.items():
            row[k] = float(torch.cat(v).double().mean())
        if math.isnan(row.get("total_loss", 0.0)):
            raise NaNLossError(f"non-finite epoch loss at epoch {epoch}")
        if val_fn is not None:
            row.update({f"val_{k}": v for k, v in val_fn(trainer).items()})
        history.append(row)
        writer.log(row, step=trainer.step)
        done = bool(max_steps) and steps_done >= max_steps
        if ckpt is not None and ((epoch + 1) % max(save_every, 1) == 0
                                 or epoch == config.epochs - 1 or done):
            ckpt.save(trainer.step, trainer)
        if done:
            break
    writer.close()
    return trainer, history


def make_validation_fn(trainer: Trainer | None, val_pipeline):
    """Per-epoch validation hook for `fit(val_fn=...)`: the mean SSD loss of
    the eval-mode model over `val_pipeline` (batches with "targets", or
    padded GT and a trainer with a target encoder).

    The hook evaluates the trainer it is called with, as the JAX package's
    hook evaluates the state it is handed; so it can be made before `fit`
    builds its trainer (`trainer` is the JAX signature's and may be None)."""
    ssd_loss = SSDLoss()

    def val_fn(current: Trainer) -> dict:
        eval_apply = current.eval_step()
        losses = []
        for batch in val_pipeline:
            if "targets" in batch:
                targets = torch.as_tensor(batch["targets"], device=current.device)
            elif "gt" in batch and current.target_encoder is not None:
                with torch.no_grad():
                    targets = current.target_encoder(batch["gt"], batch["gt_mask"])
            else:
                raise NotImplementedError(
                    "classification validation is not ported to PyTorch yet (ROADMAP A12)"
                )
            losses.append(float(ssd_loss(targets, eval_apply(batch["inputs"]))))
        return {"loss": sum(losses) / len(losses)} if losses else {}

    return val_fn
