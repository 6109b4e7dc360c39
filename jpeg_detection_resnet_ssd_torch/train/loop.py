"""The training loop: epochs, logging, checkpoints, NaN guard, restart.

Counterpart of the JAX package's `train/loop.py` (`build_optimizer`,
`build_trainer`, `fit`, `make_validation_fn`), for the detection and the
classification task, with the memory levers `momentum_dtype="bfloat16"`
and `remat`, on one device or over the ranks of a `parallel.make_mesh(
n_model=config.n_model_shards)` mesh: `config.batch_size` is the global
batch, each data rank trains on its rows, the model axis shards the widest
kernels (`parallel.shard_parameters`), and the step is the single-process
step on the global batch (`train/trainer.py`).
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
from jpeg_detection_resnet_ssd_torch.parallel.mesh import (
    Mesh,
    barrier,
    make_mesh,
    shard_parameters,
    tensor_parallel_rule,
)
from jpeg_detection_resnet_ssd_torch.train.checkpoints import CheckpointManager, checkpoint_state
from jpeg_detection_resnet_ssd_torch.train.config import ExperimentConfig
from jpeg_detection_resnet_ssd_torch.train.metrics import MetricWriter
from jpeg_detection_resnet_ssd_torch.train.schedules import (
    constant_schedule,
    keras_inverse_time_decay,
    warmup_linear_scaling,
)
from jpeg_detection_resnet_ssd_torch.train.trainer import (
    Trainer,
    classification_loss_fn,
    detection_loss_fn,
)
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


class BF16MomentumSGD(torch.optim.Optimizer):
    """SGD with momentum whose buffer is kept in bfloat16 while the
    parameters stay float32: optax's `trace(accumulator_dtype=bfloat16)`
    then `scale_by_learning_rate`, as the JAX package's compiled step runs
    them.  With t the stored bf16 trace and d the momentum rounded to bf16
    (JAX's weak typing rounds the Python float to the trace's dtype):

        new = g + d * t                  (float32; XLA keeps the product
                                          in float32 inside the fused update)
        update = new, or g + momentum * new with nesterov
        p += -lr * update;  t = new rounded to bf16

    The first step's trace is zero, so it updates by g."""

    def __init__(self, params, lr: float, momentum: float = 0.9, nesterov: bool = False):
        super().__init__(params, {"lr": lr, "momentum": momentum, "nesterov": nesterov})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("BF16MomentumSGD takes no closure")
        for group in self.param_groups:
            momentum = group["momentum"]
            decay = float(torch.tensor(momentum, dtype=torch.bfloat16))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                trace = state.get("momentum_buffer")
                # (a restored buffer comes back as float32 holding bf16 values)
                new = g.clone() if trace is None else g + trace.float() * decay
                update = g + momentum * new if group["nesterov"] else new
                p.add_(update * -group["lr"])
                state["momentum_buffer"] = new.to(torch.bfloat16)
        return None


def build_optimizer(config: ExperimentConfig, params, n_replicas: int = 1) -> torch.optim.Optimizer:
    """SGD with momentum over `params`, at the schedule's step-0 lr (the
    trainer sets each step's lr).  With a float32 momentum, torch's SGD with
    dampening 0 keeps buf = g + momentum * buf (buf = g at the first step)
    and updates by -lr * buf, or by -lr * (g + momentum * buf) with
    nesterov: optax.sgd's trace and update, so the two packages take the
    same steps.  `momentum_dtype="bfloat16"` is `BF16MomentumSGD`, optax's
    `accumulator_dtype=bfloat16`."""
    lr = _schedule_value(config, 0, n_replicas)
    if config.momentum_dtype == "bfloat16":
        return BF16MomentumSGD(params, lr=lr, momentum=config.momentum, nesterov=config.nesterov)
    if config.momentum_dtype != "float32":
        raise ValueError(f"momentum_dtype must be 'float32' or 'bfloat16', got {config.momentum_dtype!r}")
    return torch.optim.SGD(params, lr=lr, momentum=config.momentum, nesterov=config.nesterov)


def build_trainer(config: ExperimentConfig, target_encoder=None, augment_fn=None,
                  device: str | torch.device | None = None, mesh: Mesh | None = None,
                  init_variables=None, tp_rule=tensor_parallel_rule):
    """(Trainer, module, example_inputs) for `config` on `device` (None means
    CUDA and raises without a card) over `mesh` (None: `make_mesh(n_model=
    config.n_model_shards)`, one rank without a process group), whose data
    axis scales the warmup schedule.  Weights (the same on every rank) are
    the port's init from `torch.Generator` seeded `config.seed`, or the
    flax-layout NumPy `init_variables` (`compat.load_flax_variables`),
    loaded while the model is whole; then a model axis shards the kernels
    `tp_rule` claims (`parallel.shard_parameters`), and the optimizer is
    built over the slices.  `config.model` is any registry name.  The
    detection task trains with the SSD loss and the selective L2 penalty
    (the kernels of the neck and head layers of every SSD family,
    `losses.default_ssd_reg_filter`); the classification task with the
    cross-entropy and top-1/top-5 metrics, no L2 term (as in the JAX
    package)."""
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else make_mesh(n_model=config.n_model_shards)
    if config.task not in ("detection", "classification"):
        raise ValueError(f"unknown task {config.task!r}")
    model_kwargs = dict(config.model_kwargs)
    model_kwargs.setdefault("dtype", _COMPUTE_DTYPES[config.compute_dtype])
    if config.remat:
        model_kwargs.setdefault("remat", True)
    module, example_inputs = build_model(
        config.model, device=dev, generator=torch.Generator().manual_seed(config.seed),
        **model_kwargs,
    )
    if init_variables is not None:
        load_flax_variables(module, init_variables)
    shard_parameters(module, mesh, tp_rule)
    if config.task == "detection":
        loss_fn = detection_loss_fn(SSDLoss(), l2_scale=config.l2_regularization)
    else:
        loss_fn = classification_loss_fn()
    trainer = Trainer(
        model=module,
        loss_fn=loss_fn,
        optimizer=build_optimizer(config, module.parameters(), mesh.n_data),
        schedule=_make_schedule(config, mesh.n_data),
        target_encoder=target_encoder,
        augment_fn=augment_fn,
        freeze_bn=config.freeze_bn,
        pallas_wgrad=config.pallas_wgrad,
        device=dev,
        mesh=mesh,
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
    mesh: Mesh | None = None,
    tp_rule=tensor_parallel_rule,
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
    `step_generator(config.seed + 1, s)` and the model's dropout
    `dropout_step_generator(config.seed + 1, s)`, so a restarted run draws
    what an uninterrupted one draws.

    `steps_per_call` groups that many batches into one `Trainer.train_steps`
    call, with the JAX package's rules: a group never straddles an epoch or
    `max_steps`, the remainder runs as single steps, and the steps draw what
    single steps draw, so the run is the same whatever the group size.

    With a `mesh` (None: `make_mesh(n_model=config.n_model_shards)`)
    `config.batch_size` is the global batch, which the data axis's n_data
    must divide, and `train_pipeline` yields this rank's rows
    (`parallel.shard_batch` of a global batch, or a pipeline of `batch_size
    // n_data` rows a rank, the same on the ranks of a model group); the
    model axis shards the kernels `tp_rule` claims (`build_trainer`).
    Every rank restores the checkpoint (its slices of the whole tensors);
    every rank gathers each checkpoint's state, world rank 0 alone writes
    it and the metric rows, and every rank waits for each checkpoint.
    """
    trainer, _, _ = build_trainer(config, target_encoder, augment_fn, device, mesh,
                                  init_variables, tp_rule)
    mesh = trainer.mesh
    if config.batch_size % mesh.n_data:
        raise ValueError(f"global batch_size {config.batch_size} must be divisible by the "
                         f"mesh data axis ({mesh.n_data} shards)")

    primary = mesh.rank == 0
    writer = MetricWriter(run_dir if primary else None, tensorboard=config.tensorboard)
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
            "lr": _schedule_value(config, trainer.step, mesh.n_data),
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
            state = checkpoint_state(trainer)
            if primary:
                ckpt.save(trainer.step, trainer, state)
            barrier(mesh)
        if done:
            break
    writer.close()
    return trainer, history


def make_validation_fn(trainer: Trainer | None, val_pipeline):
    """Per-epoch validation hook for `fit(val_fn=...)`: the eval-mode model
    over `val_pipeline`, the mean over batches of the SSD loss (batches with
    "targets", or padded GT and a trainer with a target encoder) or of the
    cross-entropy, top-1 and top-5 (batches with "labels").

    The hook evaluates the trainer it is called with, as the JAX package's
    hook evaluates the state it is handed; so it can be made before `fit`
    builds its trainer (`trainer` is the JAX signature's and may be None)."""
    ssd_loss, cls_metrics = SSDLoss(), classification_loss_fn()

    def val_fn(current: Trainer) -> dict:
        eval_apply = current.eval_step()
        rows = []
        for batch in val_pipeline:
            if "targets" in batch:
                targets = torch.as_tensor(batch["targets"], device=current.device)
            elif "gt" in batch and current.target_encoder is not None:
                with torch.no_grad():
                    targets = current.target_encoder(batch["gt"], batch["gt_mask"])
            else:
                labels = torch.as_tensor(batch["labels"], device=current.device)
                _, metrics = cls_metrics(None, eval_apply(batch["inputs"]), {"labels": labels})
                rows.append({k: float(v) for k, v in metrics.items()})
                continue
            rows.append({"loss": float(ssd_loss(targets, eval_apply(batch["inputs"])))})
        if not rows:
            return {}
        return {k: sum(r[k] for r in rows) / len(rows) for k in rows[0]}

    return val_fn
