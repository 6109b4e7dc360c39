"""The train step: target encoding, forward, SSD loss, backward, SGD.

Counterpart of the JAX package's `train/trainer.py`.  The JAX step is a pure
function `(state, batch, rng) -> (state, metrics)` compiled once; here the
`Trainer` owns an `nn.Module` and a `torch.optim` optimizer and steps them
in place, in the JAX step's order:

  augment hook -> target encoding (when the batch carries padded GT) ->
  train-mode forward (with `freeze_bn`: eval-mode forward, statistics
  untouched) -> loss + selective L2 -> backward -> SGD update -> step + 1.

`pallas_wgrad` scopes `models.layers.pallas_wgrad` to the step's forward,
so two trainers in one process can differ.  `ssd_custom` has no dropout; the generator passed to a
step reaches only the augment hook.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from jpeg_detection_resnet_ssd_torch.losses import SSDLoss, l2_regularization_loss
from jpeg_detection_resnet_ssd_torch.models import layers
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device


def detection_loss_fn(ssd_loss: SSDLoss = SSDLoss(), l2_scale: float = 5e-4):
    """(model, outputs, batch) -> (loss, metrics) for SSD training:
    `ssd_loss` on batch["targets"] plus the selective L2 penalty."""

    def fn(model, outputs, batch):
        loss = ssd_loss(batch["targets"], outputs)
        reg = (l2_regularization_loss(model, l2_scale) if l2_scale
               else torch.zeros((), device=loss.device))
        return loss + reg, {"loss": loss, "reg": reg}

    return fn


@dataclasses.dataclass(eq=False)
class Trainer:
    """Owns one model's train and eval steps.

    Args:
      model: module whose forward takes `batch["inputs"]`.
      loss_fn: (model, outputs, batch) -> (scalar, metrics dict).
      optimizer: a torch optimizer over the model's parameters.
      schedule: step -> lr, applied before each update (None: keep the
        optimizer's lr).
      target_encoder: (gt, gt_mask) -> targets, used when a batch carries
        padded GT instead of "targets".
      augment_fn: (batch, generator) -> batch, before the encoder.
      device: where the step runs; None means CUDA and raises without a card.
    """

    model: nn.Module
    loss_fn: Callable
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float] | None = None
    target_encoder: Callable | None = None
    augment_fn: Callable | None = None
    freeze_bn: bool = False
    pallas_wgrad: bool = False
    device: str | torch.device | None = None
    step: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model.to(self.device)

    def _as_device(self, x):
        return torch.as_tensor(x, device=self.device)

    def train_step(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """One optimisation step; returns 0-dim metric tensors on the device
        (reading them synchronises, so the loop reads them rarely)."""
        if self.augment_fn is not None:
            batch = self.augment_fn(batch, generator)
        batch = dict(batch)
        inputs = tuple(self._as_device(a) for a in batch["inputs"])
        if self.target_encoder is not None and "targets" not in batch:
            with torch.no_grad():
                batch["targets"] = self.target_encoder(batch.pop("gt"), batch.pop("gt_mask"))
        else:
            batch["targets"] = self._as_device(batch["targets"])

        self.model.train(not self.freeze_bn)
        with layers.pallas_wgrad(self.pallas_wgrad):
            outputs = self.model(inputs)
        loss, metrics = self.loss_fn(self.model, outputs, batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.schedule is not None:
            lr = float(self.schedule(self.step))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return {**{k: v.detach() for k, v in metrics.items()}, "total_loss": loss.detach()}

    def train_steps(self, batches, generator: torch.Generator | None = None) -> dict:
        """K sequential steps (the JAX package fuses them into one program;
        the math is the same); each metric comes back with shape (K,)."""
        rows = [self.train_step(b, generator) for b in batches]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def eval_step(self):
        """inputs -> the model's eval-mode outputs, without gradients."""

        def step(inputs):
            self.model.eval()
            with torch.no_grad():
                return self.model(tuple(self._as_device(a) for a in inputs))

        return step
