"""The train step: target encoding, forward, loss, backward, SGD.

Counterpart of the JAX package's `train/trainer.py`, for detection (SSD
loss + selective L2) and classification (cross-entropy, top-1/top-5).  The
JAX step is a pure function `(state, batch, rng) -> (state, metrics)`
compiled once; here the `Trainer` owns an `nn.Module` and a `torch.optim`
optimizer and steps them in place, in the JAX step's order:

  augment hook -> target encoding (when the batch carries padded GT; a
  classification batch carries int "labels") -> train-mode forward (with
  `freeze_bn`: eval-mode forward, statistics untouched) -> loss (+ the
  detector's selective L2) -> backward -> SGD update -> step + 1.

`pallas_wgrad` scopes `models.layers.pallas_wgrad` to the step's forward,
so two trainers in one process can differ.  A step takes two CPU
generators: one for the augment hook, one for the VGG classifiers' train-
mode dropout (`models.layers.dropout_rng`, opened around the forward), the
counterparts of JAX's `aug_rng, drop_rng = split(fold_in(rng, step))`.
Step s of a run seeded `seed` draws from `step_generator(seed, s)` and
`dropout_step_generator(seed, s)`, whether it runs alone or in
`train_steps`.  With `freeze_bn` the forward is in eval mode, so dropout is
off too, as in the JAX package.

With a `mesh` of more than one data rank (`parallel.make_mesh`), each rank
steps on its rows of the global batch and the step is the single-process
step on the global batch: the step runs inside
`parallel.data_parallel(mesh)`, so BatchNorm, the SSD loss's mining, the
augment's draws and dropout are global, and each rank's loss is its share
of the global loss (the shares sum to it).  The gradient scale: backward of
a rank's share gives that share's gradient (the BatchNorm all-reduce hands
every rank the global statistics' gradient), so the parameter gradients are
SUMMED over the data group, not averaged, and each update equals the
single-process update.  The L2 penalty is added on data index 0 only, so
the sum counts it once.  The reported metrics are summed the same way, so
every rank reads the global values; the ranks' parameters stay
bit-identical.

With a model axis (the model's widest kernels sharded by
`parallel.shard_parameters`, the optimizer built after), the ranks of a
model group hold the same rows and compute the same loss; a sharded kernel
gets the gradient of its slice, a replicated one the same gradient on each
(model index 0's, broadcast over the model group, so the replicas stay
bit-identical), and the SGD momentum of a slice is the slice's.  Each rank
of data index 0 adds the penalty of the replicated kernels and of its own
slices, so each gradient is right; the reported `reg` and `total_loss`
count every slice once (its share summed over the model group), so they
are one process's and the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from jpeg_detection_resnet_ssd_torch.losses import (
    SSDLoss,
    l2_regularization_loss,
    regularized_parameters,
    softmax_cross_entropy,
    top_k_accuracy,
)
from jpeg_detection_resnet_ssd_torch.models import layers
from jpeg_detection_resnet_ssd_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    all_reduce_gradients,
    all_reduce_sum,
    broadcast_replicated_gradients,
    data_parallel,
    model_shards,
    model_sum,
)
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device
from jpeg_detection_resnet_ssd_torch.utils.profiling import span


_MASK64 = (1 << 64) - 1


# XORed into a step's word to seed its dropout stream apart from its augment stream.
_DROPOUT_SALT = 0xD2B74407B1CE6E93


def _splitmix64(word: int) -> int:
    z = (word + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step `step`'s augment hook in a run seeded
    `seed`.

    The port's counterpart of the JAX package's per-step key
    `fold_in(PRNGKey(seed), step)`: a pure function of the pair, so a run
    resumed at step s draws what an uninterrupted run draws at step s.  JAX's
    keys cannot be reproduced in PyTorch, so the rule is the port's own: the
    generator is seeded with splitmix64 of the 64-bit word
    `(seed << 32) + step` (both taken modulo 2**64)."""
    return torch.Generator().manual_seed(_splitmix64((seed << 32) + step))


def dropout_step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step `step`'s dropout masks in a run
    seeded `seed`: splitmix64 of the step's word XOR a salt, so it is a pure
    function of the pair and a stream apart from `step_generator`'s."""
    word = ((seed << 32) + step) & _MASK64
    return torch.Generator().manual_seed(_splitmix64(word ^ _DROPOUT_SALT))


def _l2_penalty(model: nn.Module, scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(penalty in this rank's loss, penalty reported) of the selective L2
    term.  Without sharded kernels both are `l2_regularization_loss`; with
    kernels sharded over the model axis, the first counts the replicated
    kernels and this rank's slices (each gradient is then right), the
    second the replicated kernels and every slice once (one process's
    value, the same on every rank of the model group)."""
    shards = {id(model.get_parameter(k)): s for k, s in model_shards(model).items()}
    if not shards:
        reg = l2_regularization_loss(model, scale)
        return reg, reg
    replicated, own, shard = [], [], None
    for _, p in regularized_parameters(model):
        if id(p) in shards:
            own.append(scale * p.square().sum())
            shard = shards[id(p)]
        else:
            replicated.append(scale * p.square().sum())
    rep = torch.stack(replicated).sum() if replicated else torch.zeros(
        (), device=next(model.parameters()).device)
    if not own:
        return rep, rep
    mine = torch.stack(own).sum()
    return rep + mine, rep.detach() + model_sum(mine, shard)


def detection_loss_fn(ssd_loss: SSDLoss = SSDLoss(), l2_scale: float = 5e-4):
    """(model, outputs, batch) -> (loss, metrics) for SSD training:
    `ssd_loss` on batch["targets"] plus the selective L2 penalty (under data
    parallelism: the rank's share of both, the penalty on data index 0;
    with kernels sharded over the model axis see `_l2_penalty`)."""

    def fn(model, outputs, batch):
        loss = ssd_loss(batch["targets"], outputs)
        mesh = active_mesh()
        if not l2_scale or (mesh is not None and mesh.data_index != 0):
            return loss, {"loss": loss, "reg": torch.zeros((), device=loss.device)}
        reg, reported = _l2_penalty(model, l2_scale)
        return loss + reg, {"loss": loss, "reg": reported, "total_loss": loss + reported}

    return fn


def classification_loss_fn():
    """(model, logits, batch) -> (loss, metrics) for classification:
    `softmax_cross_entropy` on one-hot batch["labels"], no penalty term;
    metrics loss, top1, top5 (under data parallelism each the rank's share
    of the global batch's mean: its rows' mean over the data ranks)."""

    def fn(model, outputs, batch):
        labels = batch["labels"]
        onehot = torch.nn.functional.one_hot(labels.long(), outputs.shape[-1]).float()
        metrics = {
            "loss": softmax_cross_entropy(outputs, onehot),
            "top1": top_k_accuracy(outputs, labels, 1),
            "top5": top_k_accuracy(outputs, labels, 5),
        }
        mesh = active_mesh()
        if mesh is not None:
            metrics = {k: v / mesh.n_data for k, v in metrics.items()}
        return metrics["loss"], metrics

    return fn


@dataclasses.dataclass(eq=False)
class Trainer:
    """Owns one model's train and eval steps.

    Args:
      model: module whose forward takes `batch["inputs"]` (a tuple of
        planes, or one image array).
      loss_fn: (model, outputs, batch) -> (scalar, metrics dict).
      optimizer: a torch optimizer over the model's parameters.
      schedule: step -> lr, applied before each update (None: keep the
        optimizer's lr).
      target_encoder: (gt, gt_mask) -> targets, used when a batch carries
        padded GT instead of "targets".
      augment_fn: (batch, generator) -> batch, before the encoder.
      device: where the step runs; None means CUDA and raises without a card.
      mesh: the (data, model) mesh (None: this process alone); the model's
        kernels are sharded over its model axis before the Trainer is made.
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
    mesh: Mesh | None = None
    step: int = 0

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model.to(self.device)

    def _as_device(self, x):
        return torch.as_tensor(x, device=self.device)

    def _inputs(self, inputs):
        if isinstance(inputs, (tuple, list)):
            return tuple(self._as_device(a) for a in inputs)
        return self._as_device(inputs)

    def train_step(self, batch: dict, generator: torch.Generator | None = None,
                   dropout_generator: torch.Generator | None = None) -> dict:
        """One optimisation step; returns 0-dim metric tensors on the device
        (reading them synchronises, so the loop reads them rarely).
        `generator` goes to the augment hook, `dropout_generator` to the
        model's train-mode dropout (a model with dropout needs one).  With a
        mesh, `batch` is this rank's data index's rows of the global batch."""
        with span("train_step"), data_parallel(self.mesh):
            return self._train_step(batch, generator, dropout_generator)

    def _train_step(self, batch, generator, dropout_generator) -> dict:
        if self.augment_fn is not None:
            with span("augment"):
                batch = self.augment_fn(batch, generator)
        batch = dict(batch)
        inputs = self._inputs(batch["inputs"])
        if "labels" in batch:
            batch["labels"] = self._as_device(batch["labels"])
        elif self.target_encoder is not None and "targets" not in batch:
            with torch.no_grad(), span("encode"):
                batch["targets"] = self.target_encoder(batch.pop("gt"), batch.pop("gt_mask"))
        else:
            batch["targets"] = self._as_device(batch["targets"])

        self.model.train(not self.freeze_bn)
        with (span("forward"), layers.pallas_wgrad(self.pallas_wgrad),
              layers.dropout_rng(dropout_generator)):
            outputs = self.model(inputs)
        with span("loss"):
            loss, metrics = self.loss_fn(self.model, outputs, batch)
        with span("backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.setdefault("total_loss", loss.detach())
        mesh = active_mesh()
        if mesh is not None:  # shares -> global sums (see the module docstring)
            all_reduce_gradients(self.model.parameters(), mesh)
            names = list(metrics)
            summed = all_reduce_sum(torch.stack([metrics[k].float() for k in names]), mesh)
            metrics = {k: summed[i].to(metrics[k].dtype) for i, k in enumerate(names)}
        broadcast_replicated_gradients(self.model)
        with span("optimizer"):
            if self.schedule is not None:
                lr = float(self.schedule(self.step))
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
            self.optimizer.step()
        self.step += 1
        return metrics

    def train_steps(self, batches, seed: int) -> dict:
        """K sequential steps (the JAX package fuses them into one program;
        the math is the same); each metric comes back with shape (K,).

        Each step draws from `step_generator(seed, s)` and
        `dropout_step_generator(seed, s)`, with s read from `self.step` as
        the step starts, as the JAX step folds its key from `state.step`: K
        steps here draw what K `train_step` calls draw."""
        rows = [self.train_step(b, step_generator(seed, self.step),
                                dropout_step_generator(seed, self.step))
                for b in batches]
        return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}

    def eval_step(self):
        """inputs -> the model's eval-mode outputs, without gradients."""

        def step(inputs):
            self.model.eval()
            with torch.no_grad():
                return self.model(self._inputs(inputs))

        return step
