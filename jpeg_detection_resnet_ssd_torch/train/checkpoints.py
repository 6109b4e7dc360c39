"""Checkpoints with restart-from-latest, and the append-mode CSV log.

Counterpart of the JAX package's `train/checkpoints.py`, which stores an
orbax checkpoint per step.  Here a checkpoint is one `torch.save` file,
`ckpt_{step:08d}.pt`, holding the model's state_dict (parameters and
BatchNorm statistics), the optimizer's state_dict (momentum buffers) and
the step; the newest `max_to_keep` are kept.

A checkpoint always holds whole tensors.  Under tensor parallelism
(`parallel.shard_parameters`) `checkpoint_state` gathers the sharded
kernels and their momentum over the model group (every rank calls it; one
writes), and `restore` keeps the rank's slice of each, so a tensor-parallel
run's checkpoint loads into one process and a one-process checkpoint
resumes under tensor parallelism.
"""

from __future__ import annotations

import csv
import os
import re

import torch

from jpeg_detection_resnet_ssd_torch.parallel.mesh import ModelShard, model_shards

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _optimizer_shards(trainer) -> dict[int, ModelShard]:
    """{index in the optimizer's state_dict: ModelShard} of the sharded
    weights (the state_dict numbers the parameters in param-group order)."""
    model = trainer.model
    shards = {id(model.get_parameter(k)): s for k, s in model_shards(model).items()}
    params = [p for group in trainer.optimizer.param_groups for p in group["params"]]
    return {i: shards[id(p)] for i, p in enumerate(params) if id(p) in shards}


def _map_sharded(state: dict, shards: dict, fn) -> dict:
    """`state` with `fn(shard, tensor)` in place of each sharded entry: a
    model state_dict's weights, or each tensor of an optimizer's per-
    parameter state (its momentum buffer)."""
    out = dict(state)
    for key, shard in shards.items():
        if key not in state:
            continue
        value = state[key]
        if isinstance(value, dict):
            out[key] = {k: fn(shard, v) if isinstance(v, torch.Tensor) and v.dim() else v
                        for k, v in value.items()}
        else:
            out[key] = fn(shard, value)
    return out


def _local_copy(shard: ModelShard, whole: torch.Tensor) -> torch.Tensor:
    return shard.local(whole).clone()


def checkpoint_state(trainer) -> dict:
    """The trainer's step, model state_dict and optimizer state_dict with
    whole tensors: a sharded kernel and its momentum gathered over the
    model group (a collective: every rank of the group calls it)."""
    model, optim = trainer.model.state_dict(), trainer.optimizer.state_dict()
    shards = model_shards(trainer.model)
    if shards:
        model = _map_sharded(model, shards, ModelShard.whole)
        optim = dict(optim, state=_map_sharded(optim["state"], _optimizer_shards(trainer),
                                               ModelShard.whole))
    return {"step": int(trainer.step), "model": model, "optimizer": optim}


class CheckpointManager:
    """Save, find and restore a `Trainer`'s state by step."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def all_steps(self) -> list[int]:
        return sorted(
            int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, trainer, state: dict | None = None) -> None:
        """Write the trainer's state, or `state` (`checkpoint_state`, which
        a sharded trainer's ranks gather together before one writes),
        to a temporary name and rename it, so a reader never sees half a
        file; then drop the oldest beyond `max_to_keep`."""
        state = checkpoint_state(trainer) if state is None else state
        path = self._path(step)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.unlink(self._path(old))

    def restore(self, trainer, step: int | None = None):
        """Load the checkpoint of `step` (the latest when None) into the
        trainer's model, optimizer and step, keeping the rank's slice of
        each sharded kernel and its momentum; returns the trainer."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(trainer.model.parameters()).device
        state = torch.load(self._path(step), map_location=device, weights_only=True)
        trainer.model.load_state_dict(_map_sharded(state["model"], model_shards(trainer.model),
                                                   _local_copy))
        optim = state["optimizer"]
        trainer.optimizer.load_state_dict(dict(optim, state=_map_sharded(
            optim["state"], _optimizer_shards(trainer), _local_copy)))
        trainer.step = state["step"]
        return trainer


class CSVLogger:
    """Append-mode CSV metrics log (the role of Keras' CSVLogger)."""

    def __init__(self, path: str):
        self.path = path
        self._fieldnames: list[str] | None = None
        if os.path.exists(path):
            with open(path, newline="") as f:
                header = next(csv.reader(f), None)
                self._fieldnames = list(header) if header else None

    def log(self, row: dict):
        row = {k: (float(v) if hasattr(v, "item") else v) for k, v in row.items()}
        new_file = self._fieldnames is None
        if new_file:
            self._fieldnames = list(row)
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            if new_file:
                writer.writeheader()
            writer.writerow(row)
