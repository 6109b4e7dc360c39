"""Checkpoints with restart-from-latest, and the append-mode CSV log.

Counterpart of the JAX package's `train/checkpoints.py`, which stores an
orbax checkpoint per step.  Here a checkpoint is one `torch.save` file,
`ckpt_{step:08d}.pt`, holding the model's state_dict (parameters and
BatchNorm statistics), the optimizer's state_dict (momentum buffers) and
the step; the newest `max_to_keep` are kept.
"""

from __future__ import annotations

import csv
import os
import re

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


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

    def save(self, step: int, trainer) -> None:
        """Write the trainer's state (written to a temporary name and renamed,
        so a reader never sees half a file), then drop the oldest beyond
        `max_to_keep`."""
        state = {
            "step": int(trainer.step),
            "model": trainer.model.state_dict(),
            "optimizer": trainer.optimizer.state_dict(),
        }
        path = self._path(step)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.unlink(self._path(old))

    def restore(self, trainer, step: int | None = None):
        """Load the checkpoint of `step` (the latest when None) into the
        trainer's model, optimizer and step; returns the trainer."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(trainer.model.parameters()).device
        state = torch.load(self._path(step), map_location=device, weights_only=True)
        trainer.model.load_state_dict(state["model"])
        trainer.optimizer.load_state_dict(state["optimizer"])
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
