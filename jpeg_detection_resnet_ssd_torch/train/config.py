"""Experiment configuration and run directories.

Counterpart of the JAX package's `train/config.py`: the same dataclass
fields and JSON snapshot, so a `saved_config.json` written by either
package loads in the other, and the same run-directory layout
`{output_dir}/{workspace}_{project}_{32 hex}/` with `checkpoints/` and
`results/`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import secrets


@dataclasses.dataclass
class ExperimentConfig:
    # model
    model: str = "ssd300_ssd_custom"
    model_kwargs: dict = dataclasses.field(default_factory=dict)
    task: str = "detection"  # or "classification"
    input_format: str = "dct"

    # optimization (reference defaults: det SGD 1e-3 m.9; cls SGD .1 m.9
    # nesterov decay 1e-4 — `training_dct_pascal_j2d_resnet.py:152`,
    # `config/resnet/config_file.py:51-59`)
    learning_rate: float = 1e-3
    momentum: float = 0.9
    nesterov: bool = False
    lr_decay: float = 0.0
    l2_regularization: float = 5e-4
    warmup_epochs: int = 0
    batch_size: int = 32
    epochs: int = 480
    steps_per_epoch: int = 1000

    # data
    train_data: dict = dataclasses.field(default_factory=dict)
    val_data: dict = dataclasses.field(default_factory=dict)
    num_workers: int = 8
    seed: int = 0

    # parallelism / precision
    n_model_shards: int = 1
    # params stay float32; 'bfloat16' computes the forward and backward in
    # bf16, 'float32' reproduces the reference's numerics.
    compute_dtype: str = "bfloat16"  # 'float32' | 'bfloat16'
    # Momentum accumulator dtype: 'bfloat16' stores the momentum in bf16
    # (half its memory and traffic; the trace rounds to bf16 each step).
    momentum_dtype: str = "float32"  # 'float32' | 'bfloat16'
    # In this package: route the filter gradient of every eligible 3x3
    # stride-1 SAME conv (and of the SSD head) through the CUDA kernel
    # `ops/csrc/conv3x3_wgrad.cu`; forward and input gradient stay on the
    # library's convolutions.  The name is the JAX package's, so a
    # saved_config.json reads the same in both packages.
    pallas_wgrad: bool = False
    remat: bool = False  # recompute bottleneck branches in the backward (memory)
    # Train with BatchNorm frozen: eval-mode normalisation with the running
    # statistics, which stay untouched (fine-tuning from imported weights).
    freeze_bn: bool = False

    # observability
    tensorboard: bool = False

    # experiment management
    workspace: str = "local"
    project: str = "jpeg_dct"
    output_dir: str = "experiments"
    pretrained_weights: str | None = None  # Keras H5 for by-name transfer
    restart: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        data = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in fields})

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_json(f.read())


def create_run_dir(config: ExperimentConfig, key: str | None = None) -> str:
    """Create `{output_dir}/{workspace}_{project}_{key}/` with checkpoints/ and
    results/ subdirs and a config snapshot; returns the run dir path."""
    key = key or secrets.token_hex(16)  # 32 hex chars, as the reference
    run_dir = os.path.join(
        config.output_dir, f"{config.workspace}_{config.project}_{key}"
    )
    os.makedirs(os.path.join(run_dir, "checkpoints"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "results"), exist_ok=True)
    with open(os.path.join(run_dir, "saved_config.json"), "w") as f:
        f.write(config.to_json())
    return run_dir


def find_latest_run(config: ExperimentConfig) -> str | None:
    """Most recently modified run dir for this workspace/project (restart
    support, `training.py:74-103`)."""
    prefix = f"{config.workspace}_{config.project}_"
    base = config.output_dir
    if not os.path.isdir(base):
        return None
    # Anchor the match to the full dir shape ({prefix}{32-hex-key}, the
    # create_run_dir format): a raw prefix match would let a project whose
    # name is a proper prefix of another (e.g. `jpeg` vs `jpeg_dct`) resume
    # a FOREIGN run and restore against a mismatched param tree.
    key_re = re.compile(r"^[0-9a-f]{32}$")
    candidates = [
        os.path.join(base, d)
        for d in os.listdir(base)
        if d.startswith(prefix)
        and key_re.match(d[len(prefix):])
        and os.path.isdir(os.path.join(base, d))
    ]
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)
