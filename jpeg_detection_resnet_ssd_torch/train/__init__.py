"""Training: the train step, SGD, schedules, checkpoints and the loop (torch)."""

from jpeg_detection_resnet_ssd_torch.train.checkpoints import CheckpointManager, CSVLogger
from jpeg_detection_resnet_ssd_torch.train.config import ExperimentConfig
from jpeg_detection_resnet_ssd_torch.train.loop import (
    NaNLossError,
    build_optimizer,
    build_trainer,
    fit,
    make_validation_fn,
)
from jpeg_detection_resnet_ssd_torch.train.metrics import MetricWriter
from jpeg_detection_resnet_ssd_torch.train import schedules
from jpeg_detection_resnet_ssd_torch.train.schedules import (
    keras_inverse_time_decay,
    warmup_linear_scaling,
)
from jpeg_detection_resnet_ssd_torch.train.trainer import Trainer, detection_loss_fn

__all__ = [
    "CSVLogger",
    "CheckpointManager",
    "ExperimentConfig",
    "MetricWriter",
    "NaNLossError",
    "Trainer",
    "build_optimizer",
    "build_trainer",
    "detection_loss_fn",
    "fit",
    "keras_inverse_time_decay",
    "make_validation_fn",
    "schedules",
    "warmup_linear_scaling",
]
