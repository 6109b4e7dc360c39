"""Training: the train step, SGD, schedules, checkpoints and the loop (torch)."""

from jpeg_detection_resnet_ssd_torch.train.checkpoints import (
    CheckpointManager,
    CSVLogger,
    checkpoint_state,
)
from jpeg_detection_resnet_ssd_torch.train.config import ExperimentConfig
from jpeg_detection_resnet_ssd_torch.train.loop import (
    BF16MomentumSGD,
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
from jpeg_detection_resnet_ssd_torch.train.trainer import (
    Trainer,
    classification_loss_fn,
    detection_loss_fn,
    dropout_step_generator,
    step_generator,
)

__all__ = [
    "BF16MomentumSGD",
    "CSVLogger",
    "CheckpointManager",
    "checkpoint_state",
    "ExperimentConfig",
    "MetricWriter",
    "NaNLossError",
    "Trainer",
    "build_optimizer",
    "build_trainer",
    "classification_loss_fn",
    "detection_loss_fn",
    "dropout_step_generator",
    "fit",
    "keras_inverse_time_decay",
    "make_validation_fn",
    "schedules",
    "step_generator",
    "warmup_linear_scaling",
]
