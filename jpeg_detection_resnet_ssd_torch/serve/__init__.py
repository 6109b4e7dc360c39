"""Deployment: BatchNorm folding, `torch.export` artifacts, int8 quantization.

Counterpart of the JAX package's `serve/`:

  * `fold_batch_norm` -- an eval copy of a model with every BatchNorm folded
    into the conv before it (or, for the input BatchNorms, turned into one
    per-channel affine), so the serving forward carries no normalization.
  * `build_serving_fn` / `export_serving_artifact` / `load_serving_artifact`
    -- the folded forward plus the detection decode as one `torch.export`
    program with its weights (`model.pt2`) and a `manifest.json`; a symbolic
    batch serves any batch size.  The decode's NMS is the port's custom
    operator (B1's CUDA kernel on the card), so loading imports
    `jpeg_detection_resnet_ssd_torch.ops`.
  * `quantize_for_serving` -- post-training int8 trunk quantization
    (per-output-channel weights, max-calibrated per-tensor activations,
    int32 accumulation through `torch._int_mm`), composable with folding
    and export.
"""

from jpeg_detection_resnet_ssd_torch.serve.folding import (
    bn_fold_pairs,
    fold_batch_norm,
)
from jpeg_detection_resnet_ssd_torch.serve.export import (
    build_serving_fn,
    export_serving_artifact,
    load_serving_artifact,
)
from jpeg_detection_resnet_ssd_torch.serve.quantize import (
    calibrate_activation_scales,
    make_quantized_apply,
    quantize_conv_weights,
    quantize_for_serving,
)

__all__ = [
    "bn_fold_pairs",
    "fold_batch_norm",
    "build_serving_fn",
    "export_serving_artifact",
    "load_serving_artifact",
    "calibrate_activation_scales",
    "make_quantized_apply",
    "quantize_conv_weights",
    "quantize_for_serving",
]
