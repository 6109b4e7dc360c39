"""PyTorch/CUDA port of `jpeg_detection_resnet_ssd_tpu` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
subpackage layout (`boxes`, `models`, `losses`, `train`, `ops`, `compat`,
`utils`), public function names, NHWC input contracts and Keras layer names,
so any ported function can be called on both packages with the same NumPy
arrays.

It imports torch, numpy and the standard library only: never jax, flax or
the JAX package.  Entry points (`models.build_model`,
`models.make_inference_fn`, `boxes.TargetEncoder`, `train.Trainer`,
`train.build_trainer`, `train.fit`) run on the CUDA device unless the caller
passes `device="cpu"`, and raise when no CUDA device is present.

The hand-written kernels of the ported slices (`ops/csrc/`): the batched
greedy NMS (`ops.batched_nms`), the greedy bipartite GT-anchor matching
(`ops.bipartite_match`) and the filter gradient of 3x3 convolutions
(`ops.conv_grad`).
"""
