"""PyTorch/CUDA port of `jpeg_detection_resnet_ssd_tpu` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
subpackage layout (`boxes`, `models`, `ops`, `compat`, `utils`), public
function names, NHWC input contracts and Keras layer names, so any ported
function can be called on both packages with the same NumPy arrays.

It imports torch, numpy and the standard library only: never jax, flax or
the JAX package.  Entry points (`models.build_model`,
`models.make_inference_fn`) run on the CUDA device unless the caller passes
`device="cpu"`, and raise when no CUDA device is present.

The only hand-written kernel of the ported slice is the batched greedy NMS
(`ops/csrc/batched_nms.cu`, wrapper `ops.batched_nms.batched_nms_mask`).
"""
