"""PyTorch/CUDA port of `jpeg_detection_resnet_ssd_tpu` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
subpackage layout (`boxes`, `models`, `losses`, `train`, `ops`, `compat`,
`dctjpeg`, `data`, `eval`, `serve`, `parallel`, `cli`, `utils`), public function names, NHWC
input contracts and Keras layer names, so any ported function can be called
on both packages with the same NumPy arrays.

It imports torch, numpy and the standard library at module level: never
jax, flax or the JAX package.  PIL, OpenCV and h5py are imported only inside
the functions that decode images, resize them or read H5 files, and the
JPEG decoder (`dctjpeg`) is built with g++ against libjpeg at first use.
Entry points (`models.build_model`,
`models.make_inference_fn`, `boxes.TargetEncoder`, `train.Trainer`,
`train.build_trainer`, `train.fit`, the `ops.make_dct_detection_augment*`
makers, the command line's `evaluate` and `infer`) run on the CUDA device
unless the caller passes `device="cpu"`, and raise when no CUDA device is
present.

The hand-written kernels of the ported slices (`ops/csrc/`), one for each
Pallas kernel of the JAX package: the batched greedy NMS
(`ops.batched_nms`), the greedy bipartite GT-anchor matching
(`ops.bipartite_match`), the filter gradient of 3x3 convolutions
(`ops.conv_grad`) and the coefficient-space horizontal flip of the device
augmentation chain (`ops.dct_flip`, used by `ops.dct_detect_augment`).
"""
