"""Model registry with the JAX package's registry names.

`build_model(name, **kwargs) -> (module, example_inputs_fn)`, as in the JAX
package's `models/zoo.py`.  Ported: `ssd300_ssd_custom`, `resnet50_rgb` and
`resnet50_dct_<archi>` for the 7 DCT archis; every other registered name
raises `NotImplementedError` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from jpeg_detection_resnet_ssd_torch.models.resnet import (
    CLASSIFICATION_ARCHIS,
    ResNet50DCT,
    ResNet50RGB,
)
from jpeg_detection_resnet_ssd_torch.models.ssd import SSDResNetCustom
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device

# Input tensor contracts (jpeg2dct layout, NHWC):
#   classification (224x224 source): Y (28,28,64), CbCr (14,14,128),
#     deconv splits CbCr into Cb (14,14,64) + Cr (14,14,64).
#   detection (300x300 source): Y (38,38,64), CbCr (19,19,128).
CLS_Y, CLS_CBCR = (28, 28, 64), (14, 14, 128)
CLS_CB = CLS_CR = (14, 14, 64)
DET_Y, DET_CBCR = (38, 38, 64), (19, 19, 128)

# Registered in the JAX package, not ported yet -> the ROADMAP item porting it.
_NOT_PORTED = {
    **{n: "A12b" for n in (
        "vgga", "vggd", "vgga_dct", "vggd_dct", "vgga_dct_8x8", "vggd_dct_8x8",
    )},
    **{f"ssd300_{a}": "A12b" for a in (
        "deconv", "up_sampling", "cb5_only", "y_cb4_cbcr_cb5",
        "vgg", "vgg_dct", "vgg_dct_image",
    )},
}


def _dct_inputs(batch, y_shape, cbcr_shape, split=False):
    """Example-inputs maker: seeded DCT planes as NumPy float32 arrays, with
    the JAX package's distributions (Y ~ N(0, 100), CbCr ~ N(0, 30)); with
    `split`, Cb and Cr as two planes."""

    def make(rng=None):
        rng = rng or np.random.default_rng(0)
        y = rng.normal(0, 100, (batch, *y_shape)).astype(np.float32)
        if split:
            cb = rng.normal(0, 30, (batch, *cbcr_shape)).astype(np.float32)
            cr = rng.normal(0, 30, (batch, *cbcr_shape)).astype(np.float32)
            return (y, cb, cr)
        cbcr = rng.normal(0, 30, (batch, *cbcr_shape)).astype(np.float32)
        return (y, cbcr)

    return make


def _image_inputs(batch, shape):
    def make(rng=None):
        rng = rng or np.random.default_rng(0)
        return rng.uniform(0, 255, (batch, *shape)).astype(np.float32)

    return make


def _cls_dct(archi):
    def build(**kw):
        split = archi == "deconv"
        return (ResNet50DCT(archi=archi, **kw),
                _dct_inputs(2, CLS_Y, CLS_CB if split else CLS_CBCR, split))

    return build


MODEL_REGISTRY: dict[str, Callable[..., tuple[Any, Callable]]] = {
    "resnet50_rgb": lambda **kw: (ResNet50RGB(**kw), _image_inputs(2, (224, 224, 3))),
    **{f"resnet50_dct_{a}": _cls_dct(a) for a in CLASSIFICATION_ARCHIS},
    "ssd300_ssd_custom": lambda **kw: (SSDResNetCustom(**kw), _dct_inputs(2, DET_Y, DET_CBCR)),
}


def build_model(
    name: str,
    *,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
    **kwargs,
):
    """Instantiate a registered model: returns (module, example-inputs fn).

    The module is initialised on the CPU from `generator` (a fresh generator
    seeded 0 when None), moved to `device` and put in eval mode.  `device`
    None means CUDA and raises without a card; tests pass `device="cpu"`.
    `dtype` is the compute dtype; parameters stay float32.  Other keyword
    arguments are the model's (`n_classes` for the detector, `num_classes`,
    `remat` and, for `resnet50_rgb`, `include_top` for the classifiers).
    """
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP {_NOT_PORTED[name]})"
        )
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    module, example_inputs = MODEL_REGISTRY[name](dtype=dtype, generator=generator, **kwargs)
    return module.to(dev).eval(), example_inputs
