"""Model registry with the JAX package's registry names.

`build_model(name, **kwargs) -> (module, example_inputs_fn)`, as in the JAX
package's `models/zoo.py`: the ResNet-50 and VGG classifiers and the SSD300
detectors, every name the JAX registry has.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from jpeg_detection_resnet_ssd_torch.models.resnet import (
    CLASSIFICATION_ARCHIS,
    ResNet50DCT,
    ResNet50RGB,
)
from jpeg_detection_resnet_ssd_torch.models.ssd import (
    SSDResNetCustom,
    SSDResNetIdentical,
    SSDVGG,
    SSDVGGDCT,
    SSDVGGDCTImage,
)
from jpeg_detection_resnet_ssd_torch.models.vgg import VGG, VGGDCT, VGGDCT8x8
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device

# Input tensor contracts (jpeg2dct layout, NHWC):
#   classification (224x224 source): Y (28,28,64), CbCr (14,14,128),
#     deconv splits CbCr into Cb (14,14,64) + Cr (14,14,64).
#   detection (300x300 source): Y (38,38,64), CbCr (19,19,128) / split 19x19.
CLS_Y, CLS_CBCR = (28, 28, 64), (14, 14, 128)
CLS_CB = CLS_CR = (14, 14, 64)
DET_Y, DET_CBCR = (38, 38, 64), (19, 19, 128)
DET_CB = DET_CR = (19, 19, 64)


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


@dataclasses.dataclass(frozen=True)
class RegistryEntry:
    """A registry name: calling it with the model's keyword arguments
    builds `(module, example_inputs_fn)`.  It also says how the data
    pipeline packs the model's input (`input_format`, as `ExperimentConfig`
    names it) and, for an SSD300, its anchor family (`ssd_predictor_sizes`)."""

    build: Callable[..., tuple[Any, Callable]]
    input_format: str
    ssd_family: str | None = None

    def __call__(self, **kwargs):
        return self.build(**kwargs)


def _dct_format(archi):
    return "dct_deconv" if archi == "deconv" else "dct"


def _cls_dct(archi):
    def build(**kw):
        split = archi == "deconv"
        return (ResNet50DCT(archi=archi, **kw),
                _dct_inputs(2, CLS_Y, CLS_CB if split else CLS_CBCR, split))

    return RegistryEntry(build, _dct_format(archi))


def _det_resnet(archi):
    if archi == "ssd_custom":
        return RegistryEntry(lambda **kw: (SSDResNetCustom(**kw), _dct_inputs(2, DET_Y, DET_CBCR)),
                             "dct", "resnet_custom")
    split = archi == "deconv"
    return RegistryEntry(
        lambda **kw: (SSDResNetIdentical(archi=archi, **kw),
                      _dct_inputs(2, DET_Y, DET_CB if split else DET_CBCR, split)),
        _dct_format(archi), "resnet_identical")


def _cls(module, variant, inputs, input_format):
    return RegistryEntry(lambda **kw: (module(variant=variant, **kw), inputs), input_format)


MODEL_REGISTRY: dict[str, RegistryEntry] = {
    # classification
    "resnet50_rgb": RegistryEntry(lambda **kw: (ResNet50RGB(**kw), _image_inputs(2, (224, 224, 3))),
                                  "rgb"),
    **{f"resnet50_dct_{a}": _cls_dct(a) for a in CLASSIFICATION_ARCHIS},
    **{f"vgg{v}": _cls(VGG, v, _image_inputs(2, (224, 224, 3)), "rgb") for v in "ad"},
    **{f"vgg{v}_dct": _cls(VGGDCT, v, _dct_inputs(2, CLS_Y, CLS_CBCR), "dct") for v in "ad"},
    **{f"vgg{v}_dct_8x8": _cls(VGGDCT8x8, v, _image_inputs(2, (224, 224, 3)), "dct_image")
       for v in "ad"},
    # detection
    **{f"ssd300_{a}": _det_resnet(a) for a in
       ("ssd_custom", "deconv", "up_sampling", "cb5_only", "y_cb4_cbcr_cb5")},
    "ssd300_vgg": RegistryEntry(lambda **kw: (SSDVGG(**kw), _image_inputs(2, (300, 300, 3))),
                                "rgb", "vgg"),
    "ssd300_vgg_dct": RegistryEntry(
        lambda **kw: (SSDVGGDCT(**kw), _dct_inputs(2, DET_Y, DET_CBCR)), "dct", "vgg_dct"),
    "ssd300_vgg_dct_image": RegistryEntry(
        lambda **kw: (SSDVGGDCTImage(**kw), _image_inputs(2, (300, 300, 3))),
        "dct_image", "vgg_dct_image"),
}


def ssd_family(model: str) -> str:
    """The `ssd_predictor_sizes` family of an SSD300 registry name."""
    entry = MODEL_REGISTRY.get(model)
    if entry is None or entry.ssd_family is None:
        raise ValueError(f"{model!r} is not an SSD300 registry name")
    return entry.ssd_family


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
    arguments are the model's (`n_classes` and `remat` for the detectors,
    `num_classes` for the classifiers, `remat` for the ResNets and
    `include_top` for `resnet50_rgb`).
    """
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    module, example_inputs = MODEL_REGISTRY[name](dtype=dtype, generator=generator, **kwargs)
    return module.to(dev).eval(), example_inputs
