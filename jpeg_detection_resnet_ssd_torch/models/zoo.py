"""Model registry with the JAX package's registry names.

`build_model(name, **kwargs) -> (module, example_inputs_fn)`, as in the JAX
package's `models/zoo.py`; only `ssd300_ssd_custom` is ported so far, and
every other registered name raises `NotImplementedError` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import numpy as np
import torch

from jpeg_detection_resnet_ssd_torch.models.ssd import SSDResNetCustom
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device

# Input tensor contracts (jpeg2dct layout, NHWC):
#   detection (300x300 source): Y (38,38,64), CbCr (19,19,128).
DET_Y, DET_CBCR = (38, 38, 64), (19, 19, 128)

_CLASSIFICATION_ARCHIS = (
    "deconv", "up_sampling", "up_sampling_rfa", "late_concat_rfa_thinner",
    "late_concat_more_channels", "cb5_only", "y_cb4_cbcr_cb5",
)

# Registered in the JAX package, not ported yet -> the ROADMAP item porting it.
_NOT_PORTED = {
    "resnet50_rgb": "A12 (slice 5)",
    **{f"resnet50_dct_{a}": "A12 (slice 5)" for a in _CLASSIFICATION_ARCHIS},
    **{n: "A12 (slice 5)" for n in (
        "vgga", "vggd", "vgga_dct", "vggd_dct", "vgga_dct_8x8", "vggd_dct_8x8",
    )},
    **{f"ssd300_{a}": "A12 (slice 5)" for a in (
        "deconv", "up_sampling", "cb5_only", "y_cb4_cbcr_cb5",
        "vgg", "vgg_dct", "vgg_dct_image",
    )},
}


def _dct_inputs(batch, y_shape, cbcr_shape):
    """Example-inputs maker: seeded DCT planes as NumPy float32 arrays, with
    the JAX package's distributions (Y ~ N(0, 100), CbCr ~ N(0, 30))."""

    def make(rng=None):
        rng = rng or np.random.default_rng(0)
        y = rng.normal(0, 100, (batch, *y_shape)).astype(np.float32)
        cbcr = rng.normal(0, 30, (batch, *cbcr_shape)).astype(np.float32)
        return (y, cbcr)

    return make


def build_model(
    name: str,
    *,
    n_classes: int = 20,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
    generator: torch.Generator | None = None,
):
    """Instantiate a registered model: returns (module, example-inputs fn).

    The module is initialised on the CPU from `generator` (a fresh generator
    seeded 0 when None), moved to `device` and put in eval mode.  `device`
    None means CUDA and raises without a card; tests pass `device="cpu"`.
    `dtype` is the compute dtype; parameters stay float32.
    """
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ROADMAP {_NOT_PORTED[name]})"
        )
    if name != "ssd300_ssd_custom":
        raise ValueError(
            f"unknown model {name!r}; available: ['ssd300_ssd_custom']"
        )
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    module = SSDResNetCustom(n_classes=n_classes, dtype=dtype, generator=generator)
    return module.to(dev).eval(), _dct_inputs(2, DET_Y, DET_CBCR)
