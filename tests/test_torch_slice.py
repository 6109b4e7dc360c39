"""Port parity for the whole slice: `ssd300_ssd_custom` at B=1 in float32,
JAX package vs PyTorch port with the same weights (CPU), then the inference
decode on top.

Tolerances: anchor and variance columns are exact (the same NumPy anchors);
conf and loc agree to rtol 1e-4 with atol 1e-4 * max|ref| per block -- ~60
convolutions whose sums run in another order in XLA and in PyTorch's CPU
kernels, each adding a few float32 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.boxes.anchors import AnchorSpec as JaxAnchorSpec
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.models import make_inference_fn as jax_inference_fn
from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec
from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables
from jpeg_detection_resnet_ssd_torch.models import build_model, make_inference_fn

from test_torch_decode import assert_same_detections
from torch_parity import random_flax_variables

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def slice_outputs():
    module, example = jax_build_model("ssd300_ssd_custom", n_classes=20)
    y, cbcr = (a[:1] for a in example(np.random.default_rng(7)))
    variables = random_flax_variables(module, (y, cbcr), train=False, seed=0)
    ref = np.array(
        jax.jit(lambda v, i: module.apply(v, i, train=False))(variables, (y, cbcr))
    )
    port, port_example = build_model("ssd300_ssd_custom", n_classes=20, device="cpu")
    load_flax_variables(port, variables)
    with torch.no_grad():
        got = port((torch.from_numpy(y), torch.from_numpy(cbcr)))
    return ref, got, port_example


def test_forward_matches_jax(slice_outputs):
    ref, got, _ = slice_outputs
    assert got.dtype == torch.float32
    got = got.numpy()
    assert got.shape == ref.shape == (1, 8732, 21 + 12)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[..., 25:], ref[..., 25:])  # anchors, variances
    for block in (slice(0, 21), slice(21, 25)):  # softmax conf, loc offsets
        np.testing.assert_allclose(
            got[..., block], ref[..., block],
            rtol=1e-4, atol=1e-4 * np.abs(ref[..., block]).max(),
        )


@pytest.mark.parametrize("selector", ["exact", "shared"])
def test_inference_fn_matches_jax(slice_outputs, selector):
    """The decode on top, fed the same raw predictions on both sides."""
    ref_pred, _, _ = slice_outputs
    kw = dict(n_classes=20, candidate_selector=selector)
    ref = np.asarray(jax_inference_fn(spec=JaxAnchorSpec(), nms_impl="xla", **kw)(
        jnp.asarray(ref_pred)
    ))
    got = make_inference_fn(spec=AnchorSpec(), device="cpu", **kw)(ref_pred).numpy()
    assert (got[..., 1] > 0).sum() > 100
    assert_same_detections(got, ref)


def test_port_end_to_end_detections(slice_outputs):
    """The port's own forward + decode: the JAX detections up to the forward
    tolerance (same classes and order, boxes to 1e-3 px)."""
    ref_pred, got_pred, _ = slice_outputs
    kw = dict(n_classes=20, candidate_selector="shared")
    ref = np.asarray(jax_inference_fn(spec=JaxAnchorSpec(), nms_impl="xla", **kw)(
        jnp.asarray(ref_pred)
    ))
    got = make_inference_fn(spec=AnchorSpec(), device="cpu", **kw)(got_pred).numpy()
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_allclose(got[..., 1], ref[..., 1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[..., 2:], ref[..., 2:], rtol=0, atol=1e-3)


def test_example_inputs_contract(slice_outputs):
    *_, example = slice_outputs
    y, cbcr = example()
    assert y.shape == (2, 38, 38, 64) and cbcr.shape == (2, 19, 19, 128)
    assert y.dtype == cbcr.dtype == np.float32
