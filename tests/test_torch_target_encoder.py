"""Port parity for the SSD target encoder (CPU).

The port's `TargetEncoder` (batched, plain matching on the CPU) against the
JAX package's (`bipartite_impl="xla"`) on the same padded GT with duplicate
boxes.  The one-hot columns (which anchor is positive, neutral or
background, and its class) and the anchor and variance columns must be
exactly equal.  The offsets agree with the JAX function run op by op
(`jax.vmap` of `encode_targets`, not jitted) to rtol 1e-6 / atol 1e-6: the
same float32 operations.  Against the jitted encoder they agree to rtol
1e-5 / atol 1e-5: XLA compiles its divisions by constants into multiplies
by reciprocals and refactors sums, so a GT centroid can differ in its last
bit, and an offset (the difference of two nearly equal centroids over a
small anchor width) amplifies that to up to ~3e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.boxes import AnchorSpec as JaxAnchorSpec
from jpeg_detection_resnet_ssd_tpu.boxes import TargetEncoder as JaxTargetEncoder
from jpeg_detection_resnet_ssd_tpu.boxes.target_encoder import encode_targets as jax_encode
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes

from torch_cases import N_CLASSES, gt_batch

torch.set_num_threads(1)

SIZES = ssd_predictor_sizes("resnet_custom")


def encoders(**kw):
    port = TargetEncoder(AnchorSpec(), SIZES, n_classes=N_CLASSES, device="cpu", **kw)
    ref = JaxTargetEncoder(JaxAnchorSpec(), SIZES, n_classes=N_CLASSES, bipartite_impl="xla", **kw)
    return port, ref


@pytest.mark.parametrize("matching_type", ["multi", "bipartite"])
@pytest.mark.parametrize("log_scale_offsets", [True, False])
def test_targets_match_jax(matching_type, log_scale_offsets):
    gt, mask = gt_batch(np.random.default_rng(11), [5, 1, 10, 0])
    port, ref = encoders(matching_type=matching_type, log_scale_offsets=log_scale_offsets)
    want = np.asarray(ref(gt, mask))
    got = port(gt, mask).numpy()
    n_total = N_CLASSES + 1
    off = slice(n_total, n_total + 4)
    assert got.shape == want.shape == (4, 8732, n_total + 12)
    np.testing.assert_array_equal(got[..., :n_total], want[..., :n_total])
    np.testing.assert_array_equal(got[..., n_total + 4:], want[..., n_total + 4:])
    np.testing.assert_allclose(got[..., off], want[..., off], rtol=1e-5, atol=1e-5)
    op_by_op = jax.vmap(functools.partial(
        jax_encode, anchors=jnp.asarray(ref.anchors), n_classes=N_CLASSES, img_height=300,
        img_width=300, matching_type=matching_type, log_scale_offsets=log_scale_offsets,
        bipartite_impl="xla",
    ))(jnp.asarray(gt), jnp.asarray(mask))
    np.testing.assert_allclose(got[..., off], np.asarray(op_by_op)[..., off], rtol=1e-6, atol=1e-6)
    positives = got[..., 1:n_total].sum(-1)
    assert positives[3].sum() == 0  # no GT, no positives
    assert (positives[:3].sum(-1) >= [4, 1, 9]).all()  # at least one anchor per box


def test_border_modes_and_thresholds_match_jax():
    gt, mask = gt_batch(np.random.default_rng(12), [6, 3])
    for border in ("include", "exclude"):
        port, ref = encoders(border_pixels=border, pos_iou_threshold=0.4, neg_iou_limit=0.2)
        np.testing.assert_array_equal(port(gt, mask).numpy()[..., :N_CLASSES + 1],
                                      np.asarray(ref(gt, mask))[..., :N_CLASSES + 1])


def test_encoder_contract():
    port, ref = encoders()
    assert port.n_boxes == ref.n_boxes == 8732
    np.testing.assert_array_equal(port.anchors, ref.anchors)
    labels = [np.array([[1, 10, 10, 50, 50]]), np.zeros((0, 5)), np.ones((70, 5))]
    for a, b in zip(port.pad_labels(labels), ref.pad_labels(labels)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="bipartite_impl"):
        TargetEncoder(AnchorSpec(), SIZES, bipartite_impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="runs on cuda"):
        TargetEncoder(AnchorSpec(), SIZES, bipartite_impl="kernel", device="cpu")(*gt_batch(
            np.random.default_rng(0), [1]))
