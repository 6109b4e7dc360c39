"""Port parity: prediction decoding, JAX package vs PyTorch port (CPU).

One seeded raw prediction tensor (2, 8732, 21 + 12) with rows saturated to
exact ties goes through the JAX `decode_detections(nms_impl="xla")` and the
port's `decode_detections`.  Class ids and row order must be equal; boxes
and scores agree to atol 1e-5 (scores are selected, not computed, so they
are bit-equal; boxes carry one `exp` each, whose last bit may differ between
XLA's and PyTorch's CPU implementations, so they also get rtol 1e-6, one
float32 ulp or so at 300-pixel coordinates).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.boxes import decode as jax_decode
from jpeg_detection_resnet_ssd_torch.boxes import decode as port_decode

from torch_cases import N_CLASSES, raw_predictions

torch.set_num_threads(1)


def assert_same_detections(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])  # class ids, in order
    np.testing.assert_allclose(got[..., 1], ref[..., 1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., 2:], ref[..., 2:], rtol=1e-6, atol=1e-5)


KW = dict(n_classes=N_CLASSES, confidence_thresh=0.01, iou_threshold=0.45,
          top_k=200, nms_max_output_size=400)


@pytest.mark.parametrize("selector", ["exact", "shared"])
def test_decode_detections_matches_jax(selector):
    y = raw_predictions()
    ref = np.asarray(jax_decode.decode_detections(
        jnp.asarray(y), nms_impl="xla", candidate_selector=selector, **KW
    ))
    got = port_decode.decode_detections(
        torch.from_numpy(y), candidate_selector=selector, **KW
    ).numpy()
    assert (ref[..., 1] == 1.0).sum() > 50  # the tie-breaking is exercised
    assert_same_detections(got, ref)


@pytest.mark.parametrize("border", ["include", "exclude"])
def test_decode_border_modes_match_jax(border):
    y = raw_predictions(seed=1, batch=1)
    kw = dict(KW, border_pixels=border, nms_max_output_size=64, top_k=100)
    ref = np.asarray(jax_decode.decode_detections(jnp.asarray(y), nms_impl="xla", **kw))
    got = port_decode.decode_detections(torch.from_numpy(y), **kw).numpy()
    assert_same_detections(got, ref)


def test_shared_pool_smaller_than_candidates_matches_jax():
    """The pool (128) is far below the boxes clearing the threshold."""
    y = raw_predictions(seed=2, batch=1)
    kw = dict(KW, candidate_selector="shared", shared_pool_size=128)
    ref = np.asarray(jax_decode.decode_detections(jnp.asarray(y), nms_impl="xla", **kw))
    got = port_decode.decode_detections(torch.from_numpy(y), **kw).numpy()
    assert_same_detections(got, ref)


@pytest.mark.parametrize("log_scale", [True, False])
def test_decode_raw_predictions_matches_jax(log_scale):
    y = raw_predictions(seed=3, batch=1)
    kw = dict(img_height=300, img_width=300, log_scale_offsets=log_scale)
    s_ref, b_ref = jax_decode.decode_raw_predictions(jnp.asarray(y), **kw)
    s_got, b_got = port_decode.decode_raw_predictions(torch.from_numpy(y), **kw)
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_ref))
    np.testing.assert_allclose(b_got.numpy(), np.asarray(b_ref), rtol=1e-6, atol=1e-5)
    with pytest.raises(NotImplementedError):
        port_decode.decode_raw_predictions(torch.from_numpy(y), input_coords="corners")


def test_sorted_top_k_breaks_ties_by_lower_index():
    x = torch.tensor([[0.5, 1.0, 0.2, 1.0, 1.0, 0.5]])
    values, idx = port_decode.sorted_top_k(x, 5)
    assert idx.tolist() == [[1, 3, 4, 0, 5]]
    assert values.tolist() == [[1.0, 1.0, 1.0, 0.5, 0.5]]


def test_nms_impls_on_cpu():
    y = torch.from_numpy(raw_predictions(seed=4, batch=1))
    kw = dict(KW, candidate_selector="shared")
    auto = port_decode.decode_detections(y, nms_impl="auto", **kw)
    ref = port_decode.decode_detections(y, nms_impl="reference", **kw)
    assert torch.equal(auto, ref)
    with pytest.raises(ValueError, match="CUDA"):
        port_decode.decode_detections(y, nms_impl="kernel", **kw)
    with pytest.raises(ValueError, match="nms_impl"):
        port_decode.decode_detections(y, nms_impl="pallas", **kw)


def test_approx_selectors_are_exact():
    """`approx` named the TPU's `lax.approx_max_k`; the port selects exactly."""
    y = torch.from_numpy(raw_predictions(seed=5, batch=1))
    kw = dict(KW, nms_max_output_size=64, top_k=100)
    exact = port_decode.decode_detections(y, candidate_selector="exact", **kw)
    approx = port_decode.decode_detections(y, candidate_selector="approx", **kw)
    assert torch.equal(exact, approx)
    shared = port_decode.decode_detections(y, candidate_selector="shared", **kw)
    pool_approx = port_decode.decode_detections(
        y, candidate_selector="shared", pool_topk_impl="approx", **kw
    )
    assert torch.equal(shared, pool_approx)
