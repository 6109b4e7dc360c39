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


def fake_preds(seed, n_boxes=150, n_classes=3):
    """Raw predictions whose decoded boxes and scores are controlled, as the
    JAX package's decode tests build them (`tests/test_boxes.py`): anchors
    scattered over the image, uniform class scores, offsets ~ N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 0.7, (n_boxes, 2))
    wh = rng.uniform(0.05, 0.3, (n_boxes, 2))
    cent = np.concatenate([xy + wh / 2, wh], axis=1).astype(np.float32)
    variances = np.tile([0.1, 0.1, 0.2, 0.2], (n_boxes, 1)).astype(np.float32)
    logits = rng.uniform(0, 1, (n_boxes, n_classes + 1)).astype(np.float32)
    scores = logits / logits.sum(axis=1, keepdims=True)
    offsets = rng.normal(0, 0.5, (n_boxes, 4)).astype(np.float32)
    return np.concatenate([scores, offsets, cent, variances], axis=1)[None]


# (raw predictions, n_classes, keyword arguments) of the A16 decoders.
A16_CASES = {
    "fake": (lambda: fake_preds(0), 3, dict(confidence_thresh=0.3, top_k=50, nms_max_output_size=64)),
    "fake_pad": (lambda: fake_preds(1, n_boxes=60), 3,
                 dict(confidence_thresh=0.2, top_k=100, nms_max_output_size=64)),
    "ssd300": (lambda: raw_predictions(seed=6), N_CLASSES, dict(confidence_thresh=0.01)),
    "ssd300_include": (lambda: raw_predictions(seed=7, batch=1), N_CLASSES,
                       dict(confidence_thresh=0.05, border_pixels="include", top_k=100)),
}


@pytest.mark.parametrize("case", sorted(A16_CASES))
def test_decode_detections_debug_matches_jax(case):
    make, n_classes, kw = A16_CASES[case]
    y = make()
    ref = np.asarray(jax_decode.decode_detections_debug(jnp.asarray(y), n_classes=n_classes, **kw))
    got = port_decode.decode_detections_debug(torch.from_numpy(y), n_classes=n_classes, **kw).numpy()
    assert got.shape == ref.shape == (y.shape[0], kw.get("top_k", 200), 7)
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])  # box ids, exact
    assert_same_detections(got[..., 1:], ref[..., 1:])
    assert (got[..., 2] > 0).sum() > 10
    plain = port_decode.decode_detections(torch.from_numpy(y), n_classes=n_classes, **kw).numpy()
    np.testing.assert_array_equal(got[..., 1:], plain)


@pytest.mark.parametrize("case", sorted(A16_CASES))
def test_decode_detections_fast_matches_jax(case):
    make, _, kw = A16_CASES[case]
    y = make()
    kw = dict(kw, confidence_thresh=max(kw["confidence_thresh"], 0.25))
    ref = np.asarray(jax_decode.decode_detections_fast(jnp.asarray(y), **kw))
    got = port_decode.decode_detections_fast(torch.from_numpy(y), **kw).numpy()
    assert got.shape == ref.shape == (y.shape[0], kw.get("top_k", 200), 6)
    assert_same_detections(got, ref)
    assert (got[..., 1] > 0).sum() > 3


@pytest.mark.parametrize("case,k", [("fake", 64), ("ssd300", 400), ("ssd300", 1)])
@pytest.mark.parametrize("border", ["half", "include"])
def test_nms_per_class_matches_jax(case, k, border):
    make, n_classes, _ = A16_CASES[case]
    y = make()
    _, boxes = port_decode.decode_raw_predictions(torch.from_numpy(y[0]), img_height=300,
                                                  img_width=300)
    for cls in (1, n_classes):
        kw = dict(confidence_thresh=0.05, nms_max_output_size=k, border_pixels=border)
        scores = np.ascontiguousarray(y[0, :, cls])
        ref_s, ref_b = jax_decode.nms_per_class(jnp.asarray(boxes.numpy()), jnp.asarray(scores), **kw)
        got_s, got_b = port_decode.nms_per_class(boxes, torch.from_numpy(scores), **kw)
        assert got_s.shape == (k,) and got_b.shape == (k, 4)
        np.testing.assert_array_equal(got_s.numpy() > 0, np.asarray(ref_s) > 0)  # kept, exact
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
        np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), rtol=1e-6, atol=1e-5)


def test_a16_nms_impls_on_cpu():
    y = torch.from_numpy(fake_preds(2))
    for fn, kw in ((port_decode.decode_detections_debug, dict(n_classes=3)),
                   (port_decode.decode_detections_fast, {})):
        assert torch.equal(fn(y, nms_impl="auto", **kw), fn(y, nms_impl="reference", **kw))
        with pytest.raises(ValueError, match="CUDA"):
            fn(y, nms_impl="kernel", **kw)
    _, boxes = port_decode.decode_raw_predictions(y[0], img_height=300, img_width=300)
    with pytest.raises(ValueError, match="nms_impl"):
        port_decode.nms_per_class(boxes, y[0, :, 1], nms_impl="xla")
