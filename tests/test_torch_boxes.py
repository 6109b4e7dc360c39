"""Port parity: anchors and box geometry, JAX package vs PyTorch port (CPU)."""

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.boxes import anchors as jax_anchors
from jpeg_detection_resnet_ssd_tpu.boxes import geometry as jax_geometry
from jpeg_detection_resnet_ssd_tpu.models.ssd import ssd_predictor_sizes as jax_sizes
from jpeg_detection_resnet_ssd_torch.boxes import anchors as port_anchors
from jpeg_detection_resnet_ssd_torch.boxes import geometry as port_geometry
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes

torch.set_num_threads(1)

BORDERS = ("half", "include", "exclude")


def _corner_boxes(rng, n):
    xy = rng.uniform(0, 250, (n, 2))
    wh = rng.uniform(1, 80, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("family", ["resnet_custom", "resnet_identical"])
def test_anchors_bit_equal(family):
    assert ssd_predictor_sizes(family) == jax_sizes(family)
    sizes = ssd_predictor_sizes(family)
    ref = jax_anchors.build_anchors(jax_anchors.AnchorSpec(), sizes)
    got = port_anchors.build_anchors(port_anchors.AnchorSpec(), sizes)
    if family == "resnet_custom":
        assert got.shape == (8732, 8)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("coords", ["corners", "centroids", "minmax"])
def test_anchors_bit_equal_other_specs(coords):
    """Clipping, explicit offsets, no steps and other coords formats."""
    kw = dict(img_height=300, img_width=400, steps=None, offsets=(0.3,) * 6,
              clip_boxes=True, two_boxes_for_ar1=False)
    sizes = ssd_predictor_sizes("resnet_custom")
    ref = jax_anchors.build_anchors(jax_anchors.AnchorSpec(**kw), sizes, coords=coords)
    got = port_anchors.build_anchors(port_anchors.AnchorSpec(**kw), sizes, coords=coords)
    np.testing.assert_array_equal(got, ref)
    assert port_anchors.AnchorSpec(**kw).boxes_per_cell() == jax_anchors.AnchorSpec(**kw).boxes_per_cell()


@pytest.mark.parametrize("border", BORDERS)
def test_conversions_match_jax(border, rng):
    corners = _corner_boxes(rng, 64)
    cent = np.array(jax_geometry.corners_to_centroids(corners, border))
    np.testing.assert_allclose(
        port_geometry.corners_to_centroids(corners, border).numpy(), cent, rtol=1e-6
    )
    np.testing.assert_allclose(
        port_geometry.centroids_to_corners(cent).numpy(),
        np.array(jax_geometry.centroids_to_corners(cent)), rtol=1e-6,
    )
    mm = np.array(jax_geometry.corners_to_minmax(corners))
    np.testing.assert_array_equal(port_geometry.corners_to_minmax(corners).numpy(), mm)
    np.testing.assert_array_equal(
        port_geometry.minmax_to_corners(mm).numpy(), np.array(jax_geometry.minmax_to_corners(mm))
    )
    np.testing.assert_allclose(
        port_geometry.minmax_to_centroids(mm, border).numpy(),
        np.array(jax_geometry.minmax_to_centroids(mm, border)), rtol=1e-6,
    )
    np.testing.assert_allclose(
        port_geometry.centroids_to_minmax(cent).numpy(),
        np.array(jax_geometry.centroids_to_minmax(cent)), rtol=1e-6,
    )
    for src in ("corners", "centroids", "minmax"):
        for dst in ("corners", "centroids", "minmax"):
            x = {"corners": corners, "centroids": cent, "minmax": mm}[src]
            np.testing.assert_allclose(
                port_geometry.convert(x, src, dst, border).numpy(),
                np.array(jax_geometry.convert(x, src, dst, border)), rtol=1e-6,
            )


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("coords", ["corners", "centroids"])
def test_area_and_iou_match_jax(border, coords, rng):
    a = _corner_boxes(rng, 200)
    b = _corner_boxes(rng, 200)
    b[:50] = a[:50]  # identical pairs: IoU 1
    b[50:60] = a[50:60] + 500.0  # disjoint pairs: IoU 0
    if coords == "centroids":
        a = np.array(jax_geometry.corners_to_centroids(a))
        b = np.array(jax_geometry.corners_to_centroids(b))
    np.testing.assert_allclose(
        port_geometry.box_area(a, border).numpy(),
        np.array(jax_geometry.box_area(a, border)), rtol=1e-6,
    )
    ref = np.array(jax_geometry.iou_elementwise(a, b, coords, border))
    got = port_geometry.iou_elementwise(torch.from_numpy(a), torch.from_numpy(b), coords, border)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6)
    # broadcasting one box against many, as the NMS row does
    ref_row = np.array(jax_geometry.iou_elementwise(a[0], a, coords, border))
    got_row = port_geometry.iou_elementwise(a[0], a, coords, border).numpy()
    np.testing.assert_allclose(got_row, ref_row, rtol=1e-6)


def test_unknown_border_raises():
    with pytest.raises(ValueError, match="border_pixels"):
        port_geometry.box_area(np.zeros((1, 4), np.float32), "outer")
