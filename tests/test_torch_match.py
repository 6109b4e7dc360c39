"""Port parity for IoU and GT -> anchor matching (CPU).

The matched indices must be exactly the JAX package's: the port's plain
bipartite matching against `bipartite_match_xla` and against the Pallas
kernel in interpret mode, on the same NumPy similarities.  IoU in float32
at rtol 1e-6 (the same operations; the backends may round a division
differently in the last place).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.boxes import geometry as jax_geometry
from jpeg_detection_resnet_ssd_tpu.boxes import matching as jax_matching
from jpeg_detection_resnet_ssd_tpu.ops.pallas_match import (
    bipartite_match_xla,
    pallas_bipartite_match,
)
from jpeg_detection_resnet_ssd_torch.boxes import geometry, matching
from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm

from torch_cases import BORDERS, gt_batch, tie_sims

torch.set_num_threads(1)

ANCHORS = build_anchors(AnchorSpec(), ssd_predictor_sizes("resnet_custom"), coords="centroids")


def iou_sims(n_valid, seed=0, border="half"):
    """(B, 64, 8732) IoUs of seeded GT with the SSD300 anchors, invalid rows
    masked to -1, as the target encoder builds them."""
    gt, mask = gt_batch(np.random.default_rng(seed), n_valid)
    cent = geometry.corners_to_centroids(torch.from_numpy(gt[..., 1:]) / 300.0, border)
    sims = geometry.iou_matrix(cent, torch.from_numpy(ANCHORS[:, :4]), "centroids", border)
    return torch.where(torch.from_numpy(mask)[..., None], sims, -1.0).numpy()


def jax_xla(sims):
    return np.asarray(jax.vmap(bipartite_match_xla)(jnp.asarray(sims)))


def jax_pallas(sims):
    fn = jax.vmap(functools.partial(pallas_bipartite_match, interpret=True))
    return np.asarray(fn(jnp.asarray(sims)))


CASES = {
    "iou_b3_few_valid": lambda: iou_sims([1, 4, 10], seed=0),
    "iou_b3_all_and_none_valid": lambda: iou_sims([64, 0, 3], seed=1),
    "ties_b5_300": lambda: tie_sims(np.random.default_rng(2), (5, 64, 300)),
}


@pytest.fixture(scope="module")
def case_results():
    out = {}
    for name, make in CASES.items():
        sims = np.ascontiguousarray(make(), dtype=np.float32)
        got = bm.bipartite_match(torch.from_numpy(sims), impl="reference").numpy()
        out[name] = (sims, got)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_jax_xla_loop(case_results, case):
    sims, got = case_results[case]
    assert got.dtype == np.int32 and got.shape == sims.shape[:2]
    np.testing.assert_array_equal(got, jax_xla(sims))


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_pallas_kernel_interpret(case_results, case):
    sims, got = case_results[case]
    np.testing.assert_array_equal(got, jax_pallas(sims))


def test_matching_covers_valid_rows_only(case_results):
    sims, got = case_results["iou_b3_all_and_none_valid"]
    valid = sims.max(-1) >= 0
    assert ((got >= 0) == valid).all()
    assert valid[0].all() and not valid[1].any()
    for row in got:
        hit = row[row >= 0]
        assert len(set(hit.tolist())) == len(hit)  # each anchor at most once


def test_duplicate_gt_rows_take_distinct_anchors(case_results):
    sims, got = case_results["iou_b3_few_valid"]
    b = 1  # 4 valid rows, row 1 repeats row 0
    np.testing.assert_array_equal(sims[b, 0], sims[b, 1])
    assert got[b, 0] == sims[b, 0].argmax() and got[b, 1] != got[b, 0]


def test_impl_dispatch_on_the_cpu():
    sims = torch.from_numpy(tie_sims(np.random.default_rng(3), (2, 8, 16)))
    np.testing.assert_array_equal(
        bm.bipartite_match(sims, impl="auto").numpy(), bm.bipartite_match_reference(sims).numpy()
    )
    with pytest.raises(ValueError, match="runs on cuda"):
        bm.bipartite_match(sims, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        bm.bipartite_match(sims, impl="xla")
    with pytest.raises(TypeError):
        bm.bipartite_match(sims.double())


@pytest.mark.parametrize("border", sorted(BORDERS))
def test_iou_matrix_matches_jax(border):
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.uniform(0, 200, (3, 5, 2)), rng.uniform(1, 100, (3, 5, 2))], -1)
    b = np.concatenate([rng.uniform(0, 200, (40, 2)), rng.uniform(1, 100, (40, 2))], -1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    b[0] = a[0, 0]  # identical boxes: IoU 1
    b[1] = [500, 500, 1, 1]  # disjoint: IoU 0
    for coords in ("centroids", "corners"):
        ref = np.asarray(jax_geometry.iou_matrix(a, b, coords=coords, border_pixels=border))
        got = geometry.iou_matrix(torch.from_numpy(a), torch.from_numpy(b), coords, border).numpy()
        assert got.shape == ref.shape == (3, 5, 40)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        inter = geometry.intersection_area_matrix(a, b, coords, border).numpy()
        np.testing.assert_allclose(
            inter, np.asarray(jax_geometry.intersection_area_matrix(a, b, coords, border)),
            rtol=1e-6, atol=1e-6,
        )


def test_greedy_and_multi_matching_match_jax():
    rng = np.random.default_rng(5)
    sims = tie_sims(rng, (3, 12, 40))
    mask = rng.random((3, 12)) < 0.7
    got_m, got_v = matching.match_bipartite_greedy(torch.from_numpy(sims), torch.from_numpy(mask))
    got_g, got_hit = matching.match_multi(torch.from_numpy(sims), torch.from_numpy(mask), 0.5)
    for i in range(3):
        ref_m, _ = jax_matching.match_bipartite_greedy(jnp.asarray(sims[i]), jnp.asarray(mask[i]))
        np.testing.assert_array_equal(got_m[i].numpy(), np.asarray(ref_m))
        ref_g, ref_hit = jax_matching.match_multi(jnp.asarray(sims[i]), jnp.asarray(mask[i]), 0.5)
        np.testing.assert_array_equal(got_g[i].numpy(), np.asarray(ref_g))
        np.testing.assert_array_equal(got_hit[i].numpy(), np.asarray(ref_hit))
    np.testing.assert_array_equal(got_v.numpy(), mask)
