"""Port parity: batched greedy-NMS keep masks, JAX package vs PyTorch port
(CPU).  The CUDA kernel against this plain version is in `test_torch_cuda.py`.

Masks must be EXACTLY equal: the port's plain version runs the TPU kernel's
IoU formula in its operation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.boxes.decode import _greedy_nms_mask
from jpeg_detection_resnet_ssd_tpu.ops.pallas_nms import pallas_batched_nms_mask
from jpeg_detection_resnet_ssd_torch.ops import batched_nms

from torch_cases import BORDERS, nms_problems

torch.set_num_threads(1)

def _port(boxes, scores, thr, delta):
    keep = batched_nms.batched_nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), thr, delta
    )
    assert keep.dtype == torch.bool and keep.shape == scores.shape
    return keep.numpy()


@pytest.mark.parametrize("border", sorted(BORDERS))
@pytest.mark.parametrize("n,k,chunk", [(6, 24, 0), (3, 37, 0), (4, 32, 16)])
def test_reference_matches_pallas_interpret(border, n, k, chunk, rng):
    boxes, scores = nms_problems(rng, n, k)
    ref = np.asarray(pallas_batched_nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), 0.45,
        border_delta=BORDERS[border], interpret=True, chunk=chunk,
    ))
    got = _port(boxes, scores, 0.45, BORDERS[border])
    np.testing.assert_array_equal(got, ref)
    assert (got < (scores > 0)).any(), "no candidate was suppressed"


@pytest.mark.parametrize("border", sorted(BORDERS))
def test_reference_matches_greedy_nms_mask(border, rng):
    boxes, scores = nms_problems(rng, 5, 40)
    ref = np.asarray(jax.vmap(
        lambda b, s: _greedy_nms_mask(b, s, 0.45, border)
    )(jnp.asarray(boxes), jnp.asarray(scores)))
    np.testing.assert_array_equal(_port(boxes, scores, 0.45, BORDERS[border]), ref)


def test_threshold_is_strict():
    rng = np.random.default_rng(3)
    boxes, scores = nms_problems(rng, 2, 16)
    keep = _port(boxes, scores, 0.45, 0.0)
    assert keep[:, 1].all()  # IoU == f32(0.45) does not suppress
    assert not keep[:, 3].any()  # IoU one ulp above does
    assert not keep[:, -(16 // 5 + 1):].any()  # zero scores never survive


def test_zero_score_candidates_do_not_suppress():
    boxes = np.tile(np.array([[0, 0, 10, 10]], np.float32), (4, 1))[None]
    scores = np.array([[0.0, 0.9, 0.8, 0.0]], np.float32)
    keep = _port(boxes, scores, 0.45, 0.0)
    np.testing.assert_array_equal(keep, [[False, True, False, False]])


def test_wrapper_rejects_bad_inputs():
    boxes = torch.zeros(2, 3, 4)
    with pytest.raises(TypeError):
        batched_nms.batched_nms_mask(boxes.double(), torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        batched_nms.batched_nms_mask(boxes, torch.zeros(2, 4))
    with pytest.raises(ValueError):
        batched_nms.batched_nms_mask(torch.zeros(2, 3, 5), torch.zeros(2, 3))


def test_cpu_path_does_not_count_launches():
    before = batched_nms.LAUNCHES
    boxes, scores = nms_problems(np.random.default_rng(1), 2, 8)
    _port(boxes, scores, 0.45, 0.0)
    assert batched_nms.LAUNCHES == before
