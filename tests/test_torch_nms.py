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


def _pair_bits(boxes, scores, thr, delta):
    """(N, K, K) bool, IoU(i, j) > thr for j > i, decided as `nms_bitmask_kernel`
    decides in a tile of plain boxes: without a division, by the sign of
    inter - m * union against the midpoint m between thr and the next float
    up (exact in float64; no quotient of floats lies on m).  inter comes from (w + |w|) * (h + |h|) / 4, as the kernel scales it.
    Also returns the quotient's own decision."""
    b = torch.from_numpy(boxes)
    x0, y0, x1, y1 = (t.unsqueeze(1) for t in b.unbind(-1))  # j along the last axis
    xi0, yi0, xi1, yi1 = (t.transpose(1, 2) for t in (x0, y0, x1, y1))
    area = (x1 - x0 + delta) * (y1 - y0 + delta)
    w = torch.minimum(x1, xi1) - torch.maximum(x0, xi0) + delta
    h = torch.minimum(y1, yi1) - torch.maximum(y0, yi0) + delta
    inter = torch.clamp_min(w, 0.0) * torch.clamp_min(h, 0.0)
    inter4 = (w + w.abs()) * (h + h.abs())
    assert torch.equal(inter4, 4 * inter)  # the scaling is exact here
    union = torch.clamp_min((area + area.transpose(1, 2)) - inter, 1e-12)
    t32 = np.float32(thr)
    t_next = np.nextafter(t32, np.float32(np.inf))
    mid = float(t32) + (float(t_next) - float(t32)) / 2
    above = inter.double() - mid * union.double() > 0
    exact = inter / union > float(t32)
    k = scores.shape[1]
    later = torch.arange(k)[None, :] > torch.arange(k)[:, None]
    return above & later, exact & later


def _two_phase(boxes, scores, thr, delta, rng):
    """The card's algorithm on the CPU: the (N, K, W) word bitmask (words
    below the diagonal and of skipped tiles hold garbage, as the kernel
    leaves them unwritten), then the scan over 64-candidate blocks."""
    n, k = scores.shape
    words = -(-k // 64)
    bits, _ = _pair_bits(boxes, scores, thr, delta)
    padded = np.zeros((n, k, words * 64), bool)
    padded[..., :k] = bits.numpy()
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    mask = (padded.reshape(n, k, words, 64) * weights).sum(-1, dtype=np.uint64)
    live = np.zeros((n, words * 64), bool)
    live[:, :k] = scores > 0
    live = live.reshape(n, words, 64).any(-1)  # (N, W): a block with a score > 0
    for p in range(n):
        for i in range(k):
            for w in range(words):
                if w < i // 64 or not (live[p, i // 64] and live[p, w]):
                    mask[p, i, w] = rng.integers(0, 2**63, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    keep = np.zeros((n, k), bool)
    removed = np.zeros((n, words), np.uint64)
    one = np.uint64(1)
    for w in range(words):
        rows = np.arange(64 * w, min(64 * w + 64, k))
        valid = np.zeros(n, np.uint64)
        for b, i in enumerate(rows):
            valid |= (scores[:, i] > 0).astype(np.uint64) << np.uint64(b)
        cur, kept = removed[:, w].copy(), np.zeros(n, np.uint64)
        for b, i in enumerate(rows):
            hit = ((valid & ~cur) >> np.uint64(b)) & one
            kept |= hit << np.uint64(b)
            cur |= np.where(hit == one, mask[:, i, w], np.uint64(0))
        for b, i in enumerate(rows):
            hit = ((kept >> np.uint64(b)) & one) == one
            removed[:, w + 1:] |= np.where(hit[:, None], mask[:, i, w + 1:], np.uint64(0))
            keep[:, i] = hit
    return keep


@pytest.mark.parametrize("border", sorted(BORDERS))
@pytest.mark.parametrize("n,k", [(6, 24), (3, 37), (4, 32), (3, 100), (2, 150)])
def test_two_phase_design_equals_reference_and_pallas(border, n, k, rng):
    boxes, scores = nms_problems(rng, n, k)
    delta = BORDERS[border]
    got = _two_phase(boxes, scores, 0.45, delta, rng)
    np.testing.assert_array_equal(got, _port(boxes, scores, 0.45, delta))
    if k < 64:
        ref = np.asarray(pallas_batched_nms_mask(
            jnp.asarray(boxes), jnp.asarray(scores), 0.45, border_delta=delta, interpret=True))
        np.testing.assert_array_equal(got, ref)
    midpoint, exact = _pair_bits(boxes, scores, 0.45, delta)
    assert torch.equal(midpoint, exact)  # the division-free decision gives the same bits


def test_midpoint_decision_at_the_threshold():
    """Quotients on f32(0.45), the next float up, and one ulp beyond each."""
    t = np.float32(0.45)
    nxt = np.nextafter(t, np.float32(1))
    union = np.float32(2.0) ** 20  # exact products: inter = q * 2^20 for 24-bit q
    boxes, qs = [], [t, nxt, np.nextafter(t, np.float32(0)), np.nextafter(nxt, np.float32(1))]
    for q in qs:  # a box of area `union` and one inside it of area q * union
        boxes.append([[0, 0, 1024, 1024], [0, 0, 1024, float(np.float32(q) * 1024)]])
    boxes = np.asarray(boxes, np.float32)
    scores = np.ones(boxes.shape[:2], np.float32)
    midpoint, exact = _pair_bits(boxes, scores, float(t), 0.0)
    assert torch.equal(midpoint, exact)
    assert exact[:, 0, 1].tolist() == [False, True, False, True]
    np.testing.assert_array_equal(_port(boxes, scores, float(t), 0.0)[:, 1], [True, False, True, False])


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
