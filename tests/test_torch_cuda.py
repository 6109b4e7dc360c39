"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (a kernel has no CPU mode) and
skip without a card.  They import no jax, so they run on a machine without
it; there, skip this directory's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_torch.boxes import decode, geometry
from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
from jpeg_detection_resnet_ssd_torch.ops import _draws, batched_nms, bipartite_match, conv_grad, dct_flip
from jpeg_detection_resnet_ssd_torch.ops.dct_detect_augment import make_dct_detection_augment_v3

from torch_cases import (
    BORDERS, N_CLASSES, assert_augment_matches, augment_source, gt_batch, nms_problems,
    raw_predictions, tie_sims,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k", [(640, 400), (7, 37), (3, 1)])
@pytest.mark.parametrize("border", sorted(BORDERS))
def test_kernel_mask_equals_reference(cuda, n, k, border):
    boxes, scores = nms_problems(np.random.default_rng(n), n, k)
    b, s = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    before = batched_nms.LAUNCHES
    got = batched_nms.batched_nms_mask(b, s, 0.45, BORDERS[border])
    torch.cuda.synchronize()
    assert batched_nms.LAUNCHES == before + 1
    assert got.dtype == torch.bool and got.device.type == "cuda"
    assert torch.equal(got, batched_nms.batched_nms_mask_reference(b, s, 0.45, BORDERS[border]))


def test_kernel_threshold_is_strict(cuda):
    boxes, scores = nms_problems(np.random.default_rng(3), 4, 16)
    got = batched_nms.batched_nms_mask(
        torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    ).cpu()
    assert got[:, 1].all() and not got[:, 3].any()


def test_kernel_rejects_what_it_does_not_take(cuda):
    b = torch.zeros(4, 8, 4, device=cuda)
    s = torch.ones(4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        batched_nms.batched_nms_mask(b.transpose(0, 1).contiguous().transpose(0, 1), s)
    with pytest.raises(TypeError):
        batched_nms.batched_nms_mask(b.half(), s.half())
    with pytest.raises(ValueError, match="shared memory"):
        batched_nms.batched_nms_mask(torch.zeros(1, 4096, 4, device=cuda), torch.ones(1, 4096, device=cuda))


@pytest.mark.parametrize("selector", ["exact", "shared"])
def test_kernel_decode_equals_reference_decode(cuda, selector):
    y = torch.from_numpy(raw_predictions()).to(cuda)
    kw = dict(n_classes=N_CLASSES, candidate_selector=selector)
    got = decode.decode_detections(y, nms_impl="kernel", **kw)
    ref = decode.decode_detections(y, nms_impl="reference", **kw)
    assert torch.equal(got, ref)


def _iou_sims(n_valid, seed):
    anchors = build_anchors(AnchorSpec(), ssd_predictor_sizes("resnet_custom"), coords="centroids")
    gt, mask = gt_batch(np.random.default_rng(seed), n_valid)
    cent = geometry.corners_to_centroids(torch.from_numpy(gt[..., 1:]) / 300.0)
    sims = geometry.iou_matrix(cent, torch.from_numpy(anchors[:, :4]), "centroids")
    return torch.where(torch.from_numpy(mask)[..., None], sims, -1.0).contiguous()


@pytest.mark.parametrize("make", [
    lambda: _iou_sims([1, 3, 10, 64, 0, 7], seed=0),
    lambda: torch.from_numpy(tie_sims(np.random.default_rng(1), (5, 64, 300))),
    lambda: torch.from_numpy(tie_sims(np.random.default_rng(2), (3, 7, 33))),
])
def test_match_kernel_equals_reference(cuda, make):
    sims = make().to(cuda)
    before = bipartite_match.LAUNCHES
    got = bipartite_match.bipartite_match(sims, impl="kernel")
    torch.cuda.synchronize()
    assert bipartite_match.LAUNCHES == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, bipartite_match.bipartite_match_reference(sims))


@pytest.mark.parametrize("shape", [(2, 38, 38, 128, 128), (4, 5, 5, 512, 512),
                                   (3, 3, 3, 256, 100), (2, 1, 1, 256, 100), (1, 7, 9, 40, 150)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_filter_grad_kernel_matches_reference(cuda, shape, dtype):
    """Both accumulate in float32; only the order of the sums differs."""
    b, h, w, c, k = shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(b, h, w, c, generator=gen).to(cuda, dtype)
    dy = torch.randn(b, h, w, k, generator=gen).to(cuda, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    before = conv_grad.LAUNCHES
    got = conv_grad.conv3x3_filter_grad(x, dy)
    torch.cuda.synchronize()
    assert conv_grad.LAUNCHES == before + 1
    ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
    assert got.shape == (3, 3, c, k) and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("shape", [(32, 38, 38, 64), (32, 19, 19, 128), (7, 3, 5, 9, 192),
                                   (3, 1, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flip_kernel_equals_reference_bit_for_bit(cuda, shape, dtype):
    gen = torch.Generator(device="cpu").manual_seed(len(shape))
    x = (50 * torch.randn(shape, generator=gen)).to(cuda, dtype)
    x.view(-1)[:2] = 0.0  # a zero flips to -0.0 in an odd column, as the multiply gives
    before = dct_flip.LAUNCHES
    got = dct_flip.dct_flip_horizontal(x, impl="kernel")
    torch.cuda.synchronize()
    assert dct_flip.LAUNCHES == before + 1
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), dct_flip.dct_flip_horizontal_reference(x).view(bits))


def test_flip_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 3, 4, 64, device=cuda)
    with pytest.raises(TypeError):
        dct_flip.dct_flip_horizontal(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        dct_flip.dct_flip_horizontal(x.transpose(0, 1))
    with pytest.raises(ValueError, match="aligned"):
        dct_flip.dct_flip_horizontal(torch.zeros(1 + 3 * 4 * 64, device=cuda)[1:].view(3, 4, 64))
    with pytest.raises(ValueError, match="multiple of 64"):
        dct_flip.dct_flip_horizontal(torch.zeros(2, 3, 4, 96, device=cuda))


@pytest.mark.parametrize("photometric,quality", [(True, None), ("pixel_hsv", None), (True, 75)])
def test_chain_on_the_card_equals_the_cpu(cuda, photometric, quality):
    """The v3 chain's apply with one set of host draws, on the card (B3, TF32
    off) and on the CPU (plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = augment_source(4, 12)
    kw = dict(out_y_blocks=8, photometric=photometric, requantize_quality=quality)
    gpu, cpu = make_dct_detection_augment_v3(**kw), make_dct_detection_augment_v3(**kw, device="cpu")
    draws = cpu.sample(4, 12, 12, torch.Generator().manual_seed(0))
    before = dct_flip.LAUNCHES
    got = gpu.apply(gpu.to_device(batch), _draws.to_device(draws, cuda))
    torch.cuda.synchronize()
    assert dct_flip.LAUNCHES == before + 2
    ref = cpu.apply(cpu.to_device(batch), draws)
    assert_augment_matches([t.cpu() for t in (*got["inputs"], got["gt"], got["gt_mask"])],
                           [*ref["inputs"], ref["gt"], ref["gt_mask"]],
                           rtol=1e-4 if photometric == "pixel_hsv" else 1e-5, quality=quality)
