"""The port's CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU and nvcc (the kernel has no CPU mode) and
skip without a card.  They import no jax, so they run on a machine without
it; there, skip this directory's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_torch.boxes import decode
from jpeg_detection_resnet_ssd_torch.ops import batched_nms

from torch_cases import BORDERS, N_CLASSES, nms_problems, raw_predictions

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NMS kernel has no CPU mode")
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
