"""Batched greedy-NMS keep mask: the CUDA kernel, its plain PyTorch version
and the launch counter.

Counterpart of the JAX package's `ops/pallas_nms.py::pallas_batched_nms_mask`.
`batched_nms_mask` launches `csrc/batched_nms.cu` on a CUDA tensor and runs
`batched_nms_mask_reference` on a CPU tensor; there is no fallback from the
one to the other.  The JAX `chunk` argument was a TPU tiling detail and has
no counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_detection_resnet_ssd_torch.ops import _build

# Kernel launches since the last reset; only `batched_nms_mask` adds to it,
# and only where it launches the kernel.
LAUNCHES = 0

_MAX_SMEM_BYTES = 48 * 1024  # static launch limit, no opt-in attribute needed


def batched_nms_mask_reference(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.45,
    border_delta: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch greedy NMS over N stacked problems.

    The JAX package's `boxes/decode.py::_greedy_nms_mask` batched over N,
    with the TPU kernel's IoU formula `inter / max(union, 1e-12)` in the
    kernel's operation order (so the CUDA kernel can match it bit for bit).

    Args:
      boxes: (N, K, 4) float32 corners, each problem sorted by descending
        score.
      scores: (N, K) float32; 0 marks an empty slot.

    Returns:
      keep: (N, K) bool.
    """
    n, k = scores.shape
    d = float(border_delta)
    x0, y0, x1, y1 = boxes.unbind(-1)  # (N, K) each
    area = (x1 - x0 + d) * (y1 - y0 + d)
    keep = torch.ones((n, k), dtype=torch.bool, device=scores.device)
    later = torch.arange(k, device=scores.device)
    for i in range(k):
        alive = keep[:, i : i + 1] & (scores[:, i : i + 1] > 0.0)  # (N, 1)
        iw = torch.clamp_min(
            torch.minimum(x1, x1[:, i : i + 1]) - torch.maximum(x0, x0[:, i : i + 1]) + d,
            0.0,
        )
        ih = torch.clamp_min(
            torch.minimum(y1, y1[:, i : i + 1]) - torch.maximum(y0, y0[:, i : i + 1]) + d,
            0.0,
        )
        inter = iw * ih
        union = area + area[:, i : i + 1] - inter
        iou = inter / torch.clamp_min(union, 1e-12)
        keep &= ~(alive & (iou > iou_threshold) & (later > i))
    return keep & (scores > 0.0)


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> tuple[int, int]:
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(
            f"batched_nms_mask takes float32, got {boxes.dtype} and {scores.dtype}"
        )
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (N, K, 4), got {tuple(boxes.shape)}")
    n, k = boxes.shape[0], boxes.shape[1]
    if tuple(scores.shape) != (n, k):
        raise ValueError(f"scores must be ({n}, {k}), got {tuple(scores.shape)}")
    return n, k


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float = 0.45,
    border_delta: float = 0.0,
) -> torch.Tensor:
    """Greedy-NMS keep mask (N, K) bool for stacked problems.

    On a CUDA tensor this launches the hand-written kernel (one block per
    problem) on the current stream; on a CPU tensor it runs
    `batched_nms_mask_reference`.  Inputs must be float32 and contiguous.
    """
    n, k = _check(boxes, scores)
    if boxes.device.type == "cpu":
        return batched_nms_mask_reference(boxes, scores, iou_threshold, border_delta)
    if boxes.device.type != "cuda":
        raise ValueError(f"batched_nms_mask runs on cuda or cpu, got {boxes.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("batched_nms_mask needs contiguous boxes and scores")
    lib = _library()
    if lib.batched_nms_mask_smem_bytes(k) > _MAX_SMEM_BYTES:
        raise ValueError(f"K={k} candidates do not fit one block's shared memory")
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.batched_nms_mask(
            boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
            n, k, float(iou_threshold), float(border_delta), stream,
        )
    if err != 0:
        raise RuntimeError(f"batched_nms_mask kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return keep


def _library() -> ctypes.CDLL:
    lib = _build.load("batched_nms")
    # Pointers and the stream as c_void_p: left undeclared, ctypes would pass
    # them as 32-bit ints and cut them.
    lib.batched_nms_mask.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.batched_nms_mask.restype = ctypes.c_int
    lib.batched_nms_mask_smem_bytes.argtypes = [ctypes.c_int]
    lib.batched_nms_mask_smem_bytes.restype = ctypes.c_int
    return lib
