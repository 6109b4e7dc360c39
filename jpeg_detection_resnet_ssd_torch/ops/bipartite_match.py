"""Greedy bipartite GT -> anchor matching: the CUDA kernel, its plain
PyTorch version and the launch counter.

Counterpart of the JAX package's `ops/pallas_match.py`: the plain version is
its `_batched_match_xla` loop, the kernel `csrc/bipartite_match.cu` replaces
its Pallas kernel.  Both take a batch of (M, N) similarity matrices and give
each row its greedily matched column, or -1.  The similarities must be
finite: the order of NaNs is not defined.

`impl` chooses, as `nms_impl` does for the NMS: "auto" launches the kernel
on a CUDA tensor and runs the plain version on a CPU tensor, "kernel" always
launches the kernel (and raises on the CPU), "reference" always runs the
plain version.  (In the JAX package "auto" means its XLA loop; the result
is the same integer indices either way.)

An optional (B, M) bool `row_mask` drops rows: the result is that of the
similarities with every masked row set to -1e30, and the kernel never reads
those rows.  The target encoder passes its GT mask, so the kernel reads only
the rows of real boxes.
"""

from __future__ import annotations

import ctypes

import torch

from jpeg_detection_resnet_ssd_torch.ops import _build

# Kernel launches since the last reset; only `bipartite_match` adds to it,
# and only where it launches the kernel.
LAUNCHES = 0

NEG_BIG = -1e30  # what a consumed entry reads as (the JAX package's _NEG_BIG)

# A block's shared memory, with the opt-in attribute: 16 bytes a row and a
# bit a column, so at N = 8732 anchors M <= 14,459 rows.
_MAX_SMEM_BYTES = 232_448
IMPLS = ("auto", "kernel", "reference")


def bipartite_match_reference(sims: torch.Tensor, row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, M, N) float32 -> (B, M) int32 matched column or -1.

    The JAX package's `_batched_match_xla`, on the similarities with the
    rows where `row_mask` is False set to -1e30: each step takes every
    image's global best (row, column) pair (first row, then first column, on
    ties) and, where it is >= 0, records it and overwrites that row and
    column with -1e30.  It runs as many steps as the largest number of rows
    with a value >= 0 in one image."""
    if row_mask is not None:
        sims = torch.where(row_mask[..., None], sims, NEG_BIG)
    b, m, n = sims.shape
    dev = sims.device
    n_steps = int((sims.amax(dim=2) >= 0.0).sum(dim=1).max()) if b and m and n else 0
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    matched = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    s = sims
    for _ in range(n_steps):
        anchor = s.argmax(dim=2)  # (B, M)
        row_best = s.amax(dim=2)
        g = row_best.argmax(dim=1)  # (B,)
        valid = row_best.amax(dim=1) >= 0.0
        a = anchor.gather(1, g[:, None])[:, 0]
        hit_row = (rows[None, :] == g[:, None]) & valid[:, None]
        matched = torch.where(hit_row, a[:, None].to(torch.int32), matched)
        hit_col = (cols[None, :] == a[:, None]) & valid[:, None]
        s = torch.where(hit_row[:, :, None] | hit_col[:, None, :], NEG_BIG, s)
    return matched


def bipartite_match(
    sims: torch.Tensor, impl: str = "auto", row_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """(B, M, N) float32 similarities -> (B, M) int32 matched column or -1.

    On a CUDA tensor ("auto" or "kernel") this launches the hand-written
    kernel (one block per image) on the current stream.  The similarities
    must be contiguous (a view of any alignment is fine); a non-contiguous
    input raises.  `row_mask` (B, M) bool is copied to a contiguous tensor
    if it is not one."""
    if impl not in IMPLS:
        raise ValueError(f"bipartite impl must be one of {IMPLS}, got {impl!r}")
    if sims.dim() != 3:
        raise ValueError(f"sims must be (B, M, N), got {tuple(sims.shape)}")
    if sims.dtype != torch.float32:
        raise TypeError(f"bipartite_match takes float32, got {sims.dtype}")
    if row_mask is not None:
        if row_mask.dtype != torch.bool or tuple(row_mask.shape) != tuple(sims.shape[:2]):
            raise ValueError(f"row_mask must be {tuple(sims.shape[:2])} bool, got "
                             f"{tuple(row_mask.shape)} {row_mask.dtype}")
        if row_mask.device != sims.device:
            raise ValueError(f"row_mask on {row_mask.device}, sims on {sims.device}")
    if impl == "reference" or (impl == "auto" and sims.device.type == "cpu"):
        return bipartite_match_reference(sims, row_mask)
    if sims.device.type != "cuda":
        raise ValueError(f"the bipartite-matching kernel runs on cuda, got {sims.device}")
    if not sims.is_contiguous():
        raise ValueError("bipartite_match needs contiguous similarities")
    b, m, n = sims.shape
    lib = _library()
    if lib.bipartite_match_smem_bytes(m, n) > _MAX_SMEM_BYTES:
        raise ValueError(f"M={m} rows and N={n} columns need {lib.bipartite_match_smem_bytes(m, n)} "
                         f"bytes of shared memory (16 M + 4 ceil(N / 32)); one block has "
                         f"{_MAX_SMEM_BYTES}")
    mask = None if row_mask is None else row_mask.contiguous()
    out = torch.empty((b, m), dtype=torch.int32, device=sims.device)
    with torch.cuda.device(sims.device):
        stream = torch.cuda.current_stream(sims.device).cuda_stream
        err = lib.bipartite_match(sims.data_ptr(), None if mask is None else mask.data_ptr(),
                                  out.data_ptr(), b, m, n, stream)
    if err != 0:
        raise RuntimeError(f"bipartite_match kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("bipartite_match")
    lib.bipartite_match.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.bipartite_match.restype = ctypes.c_int
    lib.bipartite_match_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bipartite_match_smem_bytes.restype = ctypes.c_int
    return lib
