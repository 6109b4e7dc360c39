"""Weight-tensor surgery for transplanting heads across class counts.

A copy of the JAX package's `compat/surgery.py` (NumPy in, NumPy out), so
the port imports nothing of that package.  Role of
`localisation_part/misc_utils/tensor_sampling_utils.py:21` (`sample_tensors`):
sub-/up-sample weight tensors along chosen axes so a head trained for one
class count can seed another.
"""

from __future__ import annotations

import numpy as np


def sample_tensors(
    weights_list,
    sampling_instructions,
    axes=None,
    init=None,
    mean: float = 0.0,
    stddev: float = 0.005,
    rng: np.random.Generator | None = None,
):
    """Sample each tensor in `weights_list` to the sizes in
    `sampling_instructions`.

    For each axis: if the target size is smaller, pick that many indices
    (randomly without replacement, or the listed indices if the instruction is
    a list); if larger, keep all original slices and fill the rest with
    N(mean, stddev) noise (upsampling).

    Returns (sampled_weights, sampling_indices) — the indices used per axis of
    the first tensor, so dependent tensors (e.g. the bias of a conv whose
    output channels were sampled) can reuse them.
    """
    rng = rng or np.random.default_rng(0)
    first = np.asarray(weights_list[0])
    if len(sampling_instructions) != first.ndim:
        raise ValueError("need one sampling instruction per axis")
    if axes is None:
        axes = list(range(first.ndim))

    out_tensors = []
    chosen_per_axis: list = [None] * first.ndim
    for w in weights_list:
        w = np.asarray(w)
        for axis in range(w.ndim):
            instr = sampling_instructions[axis]
            if axis not in axes and not isinstance(instr, (list, np.ndarray)):
                continue
            cur = w.shape[axis]
            if isinstance(instr, (list, np.ndarray)):
                idx = np.asarray(instr, np.int64)
            else:
                target = int(instr)
                if target == cur:
                    continue
                if chosen_per_axis[axis] is not None:
                    idx = chosen_per_axis[axis]
                elif target < cur:
                    # Always keep index 0 — the background class — and
                    # sample the rest, as the reference does
                    # (`tensor_sampling_utils.py:118-122`): a class-head
                    # transplant must never drop the background column.
                    rest = np.sort(
                        rng.choice(np.arange(1, cur), target - 1,
                                   replace=False)
                    )
                    idx = np.concatenate([np.zeros(1, np.int64), rest])
                else:
                    idx = None  # upsample
                if idx is None:
                    pad_shape = list(w.shape)
                    pad_shape[axis] = target - cur
                    noise = rng.normal(mean, stddev, pad_shape)
                    w = np.concatenate([w, noise.astype(w.dtype)], axis=axis)
                    continue
            chosen_per_axis[axis] = idx
            w = np.take(w, idx, axis=axis)
        out_tensors.append(w)
    return out_tensors, chosen_per_axis
