"""Kernel B3's plain version and wrapper on the CPU: the coefficient-space
horizontal flip against the JAX package's `_flip_h_jnp` and its Pallas
kernel (interpret mode).  The negation is exact, so every comparison is bit
for bit (the values' int32/int16 patterns)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_detection_resnet_ssd_tpu.ops.dct_augment as jax_aug
from jpeg_detection_resnet_ssd_torch.ops import _build, dct_flip

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32, np.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, np.int16)}


def _bits(x, view):
    return np.asarray(x).view(view)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(4, 5, 64), (2, 5, 7, 128), (2, 3, 4, 3, 192), (1, 1, 1, 64)])
def test_reference_equals_jax_bit_for_bit(dtype, shape):
    np_dtype, torch_dtype, view = DTYPES[dtype]
    x = np.random.default_rng(len(shape)).normal(0, 50, shape).astype(np.float32)
    x[..., 0, 0, :3] = [0.0, -0.0, 0.0]  # exact zeros flip sign like the multiply
    ref = jax_aug._flip_h_jnp(jnp.asarray(x, np_dtype))
    got = dct_flip.dct_flip_horizontal(torch.from_numpy(x).to(torch_dtype))
    assert got.dtype == torch_dtype and tuple(got.shape) == shape
    got_np = got.view(torch.int32 if view is np.int32 else torch.int16).numpy()
    np.testing.assert_array_equal(got_np, _bits(ref, view))


def test_reference_equals_pallas_kernel_at_64_channels(monkeypatch):
    """The TPU kernel in interpret mode, patched as `tests/test_ops.py` does;
    it takes 64 channels only (it broadcasts 64 signs to (1, C))."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interpreted(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    x = np.random.default_rng(3).normal(0, 50, (2, 5, 7, 64)).astype(np.float32)
    ref = jax_aug.dct_flip_horizontal(jnp.asarray(x), use_pallas=True)
    got = dct_flip.dct_flip_horizontal(torch.from_numpy(x))
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), _bits(ref, np.int32))


def test_double_flip_is_identity():
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 50, (3, 6, 128)).astype(np.float32))
    assert torch.equal(dct_flip.dct_flip_horizontal(dct_flip.dct_flip_horizontal(x)), x)


@pytest.mark.parametrize("impl", ["auto", "kernel", "reference"])
def test_rejects_channels_not_a_multiple_of_64(impl):
    with pytest.raises(ValueError, match="multiple of 64"):
        dct_flip.dct_flip_horizontal(torch.zeros(2, 3, 4, 96), impl=impl)


def test_cpu_runs_the_plain_version_and_counts_nothing(monkeypatch):
    def fail(name):
        raise AssertionError(f"tried to load {name}")

    monkeypatch.setattr(_build, "load", fail)
    monkeypatch.setattr(dct_flip, "LAUNCHES", 0)
    x = torch.randn(2, 3, 4, 64)
    for impl in ("auto", "reference"):
        assert torch.equal(dct_flip.dct_flip_horizontal(x, impl=impl),
                           dct_flip.dct_flip_horizontal_reference(x))
    assert dct_flip.LAUNCHES == 0


def test_kernel_impl_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="runs on cuda"):
        dct_flip.dct_flip_horizontal(torch.zeros(2, 3, 4, 64), impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        dct_flip.dct_flip_horizontal(torch.zeros(2, 3, 4, 64), impl="pallas")
