"""The port's DCT-domain crop + resize against the JAX package's, on the CPU.

The JAX functions run compiled (`jax.jit`), as the JAX train step runs
them: XLA contracts the sample coordinate start + (o + 0.5) * step into a
fused multiply-add, which moves samples by an ulp of ~10^2 px against the
op-by-op evaluation, and the port computes it with that one rounding.

`interp_matrix` for all five interpolation modes, with and without clamp,
for crops inside the source, straddling its edge and beyond it: W and the
residual within 1e-6 absolute (float32 weights; the lanczos normalisation
and the residual's row sum are summed in another order).  The port builds
one (B, dst, src) matrix per batch of crops; every crop is checked against
the JAX function of that crop.  `dct_crop_resize` with a scalar and a
per-group background: within 1e-5 of the largest JAX value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_detection_resnet_ssd_tpu.ops.dct_resize as J
from jpeg_detection_resnet_ssd_torch.ops import dct_resize as P

torch.set_num_threads(1)

jax_interp_matrix = jax.jit(J.interp_matrix, static_argnums=(0, 1), static_argnames=("nearest",))
jax_crop_resize = jax.jit(J.dct_crop_resize, static_argnums=(5, 6))

# (start, length) in source pixels of a 96-pixel source, resampled to 64
CROPS = {
    "inside_down": (3.3, 80.7),
    "inside_up": (10.25, 40.5),
    "full": (0.0, 96.0),
    "straddles": (-10.2, 90.5),
    "beyond": (-150.0, 384.0),
}


@pytest.mark.parametrize("mode", range(P.N_INTERP_MODES))
@pytest.mark.parametrize("clamp", [False, True])
def test_interp_matrix_per_crop(mode, clamp):
    starts = np.array([c[0] for c in CROPS.values()], np.float32)
    lengths = np.array([c[1] for c in CROPS.values()], np.float32)
    W, res = P.interp_matrix(96, 64, torch.from_numpy(starts), torch.from_numpy(lengths),
                             clamp=clamp, mode=mode)
    assert W.shape == (len(CROPS), 64, 96) and res.shape == (len(CROPS), 64)
    for i, (start, length) in enumerate(CROPS.values()):
        ref_w, ref_r = jax_interp_matrix(96, 64, start, length, clamp=clamp, mode=mode)
        np.testing.assert_allclose(W[i].numpy(), np.asarray(ref_w), rtol=0, atol=1e-6)
        np.testing.assert_allclose(res[i].numpy(), np.asarray(ref_r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("nearest", [False, True])
def test_interp_matrix_mode_matches_jax_nearest_flag(nearest):
    """The JAX function's `nearest` bool is the port's INTERP_NEAREST mode."""
    mode = P.INTERP_NEAREST if nearest else P.INTERP_BILINEAR
    W, res = P.interp_matrix(96, 64, 5.5, 70.0, mode)
    ref_w, ref_r = jax_interp_matrix(96, 64, 5.5, 70.0, nearest=nearest)
    np.testing.assert_allclose(W.numpy(), np.asarray(ref_w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.numpy(), np.asarray(ref_r), rtol=0, atol=1e-6)


def test_interp_matrix_mixed_modes_in_one_batch():
    modes = np.arange(5)
    W, _ = P.interp_matrix(96, 64, torch.full((5,), 4.0), torch.full((5,), 70.0),
                           clamp=torch.tensor([True, False, True, False, True]),
                           mode=torch.from_numpy(modes))
    for i in range(5):
        ref, _ = jax_interp_matrix(96, 64, 4.0, 70.0, clamp=bool(i % 2 == 0), mode=i)
        np.testing.assert_allclose(W[i].numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("background", ["scalar", "per_group"])
def test_crop_resize_batched(background):
    rng = np.random.default_rng(11)
    x = rng.normal(0, 60, (5, 12, 10, 128)).astype(np.float32)
    y0 = np.array([-5.3, 0.0, 10.5, -40.0, 2.0], np.float32)
    x0 = np.array([7.1, 0.0, -3.0, -30.0, 1.5], np.float32)
    ch = np.array([80.2, 96.0, 60.0, 200.0, 50.0], np.float32)
    cw = np.array([60.7, 80.0, 90.0, 170.0, 40.0], np.float32)
    modes = np.array([0, 1, 2, 3, 4])
    bg = 3.0 if background == "scalar" else (-4.5, 2.25)
    got = P.dct_crop_resize(torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(x0),
                            torch.from_numpy(ch), torch.from_numpy(cw), 64, 48,
                            background=bg, interp_mode=torch.from_numpy(modes))
    assert got.shape == (5, 8, 6, 128)
    for i in range(5):
        ref = np.asarray(jax_crop_resize(
            jnp.asarray(x[i]), y0[i], x0[i], ch[i], cw[i], 64, 48,
            background=jnp.asarray(bg, jnp.float32), interp_mode=int(modes[i])))
        err = np.abs(got[i].numpy() - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (i, err)


def test_resample_identity():
    """The identity resample returns the blocks (a pixel-exact no-op)."""
    x = np.random.default_rng(12).normal(0, 60, (2, 4, 5, 64)).astype(np.float32)
    got = P.dct_resample(torch.from_numpy(x), torch.eye(32).expand(2, 32, 32),
                         torch.eye(40).expand(2, 40, 40))
    np.testing.assert_allclose(got.numpy(), x, rtol=0, atol=1e-5 * np.abs(x).max())
