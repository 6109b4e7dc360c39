"""The port's pixel-space photometric chain against the JAX package's, on
the CPU: block <-> plane, the colour conversions, the 4:2:0 resample pair
(borders included) and `dct_pixel_photometric_apply` with pinned per-image
parameters, contrast early and late.

Tolerances: conversions and resampling 1e-5 of the largest value; the whole
chain 1e-4 of the largest JAX coefficient (an IDCT, ~10 clipped elementwise
colour maps with a hexagonal HSV walk, and a DCT, in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_detection_resnet_ssd_tpu.ops.pixel_photometric as J
from jpeg_detection_resnet_ssd_torch.ops import pixel_photometric as P

import torch_aug_draws as draws

torch.set_num_threads(1)


def close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"max |diff| {err} vs {rtol} * {np.abs(ref).max()}"


def rgb_image(seed, shape=(2, 16, 24, 3)):
    rgb = np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)
    rgb[0, :2] = [[10.0, 10.0, 10.0]]  # grey: zero chroma, hue undefined
    rgb[0, 2] = [[200.0, 200.0, 40.0]]  # two channels tie for the max
    return rgb


def test_block_plane_round_trip():
    x = np.random.default_rng(0).normal(0, 40, (2, 3, 4, 64)).astype(np.float32)
    plane = P.blocks_to_plane(torch.from_numpy(x))
    close(plane, J.blocks_to_plane(jnp.asarray(x)))
    close(P.plane_to_blocks(plane), J.plane_to_blocks(J.blocks_to_plane(jnp.asarray(x))))


def test_colour_conversions():
    rgb = rgb_image(1)
    close(torch.stack(P.rgb_to_ycbcr(torch.from_numpy(rgb))),
          jnp.stack(J.rgb_to_ycbcr(jnp.asarray(rgb))))
    y, cb, cr = (np.array(p) for p in J.rgb_to_ycbcr(jnp.asarray(rgb)))
    close(P.ycbcr_to_rgb(*(torch.from_numpy(p) for p in (y, cb, cr))),
          J.ycbcr_to_rgb(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    hsv = P.rgb_to_hsv(torch.from_numpy(rgb))
    ref_hsv = J.rgb_to_hsv(jnp.asarray(rgb))
    for got, ref in zip(hsv, ref_hsv):
        close(got, ref)
    close(P.hsv_to_rgb(*hsv), J.hsv_to_rgb(*ref_hsv))


@pytest.mark.parametrize("shape", [(2, 19, 19), (1, 4, 6)])
def test_resample_pair_borders_included(shape):
    plane = np.random.default_rng(2).normal(0, 50, shape).astype(np.float32)
    up = P.upsample2x(torch.from_numpy(plane))
    close(up, J.upsample2x(jnp.asarray(plane)))
    close(P.downsample2x(up), J.downsample2x(J.upsample2x(jnp.asarray(plane))))


@pytest.mark.parametrize("early", [True, False])
def test_apply_with_pinned_parameters(early):
    rng = np.random.default_rng(3)
    y = rng.normal(0, 120, (3, 4, 6, 64)).astype(np.float32)
    cbcr = rng.normal(0, 40, (3, 2, 3, 128)).astype(np.float32)
    params = dict(bright=np.array([20.0, -32.0, 0.0], np.float32),
                  contrast=np.array([1.4, 0.5, 1.0], np.float32),
                  early=np.array([early, early, not early]),
                  sat=np.array([0.6, 1.5, 1.0], np.float32),
                  hue_delta=np.array([-17.0, 9.5, 0.0], np.float32))
    ref = J.dct_pixel_photometric_apply(jnp.asarray(y), jnp.asarray(cbcr),
                                        **{k: jnp.asarray(v) for k, v in params.items()})
    got = P.dct_pixel_photometric_apply(torch.from_numpy(y), torch.from_numpy(cbcr),
                                        **{k: torch.from_numpy(v) for k, v in params.items()})
    close(got[0], ref[0], rtol=1e-4)
    close(got[1], ref[1], rtol=1e-4)


def test_random_op_with_jax_draws():
    rng = np.random.default_rng(4)
    y = rng.normal(0, 120, (6, 2, 4, 64)).astype(np.float32)
    cbcr = rng.normal(0, 40, (6, 1, 2, 128)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = J.dct_pixel_photometric(jnp.asarray(y), jnp.asarray(cbcr), key)
    got = P.dct_pixel_photometric_apply(torch.from_numpy(y), torch.from_numpy(cbcr),
                                        **draws.to_torch(draws.pixel_photometric(key, 6)))
    close(got[0], ref[0], rtol=1e-4)
    close(got[1], ref[1], rtol=1e-4)
