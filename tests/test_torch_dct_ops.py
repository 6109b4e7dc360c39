"""The port's DCT-domain ops against the JAX package's, on the CPU: block
DCT, vertical flip, block crop, exact 2x downscale, brightness/contrast,
chroma hue/saturation, the random photometric op with pinned draws, and
JPEG requantization.

Tolerance: max |port - JAX| <= 1e-5 * max |JAX| (float32 einsums and
elementwise maps; the two libraries sum the 8x8 products in other orders).
The flip, the crop and the requantization of the same inputs are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_detection_resnet_ssd_tpu.ops as J
from jpeg_detection_resnet_ssd_tpu.ops import jpeg_quant as jax_quant
from jpeg_detection_resnet_ssd_torch import ops as P
from jpeg_detection_resnet_ssd_torch.ops import dct_augment, jpeg_quant

import torch_aug_draws as draws

torch.set_num_threads(1)
RTOL = 1e-5


def close(got, ref, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rtol * np.abs(ref).max(), f"max |diff| {err} vs {rtol} * {np.abs(ref).max()}"


def planes(seed, b=3, h8=6, w8=8, scale=50.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, scale, (b, h8, w8, 64)).astype(np.float32),
            rng.normal(0, scale * 0.3, (b, h8 // 2, w8 // 2, 128)).astype(np.float32))


def test_block_dct_round_trip_and_parity():
    y, _ = planes(0)
    close(P.idct2_8x8(torch.from_numpy(y)), J.idct2_8x8(jnp.asarray(y)))
    px = np.random.default_rng(1).normal(0, 40, (3, 5, 8, 8)).astype(np.float32)
    close(P.dct2_8x8(torch.from_numpy(px)), J.dct2_8x8(jnp.asarray(px)))
    np.testing.assert_array_equal(P.DCT_BASIS_8, J.DCT_BASIS_8)


@pytest.mark.parametrize("channels", [64, 128])
def test_flip_vertical_and_crop_exact(channels):
    x = np.random.default_rng(channels).normal(0, 50, (2, 6, 7, channels)).astype(np.float32)
    np.testing.assert_array_equal(P.dct_flip_vertical(torch.from_numpy(x)).numpy(),
                                  np.asarray(J.dct_flip_vertical(jnp.asarray(x))))
    for y0, x0 in ((1, 2), (0, 0), (5, 9)):  # the last start is clamped, as dynamic_slice does
        np.testing.assert_array_equal(
            P.dct_crop_blocks(torch.from_numpy(x), y0, x0, 3, 4).numpy(),
            np.asarray(J.dct_crop_blocks(jnp.asarray(x), y0, x0, 3, 4)))


def test_crop_blocks_per_image_offsets():
    x = np.random.default_rng(5).normal(0, 50, (3, 8, 9, 64)).astype(np.float32)
    y0, x0 = np.array([0, 2, 7]), np.array([5, 1, 0])
    got = P.dct_crop_blocks(torch.from_numpy(x), torch.from_numpy(y0), torch.from_numpy(x0), 4, 5)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(J.dct_crop_blocks(jnp.asarray(x[i]), y0[i], x0[i], 4, 5)))


@pytest.mark.parametrize("channels", [64, 128])
def test_downscale_2x(channels):
    x = np.random.default_rng(6).normal(0, 50, (2, 6, 8, channels)).astype(np.float32)
    close(P.dct_downscale_2x(torch.from_numpy(x)), J.dct_downscale_2x(jnp.asarray(x)))


@pytest.mark.parametrize("params", ["scalar", "per_image", "per_image_contrast"])
@pytest.mark.parametrize("is_luma", [True, False])
def test_brightness_contrast(params, is_luma):
    y, cbcr = planes(7)
    x = y if is_luma else cbcr
    b = {"scalar": 12.5, "per_image": np.array([-20.0, 0.0, 31.0], np.float32),
         "per_image_contrast": 0.0}[params]
    a = {"scalar": 1.3, "per_image": np.array([0.6, 1.0, 1.45], np.float32),
         "per_image_contrast": np.array([0.6, 1.0, 1.45], np.float32)}[params]
    ref = J.dct_brightness_contrast(jnp.asarray(x), b, a, is_luma=is_luma)
    got = P.dct_brightness_contrast(torch.from_numpy(x), torch.as_tensor(b), torch.as_tensor(a),
                                    is_luma=is_luma)
    close(got, ref)


@pytest.mark.parametrize("per_image", [False, True])
def test_chroma_hue_saturation(per_image):
    _, cbcr = planes(8)
    hue = np.array([-0.5, 0.0, 0.6], np.float32) if per_image else 0.3
    sat = np.array([0.5, 1.2, 1.0], np.float32) if per_image else 1.4
    ref = J.dct_chroma_hue_saturation(jnp.asarray(cbcr), hue, sat)
    got = P.dct_chroma_hue_saturation(torch.from_numpy(cbcr), torch.as_tensor(hue),
                                      torch.as_tensor(sat))
    close(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_photometric_apply_with_jax_draws(seed):
    y, cbcr = planes(9 + seed, b=6)
    key = jax.random.PRNGKey(seed)
    ref_y, ref_c = J.dct_random_photometric(jnp.asarray(y), jnp.asarray(cbcr), key)
    d = draws.to_torch(draws.photometric(key, 6))
    got_y, got_c = dct_augment.dct_random_photometric_apply(torch.from_numpy(y),
                                                            torch.from_numpy(cbcr), d)
    close(got_y, ref_y)
    close(got_c, ref_c)


@pytest.mark.parametrize("quality", [10, 50, 75, 95])
def test_quant_tables_equal(quality):
    for got, ref in zip(jpeg_quant.quant_tables(quality), jax_quant.quant_tables(quality)):
        np.testing.assert_array_equal(got, ref)
    assert jpeg_quant.quality_scaling(quality) == jax_quant.quality_scaling(quality)


def test_requantize_exactly_equal():
    y, cbcr = planes(10, scale=80.0)
    ref_y, ref_c = J.jpeg_requantize(jnp.asarray(y), jnp.asarray(cbcr), 75)
    got_y, got_c = P.jpeg_requantize(torch.from_numpy(y), torch.from_numpy(cbcr), 75)
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(ref_y))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
