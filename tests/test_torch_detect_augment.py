"""The port's detection augmentation chain against the JAX package's, on the
CPU, from the same key.

JAX keys cannot be reproduced in torch, so `torch_aug_draws` replays each
JAX op's key schedule to get the values it drew, and the port's apply
functions take those.  Outputs are compared with the JAX op's own output
for that key:
  * GT masks exactly equal (and so the picked trials and flips, which
    decide them, and the crops);
  * boxes within 1e-3 px;
  * coefficients within 1e-5 of the largest JAX value (1e-4 with the
    pixel-space photometric chain);
  * with requantization a coefficient at a rounding tie may move one step:
    at most 1e-4 of the coefficients differ, each by exactly one step.
The samplers are held to the JAX distributions over a few thousand draws.

Maps are small (12 source blocks -> 8 output blocks) to keep the JAX
compiles short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jpeg_detection_resnet_ssd_tpu.ops as J
from jpeg_detection_resnet_ssd_torch.ops import dct_detect_augment as P

import torch_aug_draws as draws
from torch_cases import assert_augment_matches, augment_source

torch.set_num_threads(1)

B, H8, OUT = 4, 12, 8


@pytest.fixture(scope="module")
def batch():
    return augment_source(B, H8)


def jax_batch(batch):
    return {"inputs": tuple(jnp.asarray(a) for a in batch["inputs"]),
            "gt": jnp.asarray(batch["gt"]), "gt_mask": jnp.asarray(batch["gt_mask"])}


def torch_args(batch):
    y, cbcr = (torch.from_numpy(a) for a in batch["inputs"])
    return y, cbcr, torch.from_numpy(batch["gt"]), torch.from_numpy(batch["gt_mask"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand(batch, seed):
    key = jax.random.PRNGKey(seed)
    ref = J.dct_detection_expand(*jax_batch(batch)["inputs"], jnp.asarray(batch["gt"]),
                                 jnp.asarray(batch["gt_mask"]), key)
    got = P.dct_detection_expand_apply(*torch_args(batch),
                                       draws.to_torch(draws.expand(key, B, H8, H8)))
    assert_augment_matches(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_crop_flip(batch, seed):
    key = jax.random.PRNGKey(seed)
    ref = J.dct_detection_crop_flip(*jax_batch(batch)["inputs"], jnp.asarray(batch["gt"]),
                                    jnp.asarray(batch["gt_mask"]), key, out_y_blocks=OUT)
    got = P.dct_detection_crop_flip_apply(*torch_args(batch),
                                          draws.to_torch(draws.crop_flip(key, B, H8, H8, OUT)), OUT)
    assert_augment_matches(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_min_iou_crop_flip(batch, seed):
    key = jax.random.PRNGKey(seed)
    ref = J.dct_detection_min_iou_crop_flip(*jax_batch(batch)["inputs"], jnp.asarray(batch["gt"]),
                                            jnp.asarray(batch["gt_mask"]), key, out_y_blocks=OUT)
    d = draws.to_torch(draws.min_iou_crop_flip(key, B, H8, H8, OUT))
    got = P.dct_detection_min_iou_crop_flip_apply(*torch_args(batch), d, OUT)
    assert_augment_matches(got, ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_resized_crop(batch, seed):
    key = jax.random.PRNGKey(seed)
    ref = J.dct_detection_random_resized_crop(
        *jax_batch(batch)["inputs"], jnp.asarray(batch["gt"]), jnp.asarray(batch["gt_mask"]), key,
        out_y_blocks=OUT)
    d = draws.to_torch(draws.random_resized_crop(key, B, H8, H8))
    got = P.dct_detection_random_resized_crop_apply(*torch_args(batch), d, OUT)
    assert_augment_matches(got, ref)


def _maker_case(batch, jax_aug, port_aug, port_draws, key, **tol):
    ref = jax_aug(jax_batch(batch), key)
    got = port_aug.apply(port_aug.to_device(batch), draws.to_torch(port_draws))
    assert_augment_matches([*got["inputs"], got["gt"], got["gt_mask"]],
                           [*ref["inputs"], ref["gt"], ref["gt_mask"]], **tol)


def test_maker_v1(batch):
    key = jax.random.PRNGKey(10)
    _maker_case(batch, J.make_dct_detection_augment(OUT),
                P.make_dct_detection_augment(OUT, device="cpu"),
                draws.augment_v1(key, B, H8, H8, OUT), key)


@pytest.mark.parametrize("seed", [11, 12])
def test_maker_v2(batch, seed):
    key = jax.random.PRNGKey(seed)
    _maker_case(batch, J.make_dct_detection_augment_v2(OUT),
                P.make_dct_detection_augment_v2(OUT, device="cpu"),
                draws.augment_v2(key, B, H8, H8, OUT), key)


@pytest.mark.parametrize("photometric", [True, "pixel_hsv"])
@pytest.mark.parametrize("quality", [None, 75])
def test_maker_v3(batch, photometric, quality):
    key = jax.random.PRNGKey(13)
    tol = {"rtol": 1e-4 if photometric == "pixel_hsv" else 1e-5, "quality": quality}
    _maker_case(batch,
                J.make_dct_detection_augment_v3(OUT, photometric=photometric,
                                                requantize_quality=quality),
                P.make_dct_detection_augment_v3(OUT, photometric=photometric,
                                                requantize_quality=quality, device="cpu"),
                draws.augment_v3(key, B, H8, H8, photometric), key, **tol)


def test_maker_rejects_unknown_photometric_mode():
    with pytest.raises(ValueError, match="photometric"):
        P.make_dct_detection_augment_v3(photometric="hsv", device="cpu")


@pytest.mark.parametrize("maker", [P.make_dct_detection_augment, P.make_dct_detection_augment_v2,
                                   P.make_dct_detection_augment_v3])
def test_makers_sample_and_apply_on_their_device(batch, maker):
    """An int16-shipped NumPy batch goes in; tensors of the output frame on
    the maker's device come out, and the generator decides the draws."""
    aug = maker(OUT, device="cpu")
    shipped = dict(batch, inputs=tuple(np.round(a).astype(np.int16) for a in batch["inputs"]))
    outs = [aug(shipped, torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    y, cbcr = outs[0]["inputs"]
    assert y.shape == (B, OUT, OUT, 64) and cbcr.shape == (B, OUT // 2, OUT // 2, 128)
    assert y.dtype == torch.float32 and y.device.type == "cpu"
    assert outs[0]["gt"].shape == (B, 6, 5) and outs[0]["gt_mask"].dtype == torch.bool
    assert torch.equal(outs[0]["inputs"][0], outs[1]["inputs"][0])
    assert not torch.equal(outs[0]["inputs"][0], outs[2]["inputs"][0])


@pytest.mark.parametrize("op", ["photometric", "pixel_photometric", "expand", "crop_flip",
                                "min_iou_crop_flip", "random_resized_crop"])
def test_ops_with_a_generator_are_sample_then_apply(batch, op):
    """Each op of the JAX name draws from the generator on the host and
    applies: the same as its sampler and apply from an equal generator."""
    import jpeg_detection_resnet_ssd_torch.ops as ops
    from jpeg_detection_resnet_ssd_torch.ops import dct_augment, pixel_photometric

    y, cbcr, gt, mask = torch_args(batch)
    h8 = y.shape[1]
    sample_then_apply = {
        "photometric": (lambda g: ops.dct_random_photometric(y, cbcr, g),
                        lambda g: dct_augment.dct_random_photometric_apply(
                            y, cbcr, dct_augment.sample_photometric(B, g))),
        "pixel_photometric": (lambda g: ops.dct_pixel_photometric(y, cbcr, g),
                              lambda g: pixel_photometric.dct_pixel_photometric_apply(
                                  y, cbcr, **pixel_photometric.sample_pixel_photometric(B, g))),
        "expand": (lambda g: ops.dct_detection_expand(y, cbcr, gt, mask, g),
                   lambda g: P.dct_detection_expand_apply(
                       y, cbcr, gt, mask, P.sample_expand(B, h8, h8, g))),
        "crop_flip": (lambda g: ops.dct_detection_crop_flip(y, cbcr, gt, mask, g, OUT),
                      lambda g: P.dct_detection_crop_flip_apply(
                          y, cbcr, gt, mask, P.sample_crop_flip(B, h8, h8, g, OUT), OUT)),
        "min_iou_crop_flip": (
            lambda g: ops.dct_detection_min_iou_crop_flip(y, cbcr, gt, mask, g, OUT),
            lambda g: P.dct_detection_min_iou_crop_flip_apply(
                y, cbcr, gt, mask, P.sample_min_iou_crop_flip(B, h8, h8, g, OUT), OUT)),
        "random_resized_crop": (
            lambda g: ops.dct_detection_random_resized_crop(y, cbcr, gt, mask, g, OUT),
            lambda g: P.dct_detection_random_resized_crop_apply(
                y, cbcr, gt, mask, P.sample_random_resized_crop(B, h8, h8, g), OUT)),
    }
    composed, split = sample_then_apply[op]
    for got, ref in zip(composed(torch.Generator().manual_seed(5)),
                        split(torch.Generator().manual_seed(5))):
        assert torch.equal(got, ref)


N = 4000


def _rate(x):
    return float(np.mean(np.asarray(x, np.float64)))


def test_samplers_match_the_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    got = P.sample_random_resized_crop(N, 44, 44, gen)
    ref = draws.random_resized_crop(key, N, 44, 44)
    f = got["f"].numpy()
    assert 1.0 <= f.min() and f.max() < 4.0
    for name, want in (("flip", 0.5), ("ident", 0.3)):
        assert abs(_rate(got[name]) - want) < 0.03 and abs(_rate(ref[name]) - want) < 0.03
    assert abs(_rate(f > 1.0) - 0.5) < 0.03 and abs(_rate(ref["f"] > 1.0) - 0.5) < 0.03
    assert abs(float(np.median(f[f > 1])) - 2.5) < 0.1
    assert set(np.unique(got["interp_mode"].numpy())) == set(range(5))
    np.testing.assert_allclose(np.bincount(got["interp_mode"].numpy()) / N, 0.2, atol=0.025)
    np.testing.assert_array_equal(np.unique(got["bound"].numpy()), np.unique(ref["bound"]))
    np.testing.assert_array_equal(np.unique(ref["bound"]), P._IOU_BOUNDS)
    for name in ("s_h", "s_w", "u"):
        lo, hi = (0.0, 1.0) if name == "u" else (0.3, 1.0)
        assert lo <= got[name].min() and got[name].max() < hi
        assert abs(_rate(got[name]) - _rate(ref[name])) < 0.01
    py = got["py"].numpy()
    assert (py >= 0).all() and (py <= (f - 1) * 352 + 1e-3).all()
    assert abs(_rate(py) - _rate(ref["py"])) < 0.1 * _rate(ref["py"])

    exp = P.sample_expand(N, 44, 44, gen)
    assert abs(_rate(exp["do"]) - 0.5) < 0.03
    np.testing.assert_array_equal(np.unique(exp["oy"].numpy()), np.arange(12))
    crop = P.sample_min_iou_crop_flip(N, 44, 44, gen, 38, 8)
    assert crop["y0"].shape == (N, 8)
    np.testing.assert_array_equal(np.unique(crop["x0"].numpy()), np.arange(4))


@pytest.mark.parametrize("kind", ["dct", "pixel_hsv"])
def test_photometric_samplers_match_the_jax_distributions(kind):
    gen = torch.Generator().manual_seed(1)
    key = jax.random.PRNGKey(1)
    if kind == "dct":
        got = P.sample_photometric(N, gen)
        ref = draws.photometric(key, N)
        hue_max, hue = 36.0 * np.pi / 180.0, "hue"
    else:
        got = P.sample_pixel_photometric(N, gen)
        ref = draws.pixel_photometric(key, N)
        hue_max, hue = 18.0, "hue_delta"
        assert abs(_rate(got["early"]) - 0.5) < 0.03
    assert set(got) == set(ref)
    for name, neutral, bound in (("bright", 0.0, 32.0), ("contrast", 1.0, 0.5),
                                 ("sat", 1.0, 0.5), (hue, 0.0, hue_max)):
        x = got[name].numpy()
        assert abs(_rate(x != neutral) - _rate(ref[name] != neutral)) < 0.04, name
        assert np.abs(x - neutral).max() <= bound * (1 + 1e-6), name
