"""The random draws of the JAX package's DCT augmentation ops, replayed from
a key: each function splits the key as the JAX op does and draws the same
values (with the same derived values), so the port's apply functions can be
fed exactly what the JAX op used.  Returned as nested dicts of NumPy arrays;
`to_torch` converts them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jpeg_detection_resnet_ssd_tpu.ops.dct_detect_augment import _IOU_BOUNDS
from jpeg_detection_resnet_ssd_tpu.ops.dct_resize import N_INTERP_MODES


def to_torch(draws):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in draws.items()}


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.partial(jax.jit, static_argnums=(1,))
def _photometric(rng, b):
    # ops/dct_augment.py::dct_random_photometric, defaults
    k1, k2, k3, k4, k5, k6, k7, k8 = jax.random.split(rng, 8)
    bright = jax.random.uniform(k1, (b,), minval=-32.0, maxval=32.0) * jax.random.bernoulli(
        k2, 0.5, (b,))
    contrast = jnp.where(jax.random.bernoulli(k4, 0.5, (b,)),
                         jax.random.uniform(k3, (b,), minval=0.5, maxval=1.5), 1.0)
    sat = jnp.where(jax.random.bernoulli(k6, 0.5, (b,)),
                    jax.random.uniform(k5, (b,), minval=0.5, maxval=1.5), 1.0)
    hue = jnp.where(jax.random.bernoulli(k8, 0.5, (b,)),
                    jax.random.uniform(k7, (b,), minval=-36.0 * jnp.pi / 180.0,
                                       maxval=36.0 * jnp.pi / 180.0), 0.0)
    return {"bright": bright, "contrast": contrast, "sat": sat, "hue": hue}


def photometric(rng, b):
    return _numpy(_photometric(rng, b))


@functools.partial(jax.jit, static_argnums=(1,))
def _pixel_photometric(rng, b):
    # ops/pixel_photometric.py::dct_pixel_photometric, defaults
    keys = jax.random.split(rng, 9)
    bright = jax.random.uniform(keys[0], (b,), minval=-32.0, maxval=32.0) * jax.random.bernoulli(
        keys[1], 0.5, (b,))
    contrast = jnp.where(jax.random.bernoulli(keys[2], 0.5, (b,)),
                         jax.random.uniform(keys[3], (b,), minval=0.5, maxval=1.5), 1.0)
    early = jax.random.bernoulli(keys[4], 0.5, (b,))
    sat = jnp.where(jax.random.bernoulli(keys[5], 0.5, (b,)),
                    jax.random.uniform(keys[6], (b,), minval=0.5, maxval=1.5), 1.0)
    hue = jnp.where(jax.random.bernoulli(keys[7], 0.5, (b,)),
                    jax.random.uniform(keys[8], (b,), minval=-18.0, maxval=18.0), 0.0)
    return {"bright": bright, "contrast": contrast, "early": early, "sat": sat, "hue_delta": hue}


def pixel_photometric(rng, b):
    return _numpy(_pixel_photometric(rng, b))


def expand(rng, b, h8, w8):
    # ops/dct_detect_augment.py::dct_detection_expand, prob 0.5
    k1, k2, k3 = jax.random.split(rng, 3)
    return _numpy({
        "do": jax.random.bernoulli(k1, 0.5, (b,)),
        "oy": jax.random.randint(k2, (b,), 0, h8 // 4 + 1),
        "ox": jax.random.randint(k3, (b,), 0, w8 // 4 + 1),
    })


def crop_flip(rng, b, h8, w8, out_y_blocks):
    # ops/dct_detect_augment.py::dct_detection_crop_flip
    k1, k2, k3 = jax.random.split(rng, 3)
    return _numpy({
        "y0": jax.random.randint(k1, (b,), 0, (h8 - out_y_blocks) // 2 + 1),
        "x0": jax.random.randint(k2, (b,), 0, (w8 - out_y_blocks) // 2 + 1),
        "flip": jax.random.bernoulli(k3, 0.5, (b,)),
    })


def min_iou_crop_flip(rng, b, h8, w8, out_y_blocks):
    # ops/dct_detect_augment.py::dct_detection_min_iou_crop_flip, 8 trials
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    return _numpy({
        "bound": jnp.asarray(_IOU_BOUNDS)[jax.random.randint(k1, (b,), 0, _IOU_BOUNDS.shape[0])],
        "y0": jax.random.randint(k2, (b, 8), 0, (h8 - out_y_blocks) // 2 + 1),
        "x0": jax.random.randint(k3, (b, 8), 0, (w8 - out_y_blocks) // 2 + 1),
        "flip": jax.random.bernoulli(k4, 0.5, (b,)),
    })


def random_resized_crop(rng, b, h8, w8):
    # ops/dct_detect_augment.py::dct_detection_random_resized_crop with its
    # defaults: expand p 0.5 up to 4x, scales U(0.3, 1), bail-out p 0.3.  The
    # placement (py, px) is derived in NumPy float32, op by op: the compiled
    # JAX op rounds f * H before subtracting H (a jitted helper would fuse
    # the two into one multiply-add and differ by an ulp).
    H, W = np.float32(h8 * 8), np.float32(w8 * 8)
    keys = jax.random.split(rng, 11)
    do_exp = jax.random.bernoulli(keys[0], 0.5, (b,))
    f = np.asarray(jnp.where(
        do_exp, jax.random.uniform(keys[1], (b,), minval=1.0, maxval=4.0), 1.0))
    u_py = np.asarray(jax.random.uniform(keys[2], (b,)))
    u_px = np.asarray(jax.random.uniform(keys[3], (b,)))
    return _numpy({
        "interp_mode": jax.random.randint(keys[10], (b,), 0, N_INTERP_MODES),
        "f": f,
        "py": u_py * (f * H - H),
        "px": u_px * (f * W - W),
        "bound": jnp.asarray(_IOU_BOUNDS)[jax.random.randint(keys[4], (b,), 0, _IOU_BOUNDS.shape[0])],
        "s_h": jax.random.uniform(keys[5], (b, 8), minval=0.3, maxval=1.0),
        "s_w": jax.random.uniform(keys[6], (b, 8), minval=0.3, maxval=1.0),
        "u": jax.random.uniform(keys[7], (b, 8, 2)),
        "flip": jax.random.bernoulli(keys[8], 0.5, (b,)),
        "ident": jax.random.bernoulli(keys[9], 0.3, (b,)),
    })


def augment_v1(rng, b, h8, w8, out_y_blocks=38):
    return {"crop": crop_flip(rng, b, h8, w8, out_y_blocks)}


def augment_v2(rng, b, h8, w8, out_y_blocks=38):
    k1, k2, k3 = jax.random.split(rng, 3)
    return {"photometric": photometric(k1, b), "expand": expand(k2, b, h8, w8),
            "crop": min_iou_crop_flip(k3, b, h8, w8, out_y_blocks)}


def augment_v3(rng, b, h8, w8, photometric_mode=True):
    k1, k2 = jax.random.split(rng)
    draws = {"crop": random_resized_crop(k2, b, h8, w8)}
    if photometric_mode:
        draws["photometric"] = (pixel_photometric if photometric_mode == "pixel_hsv"
                                else photometric)(k1, b)
    return draws


def cls_crop_flip(rng, b, h8, w8, out_y_blocks):
    # ops/dct_augment.py::dct_random_crop_flip
    k1, k2, k3 = jax.random.split(rng, 3)
    return _numpy({
        "y0": jax.random.randint(k1, (b,), 0, (h8 - out_y_blocks) // 2 + 1),
        "x0": jax.random.randint(k2, (b,), 0, (w8 - out_y_blocks) // 2 + 1),
        "flip": jax.random.bernoulli(k3, 0.5, (b,)),
    })


def cls_augment_v1(rng, b, h8, w8, out_y_blocks=28):
    # ops/dct_augment.py::make_dct_classification_augment, photometric on
    k1, k2 = jax.random.split(rng)
    return {"crop": cls_crop_flip(k1, b, h8, w8, out_y_blocks), "photometric": photometric(k2, b)}


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _cls_crop_v2(rng, b, h8, w8, scale_range, ar_range, identity_prob):
    # ops/dct_augment.py::make_dct_classification_augment_v2's crop draws and
    # their derived values, jitted as the JAX train step compiles them (the
    # un-jitted op rounds sqrt(area / ar) * H differently by an ulp)
    H, W = jnp.float32(h8 * 8), jnp.float32(w8 * 8)
    k1, k2, k3, k4, k5, k6, k7 = jax.random.split(rng, 7)
    area = jax.random.uniform(k1, (b,), minval=scale_range[0], maxval=scale_range[1])
    ar = jnp.exp(jax.random.uniform(k2, (b,), minval=jnp.log(ar_range[0]),
                                    maxval=jnp.log(ar_range[1])))
    ch = jnp.minimum(jnp.sqrt(area / ar) * H, H)
    cw = jnp.minimum(jnp.sqrt(area * ar) * W, W)
    ident = jax.random.bernoulli(k3, identity_prob, (b,))
    ch = jnp.where(ident, H, ch)
    cw = jnp.where(ident, W, cw)
    crop = {
        "y0": jax.random.uniform(k4, (b,)) * (H - ch),
        "x0": jax.random.uniform(k5, (b,)) * (W - cw),
        "ch": ch,
        "cw": cw,
        "flip": jax.random.bernoulli(k6, 0.5, (b,)),
    }
    return crop, k7, ident


def cls_augment_v2(rng, b, h8, w8, scale_range=(0.35, 1.0), ar_range=(0.75, 1.333),
                   identity_prob=0.2):
    # ops/dct_augment.py::make_dct_classification_augment_v2, photometric on;
    # "ident" (the full-frame draw) rides along for the distribution test
    crop, k7, ident = _cls_crop_v2(rng, b, h8, w8, tuple(scale_range), tuple(ar_range),
                                   identity_prob)
    return {"crop": _numpy(crop), "photometric": photometric(k7, b), "ident": np.asarray(ident)}
