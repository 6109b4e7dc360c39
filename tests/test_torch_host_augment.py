"""Port parity: the host detection augmentation ops and chains of
`data/augment.py`, and the training `DetectionPipeline` that runs them,
JAX package vs PyTorch port (CPU).

One cv2 serves both packages here, and every op draws from an explicit
`np.random.Generator`, so from one seed the two packages must give
identical uint8 images, identical labels and the same number of draws (the
generators' next value is compared too): any difference is a porting fault.
"""

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu import data as jax_data
from jpeg_detection_resnet_ssd_tpu.boxes import AnchorSpec as JaxAnchorSpec
from jpeg_detection_resnet_ssd_tpu.boxes import TargetEncoder as JaxTargetEncoder
from jpeg_detection_resnet_ssd_tpu.data import augment as jax_aug
from jpeg_detection_resnet_ssd_torch import data
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.data import augment
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes

from torch_cases import assert_same, write_voc_tree

torch.set_num_threads(1)

SEEDS = range(20)


def make_image(seed=0, h=180, w=260):
    """A seeded uint8 RGB image with smooth content and noise."""
    rng = np.random.default_rng(1000 + seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 110 + 70 * np.sin(xx / rng.uniform(5, 15)) + 0.2 * yy
    img = np.stack([base, 0.6 * base + 40, 255 - base], -1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def make_labels(seed=0, h=180, w=260, k=4):
    """(k, 5) float32 labels: random boxes, one tiny, one touching the right
    edge, one degenerate (zero width)."""
    rng = np.random.default_rng(2000 + seed)
    x0 = rng.uniform(0, w - 40, k)
    y0 = rng.uniform(0, h - 40, k)
    x1 = np.minimum(x0 + rng.uniform(8, 200, k), w)
    y1 = np.minimum(y0 + rng.uniform(8, 150, k), h)
    labels = np.stack([rng.integers(1, 21, k), x0, y0, x1, y1], 1).astype(np.float32)
    if k >= 3:
        labels[1, 3:] = labels[1, 1:3] + 2.0
        labels[2, 3] = w
    if k >= 4:
        labels[3, 3] = labels[3, 1]
    return labels


def run_both(make_op, seed, *args, image=None, labels=None, **kwargs):
    """Run the op made by `make_op(module)` in both packages on copies of one
    image and labels with generators seeded `seed`; assert the outputs and
    the generators' next draw are identical; return the port's output."""
    image = make_image(seed) if image is None else image
    labels = make_labels(seed) if labels is None else labels
    outs = []
    for module in (augment, jax_aug):
        rng = np.random.default_rng(seed)
        out = make_op(module)(image.copy(), labels.copy(), rng, *args, **kwargs)
        outs.append((out, rng.random()))
    (got, got_next), (ref, ref_next) = outs
    assert_equal_outputs(got, ref)
    assert got_next == ref_next
    return got


def assert_equal_outputs(got, ref):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_equal_outputs(g, r)
    elif ref is None:
        assert got is None
    elif callable(ref):  # an inverter: equal on seeded rows
        rows = np.random.default_rng(0).uniform(0, 300, (6, 6)).astype(np.float32)
        assert_equal_outputs(got(rows), ref(rows))
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def deterministic(fn):
    """An op without draws as an (image, labels, rng, ...) callable."""
    return lambda image, labels, rng, *a, **kw: fn(image, labels, *a, **kw)


# --- photometric ------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("brightness_shift", (-32.0,)), ("brightness_shift", (17.3,)),
    ("contrast_scale", (0.5,)), ("contrast_scale", (1.37,)),
    ("gamma_adjust", (0.6,)), ("gamma_adjust", (1.8,)),
    ("channel_swap", ()), ("channel_swap", ((1, 0, 2),)), ("to_3_channels", ()),
])
def test_pixel_ops_match_jax(name, args):
    image = make_image(3)
    got = getattr(augment, name)(image.copy(), *args)
    assert_equal_outputs(got, getattr(jax_aug, name)(image.copy(), *args))
    assert got.dtype == np.uint8


@pytest.mark.parametrize("name,arg", [
    ("saturation_scale_hsv", 0.5), ("saturation_scale_hsv", 1.45),
    ("hue_shift_hsv", -18.0), ("hue_shift_hsv", 11.5),
])
def test_hsv_ops_match_jax(name, arg):
    hsv = augment._rgb_to_hsv(make_image(4)).astype(np.float32)
    np.testing.assert_array_equal(hsv, jax_aug._rgb_to_hsv(make_image(4)).astype(np.float32))
    got = getattr(augment, name)(hsv, arg)
    assert_equal_outputs(got, getattr(jax_aug, name)(hsv, arg))
    rgb = np.clip(got, 0, 255).round().astype(np.uint8)
    assert_equal_outputs(augment._hsv_to_rgb(rgb), jax_aug._hsv_to_rgb(rgb))


@pytest.mark.parametrize("seed", range(8))
def test_ssd_photometric_distortions_match_jax(seed):
    run_both(lambda m: m.SSDPhotometricDistortions(), seed)


@pytest.mark.parametrize("seed", range(4))
def test_photometric_preset_matches_jax(seed):
    run_both(lambda m: m._PhotometricPreset(), seed)


# --- geometric --------------------------------------------------------------

@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("inverter", [False, True])
def test_resize_random_interp_matches_jax(seed, inverter):
    out = run_both(lambda m: m.ResizeRandomInterp(300, 300), seed, return_inverter=inverter)
    assert out[0].shape == (300, 300, 3)


@pytest.mark.parametrize("name", ["horizontal_flip", "vertical_flip"])
def test_flips_match_jax(name):
    run_both(lambda m: deterministic(getattr(m, name)), 0)


@pytest.mark.parametrize("dim", ["horizontal", "vertical"])
@pytest.mark.parametrize("seed", range(3))
def test_random_flip_matches_jax(dim, seed):
    run_both(lambda m: m.RandomFlip(dim, 0.5), seed)


@pytest.mark.parametrize("dy,dx", [(13, -40), (-25, 7), (0, 0), (170, -250)])
def test_translate_matches_jax(dy, dx):
    run_both(lambda m: deterministic(m.translate), 1, dy, dx)
    run_both(lambda m: deterministic(m.translate), 1, dy, dx, (9, 8, 7), False)


@pytest.mark.parametrize("k", range(5))
def test_rotate90_matches_jax(k):
    run_both(lambda m: deterministic(m.rotate90), 2, k)


@pytest.mark.parametrize("factor", [0.6, 1.0, 1.7])
def test_scale_affine_matches_jax(factor):
    run_both(lambda m: deterministic(m.scale_affine), 3, factor)


@pytest.mark.parametrize("angle,scale", [(17.0, 1.0), (-45.0, 0.8), (90.0, 1.0)])
def test_rotate_angle_matches_jax(angle, scale):
    run_both(lambda m: deterministic(m.rotate_angle), 4, angle, scale)


# --- patch sampling ---------------------------------------------------------

def test_iou_patch_boxes_matches_jax():
    boxes = make_labels(5, k=12)[:, 1:]
    for patch in ([0, 0, 100, 80], [50, 20, 51, 21], [300, 300, 400, 400]):
        patch = np.asarray(patch, np.float32)
        assert_equal_outputs(augment._iou_patch_boxes(patch, boxes),
                             jax_aug._iou_patch_boxes(patch, boxes))


@pytest.mark.parametrize("ymin,xmin,h,w,clip", [
    (10, 20, 100, 120, True), (-50, -80, 400, 500, False), (150, 200, 60, 90, True),
    (-20, 30, 50, 400, True),
])
def test_crop_patch_matches_jax(ymin, xmin, h, w, clip):
    run_both(lambda m: deterministic(m.crop_patch), 6, ymin, xmin, h, w, clip_boxes=clip)


@pytest.mark.parametrize("seed", range(10))
def test_ssd_expand_matches_jax(seed):
    run_both(lambda m: m.SSDExpand(), seed)


@pytest.mark.parametrize("seed", range(10))
def test_ssd_random_crop_matches_jax(seed):
    run_both(lambda m: m.SSDRandomCrop(), seed)


def test_ssd_random_crop_without_labels_matches_jax():
    run_both(lambda m: m.SSDRandomCrop(), 3, labels=np.zeros((0, 5), np.float32))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ar", [1.0, 1.6, 0.7])
def test_random_max_crop_fixed_ar_matches_jax(seed, ar):
    run_both(lambda m: m.RandomMaxCropFixedAR(ar), seed)

    def validator(module):
        bounds = module.BoundGenerator(((0.3, None), (0.9, None)))
        return lambda labels, h, w, rng: module.image_is_valid(
            labels, h, w, overlap_criterion="area", bounds=bounds, rng=rng)

    run_both(lambda m: m.RandomMaxCropFixedAR(ar, n_trials_max=4,
                                              image_validator=validator(m)), seed)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("ar,shape", [(1.0, (180, 260)), (2.0, (100, 80)), (0.5, (120, 90))])
def test_random_pad_fixed_ar_matches_jax(seed, ar, shape):
    run_both(lambda m: m.RandomPadFixedAR(ar, (10, 20, 30)), seed,
             image=make_image(seed, *shape), labels=make_labels(seed, *shape))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("op", ["RandomTranslate", "RandomScale", "RandomPatchAspect"])
def test_bounded_trial_ops_match_jax(seed, op):
    run_both(lambda m: getattr(m, op)(), seed)


# --- box validation ---------------------------------------------------------

@pytest.mark.parametrize("criterion", ["center_point", "area", "iou"])
@pytest.mark.parametrize("border", ["half", "include", "exclude"])
@pytest.mark.parametrize("bounds", [(0.3, 1.0), (0.0, 0.8)])
def test_box_filter_matches_jax(criterion, border, bounds):
    labels = np.concatenate([make_labels(7, k=10), make_labels(8, k=6)])
    labels[:4, [1, 3]] += 150  # boxes leaving the image
    kw = dict(overlap_criterion=criterion, border_pixels=border, overlap_bounds=bounds,
              min_area=40)
    assert_equal_outputs(augment.box_filter(labels, 180, 260, **kw),
                         jax_aug.box_filter(labels, 180, 260, **kw))
    assert_equal_outputs(augment.box_filter(labels[:0], 180, 260, **kw),
                         jax_aug.box_filter(labels[:0], 180, 260, **kw))


@pytest.mark.parametrize("seed", range(3))
def test_bound_generator_and_validator_match_jax(seed):
    labels = make_labels(9, k=8)
    labels[:3, [2, 4]] -= 120
    space = ((0.1, None), (0.5, 0.9), (None, None))
    for weights in (None, [0.2, 0.5, 0.3]):
        for n_min in (1, 3, "all"):
            got, ref = [
                [m.image_is_valid(labels, 180, 260, overlap_criterion=crit, n_boxes_min=n_min,
                                  bounds=m.BoundGenerator(space, weights), rng=rng)
                 for crit in ("center_point", "area", "iou")]
                for m, rng in ((augment, np.random.default_rng(seed)),
                               (jax_aug, np.random.default_rng(seed)))
            ]
            assert got == ref
    for m in (augment, jax_aug):
        with pytest.raises(ValueError, match="lower bound"):
            m.BoundGenerator(((0.9, 0.1),))
        with pytest.raises(ValueError, match="weights"):
            m.BoundGenerator(((0.1, None),), weights=[0.5, 0.5])
        with pytest.raises(ValueError, match="rng"):
            m.box_filter(labels, 180, 260, overlap_bounds=m.BoundGenerator())


# --- chains -----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("crop", [True, False])
def test_ssd_data_augmentation_matches_jax(seed, crop):
    """The default training chain: photometric, expand, min-IoU crop (on or
    off), flip, resize with a random interpolation."""
    image, labels = run_both(lambda m: m.SSDDataAugmentation(300, 300, crop=crop), seed)
    assert image.shape == (300, 300, 3) and image.dtype == np.uint8
    assert labels.dtype == np.float32 and labels.shape[1] == 5


def test_ssd_data_augmentation_inverter_and_no_crop_match_jax():
    run_both(lambda m: m.SSDDataAugmentation(320, 288), 5, return_inverter=True)
    run_both(lambda m: m.SSDDataAugmentationNoCrop(300, 300, (1, 2, 3)), 6)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("chain", ["DataAugmentationConstantInputSize",
                                   "DataAugmentationVariableInputSize",
                                   "DataAugmentationSatellite"])
def test_preset_chains_match_jax(seed, chain):
    run_both(lambda m: getattr(m, chain)(), seed)


# --- the training pipeline --------------------------------------------------

@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    write_voc_tree(root, n_images=5, seed=4)
    return (str(root / "JPEGImages"), str(root / "ImageSets" / "Main" / "test.txt"),
            str(root / "Annotations"))


@pytest.mark.parametrize("device_encode", [True, False])
def test_default_training_pipeline_matches_jax(voc, device_encode):
    """`DetectionPipeline(train=True)` runs `SSDDataAugmentation` by default:
    two epochs of batches equal to the JAX package's padded-GT batches.
    Without `device_encode` the batch carries the port encoder's targets of
    that same GT, exactly.  (The two packages' encoders are held to each
    other in `test_torch_target_encoder.py`; on augmented boxes two anchors
    can tie exactly in IoU, and float rounding then breaks the tie
    differently in the jitted JAX encoder.)"""
    ds = data.DetectionDataset.from_voc(*voc)
    sizes = ssd_predictor_sizes("resnet_custom")
    kw = dict(train=True, max_gt=8, num_workers=2, seed=5)
    encoder = TargetEncoder(AnchorSpec(), sizes, device="cpu")
    port = data.DetectionPipeline(ds, 2, encoder=encoder, device_encode=device_encode, **kw)
    ref = jax_data.DetectionPipeline(ds, 2, encoder=JaxTargetEncoder(JaxAnchorSpec(), sizes),
                                     device_encode=True, **kw)
    assert isinstance(port.augmentation, augment.SSDDataAugmentation)
    for _ in range(2):
        got, want = list(port), list(ref)
        assert len(got) == 2
        for g, w in zip(got, want):
            if device_encode:
                assert_same(g, w)
            else:
                assert_same(g["inputs"], w["inputs"])
                assert torch.equal(g["targets"], encoder(w["gt"], w["gt_mask"]))
        assert got[0]["inputs"][0].shape == (2, 38, 38, 64)
