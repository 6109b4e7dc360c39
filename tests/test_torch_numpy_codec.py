"""The port's NumPy JPEG-coefficient codec (`data/dct_convert.py`) against
the libjpeg path (PIL encode + the port's `dctjpeg`), and the `codec`
argument of the pipelines and the packed corpus.

The codec is the libjpeg forward path in NumPy, so every comparison with
the libjpeg path here is exact: no tolerance.  The stage tests localise a
mismatch: colour conversion and the DCT alone (4:4:4 at quality 100, where
every quantizer step is 1), the DCT against the float DCT-II, the
downsampling bias and the quantizer's rounding.
"""

import numpy as np
import pytest

from jpeg_detection_resnet_ssd_torch import data, dctjpeg
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.data import dct_convert, packed
from jpeg_detection_resnet_ssd_torch.data.augment import SSDDataAugmentation
from jpeg_detection_resnet_ssd_torch.data.dct_convert import (
    rgb_to_dct_tensors,
    rgb_to_dct_tensors_numpy,
)
from jpeg_detection_resnet_ssd_torch.models import ssd_predictor_sizes

from torch_cases import CODEC_DIGEST, assert_same, codec_digest, write_voc_tree

SIZES = [(352, 352), (300, 300), (256, 256), (203, 317)]
QUALITIES = [75, 92, 50]
KINDS = ["random", "smooth", "flat", "saturated", "step_edge"]


def make_image(kind, h, w, seed=0):
    rng = np.random.default_rng([seed, h, w])
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "smooth":
        img = np.stack([128 + 100 * np.sin(xx / 17.0), 0.6 * yy + 20, 255 - 0.4 * (xx + yy) % 256], -1)
        return np.clip(img + rng.normal(0, 2, img.shape), 0, 255).astype(np.uint8)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8), (h, w, 3)).copy()
    if kind == "saturated":  # every channel at 0 or 255, in 8x8 patches
        patches = rng.integers(0, 2, (-(-h // 8), -(-w // 8), 3)) * 255
        return np.repeat(np.repeat(patches, 8, 0), 8, 1)[:h, :w].astype(np.uint8)
    img = np.zeros((h, w, 3), np.uint8)  # step edges off the block grid
    img[:, w // 2 + 3:] = (255, 40, 200)
    img[h // 3 + 5:, :, 1] = 230
    img[yy > xx + 7] = (10, 250, 90)
    return img


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("h,w", SIZES)
def test_numpy_codec_equals_libjpeg_bit_for_bit(kind, quality, h, w):
    image = make_image(kind, h, w)
    ref = rgb_to_dct_tensors(image, quality)
    got = rgb_to_dct_tensors_numpy(image, quality)
    assert ref[0].shape == (-(-h // 8), -(-w // 8), 64)
    assert ref[1].shape == (-(-h // 16), -(-w // 16), 128)
    assert_same(got, ref)
    assert_same(rgb_to_dct_tensors(image, quality, codec="numpy"), ref)


@pytest.mark.parametrize("h,w", [(64, 48), (203, 317), (9, 13)])
def test_colour_conversion_and_dct_equal_libjpeg_at_444_quality_100(h, w):
    """4:4:4 at quality 100 (every step 1): libjpeg's Y, Cb and Cr
    coefficients are the colour conversion and the islow DCT alone."""
    image = make_image("random", h, w, seed=1)
    comps, _, sampling = dctjpeg.decode_components(dct_convert._encode(image, 100, 0))
    assert sampling == [(1, 1)] * 3
    ones = np.ones(64, np.int64)
    hb, wb = -(-h // 8), -(-w // 8)
    for ref, plane in zip(comps, dct_convert.rgb_to_ycc(image)):
        padded = dct_convert._replicate_edges(plane, hb * 8, wb * 8)
        np.testing.assert_array_equal(dct_convert._plane_coefficients(padded, ones), ref)


def test_colour_conversion_is_jfif_ycbcr():
    """Greys map to (v, 128, 128) exactly; everything within one level of
    the JFIF formulas rounded."""
    grey = np.repeat(np.arange(256, dtype=np.uint8)[:, None, None], 3, axis=2)
    y, cb, cr = dct_convert.rgb_to_ycc(grey)
    np.testing.assert_array_equal(y[:, 0], np.arange(256))
    assert (cb == 128).all() and (cr == 128).all()
    rgb = make_image("random", 64, 64, seed=2).astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    want = (0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128)
    for got, ref in zip(dct_convert.rgb_to_ycc(rgb.astype(np.uint8)), want):
        assert np.abs(got - ref).max() <= 1.0


def test_islow_dct_is_the_float_dct_scaled_by_8():
    """Within 2 of 8 x the orthonormal DCT-II (measured: 1.3 over 2000
    random blocks); the DC term of a flat block exact."""
    x = np.random.default_rng(3).integers(-128, 128, (2000, 8, 8))
    k = np.arange(8)
    c = np.sqrt(2 / 8) * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    c[0] /= np.sqrt(2)
    ref = np.einsum("ij,bjk,lk->bil", c, x, c) * 8
    assert np.abs(dct_convert.fdct_islow(x) - ref).max() <= 2.0
    flat = np.full((1, 8, 8), -37)
    out = dct_convert.fdct_islow(flat)
    assert out[0, 0, 0] == -37 * 64 and (out.reshape(-1)[1:] == 0).all()


def test_downsample_bias_alternates_one_two_along_a_row():
    plane = np.array([[0, 1, 0, 1, 0, 1], [0, 0, 0, 0, 0, 0],
                      [1, 1, 1, 1, 1, 1], [0, 1, 0, 0, 0, 0]], np.int64)
    # sums 1, 1, 1 / 3, 2, 2; + bias 1, 2, 1; >> 2
    np.testing.assert_array_equal(dct_convert.downsample_h2v2(plane, 3), [[0, 0, 0], [1, 1, 0]])


def test_quantizer_rounds_half_away_from_zero():
    table = np.array([2, 3], np.int64)  # divisors 16 and 24
    x = np.array([[8, 12], [-8, -12], [7, 11], [-7, -11], [24, -36], [0, 0]])
    np.testing.assert_array_equal(dct_convert.quantize(x, table),
                                  [[1, 1], [-1, -1], [0, 0], [0, 0], [2, -2], [0, 0]])


def test_codec_digest_is_pinned():
    """The digest that the card's test (`test_torch_cuda.py`) holds the
    NumPy codec to is the libjpeg path's."""
    assert codec_digest(rgb_to_dct_tensors) == CODEC_DIGEST
    assert codec_digest(rgb_to_dct_tensors_numpy) == CODEC_DIGEST


def test_numpy_codec_refuses_what_it_does_not_encode():
    image = make_image("random", 16, 16)
    for subsampling in (0, 1):
        with pytest.raises(ValueError, match="4:2:0 only"):
            rgb_to_dct_tensors(image, subsampling=subsampling, codec="numpy")
    with pytest.raises(ValueError, match="codec must be one of"):
        rgb_to_dct_tensors(image, codec="turbo")
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        rgb_to_dct_tensors_numpy(image[..., 0])
    with pytest.raises(ValueError, match="needs codec='libjpeg'"):
        data.DetectionPipeline([], 1, train=False, input_format="dct_image", codec="numpy")
    with pytest.raises(ValueError, match="codec must be one of"):
        packed.PackedDctDataset.create_classification([], "unused", codec="turbo")


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    write_voc_tree(root, n_images=5, seed=8, image_set="trainval.txt")
    return data.DetectionDataset.from_voc(
        str(root / "JPEGImages"), str(root / "ImageSets" / "Main" / "trainval.txt"),
        str(root / "Annotations"))


def batches(pipe):
    return [{k: v for k, v in b.items() if k != "inverters"} for b in pipe]


@pytest.mark.parametrize("input_format", ["dct", "dct_deconv"])
def test_evaluation_batches_equal_the_libjpeg_paths(voc, input_format):
    """`DetectionPipeline(train=False)`: the held-out batches of the proxy."""
    got, ref = (batches(data.DetectionPipeline(voc, 2, train=False, encoder=None, num_workers=2,
                                               input_format=input_format, codec=codec))
                for codec in ("numpy", "libjpeg"))
    assert len(ref) == 3
    assert_same(got, ref)


def test_training_batches_equal_the_libjpeg_paths(voc):
    """The host SSD chain (the proxy's `host` variant) re-encodes every view:
    the same seed gives the same batches from either codec."""
    encoder = TargetEncoder(AnchorSpec(), ssd_predictor_sizes("resnet_custom"), device="cpu")
    got, ref = (batches(data.DetectionPipeline(voc, 2, train=True, encoder=encoder, seed=4,
                                               augmentation=SSDDataAugmentation(), num_workers=2,
                                               device_encode=True, codec=codec))
                for codec in ("numpy", "libjpeg"))
    assert len(ref) == 2
    assert_same(got, ref)


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("folder")
    for i in range(5):
        d = root / f"class_{i % 2}"
        d.mkdir(exist_ok=True)
        Image.fromarray(make_image("smooth", 200 + 7 * i, 260 - 9 * i, seed=i)).save(d / f"{i}.JPEG")
    return data.ImageFolderDataset(str(root))


@pytest.mark.parametrize("train", [False, True])
def test_classification_batches_equal_the_libjpeg_paths(image_folder, train):
    got, ref = (batches(data.ClassificationPipeline(image_folder, 2, train=train, seed=1,
                                                    num_workers=2, codec=codec))
                for codec in ("numpy", "libjpeg"))
    assert len(ref) == 2 + (not train)
    assert_same(got, ref)


def corpus_bytes(stem):
    return {e: open(stem + e, "rb").read() for e in (".y.npy", ".cbcr.npy", ".meta.json")} | {
        k: v for k, v in np.load(stem + ".labels.npz").items()}


def test_numpy_packed_corpus_equals_the_python_paths(voc, tmp_path):
    """`create(codec="numpy")` never calls libjpeg's encoder and writes what
    the Python path (PIL decode, cv2 resize, libjpeg) writes."""
    kw = dict(img_height=96, img_width=128, max_gt=6, num_workers=2)
    packed.PackedDctDataset.create(voc, str(tmp_path / "np"), codec="numpy", **kw)
    packed.PackedDctDataset.create(voc, str(tmp_path / "lj"), use_native=False, **kw)
    assert_same(corpus_bytes(str(tmp_path / "np")), corpus_bytes(str(tmp_path / "lj")))


def test_numpy_classification_corpus_equals_libjpegs(image_folder, tmp_path):
    for codec in ("numpy", "libjpeg"):
        packed.load_or_create(str(tmp_path / codec), image_folder, task="classification",
                              img_size=64, num_workers=2, verbose=False, codec=codec)
    assert_same(corpus_bytes(str(tmp_path / "numpy")), corpus_bytes(str(tmp_path / "libjpeg")))

