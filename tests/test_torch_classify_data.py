"""The classification data side, JAX package vs PyTorch port (CPU): the
host helpers and views, `ClassificationPipeline`, `DeviceDCTAugmentedPipeline`,
the packed classification corpus and `ClassificationEvaluator`.

One libjpeg, one cv2 and one PIL serve both packages here, so images,
batches and packed files are identical arrays.  The device pipeline's
training crops are the port's own draws (a CPU generator seeded as the JAX
pipeline seeds its key), held to the crop-and-flip apply that
`test_torch_classify_augment.py` holds to JAX; its evaluation crop is
exact.  Top-1/top-5 are equal on logits with ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.data import ImageFolderDataset as JaxImageFolder
from jpeg_detection_resnet_ssd_tpu.data import augment as jax_aug
from jpeg_detection_resnet_ssd_tpu.data import packed as jax_packed
from jpeg_detection_resnet_ssd_tpu.data import pipeline as jax_pipeline
from jpeg_detection_resnet_ssd_tpu.eval import imagenet_eval as jax_eval
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_torch.data import (
    ClassificationPipeline,
    DeviceDCTAugmentedPipeline,
    ImageFolderDataset,
    augment,
    packed,
)
from jpeg_detection_resnet_ssd_torch.eval import ClassificationEvaluator, count_params, timed_runs
from jpeg_detection_resnet_ssd_torch.models import build_model
from jpeg_detection_resnet_ssd_torch.ops import dct_augment

from torch_cases import assert_same

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """3 class dirs x 3 JPEGs of mixed sizes (one PNG), ImageNet layout."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.default_rng(5)
    sizes = [(60, 90), (100, 70), (64, 64)]
    for c in ("c0", "c1", "c2"):
        (root / c).mkdir()
        for j, (h, w) in enumerate(sizes):
            img = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            img.save(root / c / (f"{j}.png" if (c, j) == ("c1", 2) else f"{j}.jpeg"))
    return str(root)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(9).integers(0, 255, (45, 70, 3), dtype=np.uint8)


@pytest.mark.parametrize("name,arg", [("saturation", 1.3), ("brightness", 0.6),
                                      ("contrast", 1.45), ("lighting", (0.3, -0.2, 0.5))])
def test_classification_photometric_helpers_match_jax(image, name, arg):
    core = f"cls_{name}_core"
    arg = np.asarray(arg) if isinstance(arg, tuple) else arg
    assert_same(getattr(augment, core)(image, arg), getattr(jax_aug, core)(image, arg))
    got = getattr(augment, f"cls_{name}")(image, np.random.default_rng(2))
    assert_same(got, getattr(jax_aug, f"cls_{name}")(image, np.random.default_rng(2)))
    np.testing.assert_array_equal(augment.grayscale(image), jax_aug.grayscale(image))


@pytest.mark.parametrize("seed", range(4))
def test_classification_views_match_jax(image, seed):
    got = augment.classification_train_view(image, np.random.default_rng(seed), size=32)
    ref = jax_aug.classification_train_view(image, np.random.default_rng(seed), size=32)
    assert got.shape == (32, 32, 3)
    assert_same(got, ref)
    assert_same(augment.classification_eval_view(image, 24), jax_aug.classification_eval_view(image, 24))


def test_image_folder_matches_jax(folder):
    ds, ref = ImageFolderDataset(folder), JaxImageFolder(folder)
    assert ds.samples == ref.samples and len(ds) == 9 and ds.num_classes == 3


def _batches(pipe):
    return list(iter(pipe))


@pytest.mark.parametrize("train,fmt", [(True, "dct"), (False, "dct"), (True, "dct_deconv"),
                                       (False, "rgb")])
def test_classification_pipeline_matches_jax(folder, train, fmt):
    kw = dict(train=train, input_format=fmt, image_size=48, seed=3, num_workers=2)
    got = ClassificationPipeline(ImageFolderDataset(folder), 4, **kw)
    ref = jax_pipeline.ClassificationPipeline(JaxImageFolder(folder), 4, **kw)
    assert len(got) == len(ref) == (2 if train else 3)
    for _ in range(2):  # two epochs: the shuffle moves with the epoch
        for g, r in zip(_batches(got), _batches(ref)):
            np.testing.assert_array_equal(g["labels"], r["labels"])
            assert g["labels"].dtype == np.int32
            gi = g["inputs"] if isinstance(g["inputs"], tuple) else (g["inputs"],)
            ri = r["inputs"] if isinstance(r["inputs"], tuple) else (r["inputs"],)
            for a, b in zip(gi, ri):
                assert_same(a, b)


def test_host_augment_off_keeps_training_order(folder):
    kw = dict(train=True, host_augment=False, image_size=48, seed=1, num_workers=2)
    got = _batches(ClassificationPipeline(ImageFolderDataset(folder), 4, **kw))
    ref = _batches(jax_pipeline.ClassificationPipeline(JaxImageFolder(folder), 4, **kw))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["labels"], r["labels"])
        assert_same(g["inputs"][0], r["inputs"][0])


def test_device_pipeline_evaluation_crop_matches_jax(folder):
    kw = dict(train=False, source_size=64, crop_blocks=4, num_workers=2)
    got = _batches(DeviceDCTAugmentedPipeline(ImageFolderDataset(folder), 3, device="cpu", **kw))
    ref = _batches(jax_pipeline.DeviceDCTAugmentedPipeline(JaxImageFolder(folder), 3, **kw))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["labels"], r["labels"])
        assert g["inputs"][0].shape == (3, 4, 4, 64) and g["inputs"][1].shape == (3, 2, 2, 128)
        for a, b in zip(g["inputs"], r["inputs"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_device_pipeline_training_batches(folder):
    """Step s crops and flips (and adjusts) the inner pipeline's planes with
    the draws of a generator seeded (seed << 20) ^ s."""
    ds = ImageFolderDataset(folder)
    pipe = DeviceDCTAugmentedPipeline(ds, 4, train=True, source_size=64, crop_blocks=4, seed=2,
                                      num_workers=2, device="cpu")
    inner = ClassificationPipeline(ds, 4, train=True, host_augment=False, image_size=64, seed=2,
                                   num_workers=2)
    for step, (got, src) in enumerate(zip(_batches(pipe), _batches(inner))):
        gen = torch.Generator().manual_seed((2 << 20) ^ step)
        y, cbcr = (torch.from_numpy(a) for a in src["inputs"])
        crop = dct_augment.sample_crop_flip(4, 8, 8, gen, 4)
        y, cbcr = dct_augment.dct_random_crop_flip_apply(y, cbcr, crop, 4, 2)
        y, cbcr = dct_augment.dct_random_photometric_apply(
            y, cbcr, dct_augment.sample_photometric(4, gen))
        assert torch.equal(got["inputs"][0], y) and torch.equal(got["inputs"][1], cbcr)
        np.testing.assert_array_equal(got["labels"], src["labels"])
    assert pipe._step == len(pipe) == 2


@pytest.fixture(scope="module")
def corpora(folder, tmp_path_factory):
    root = tmp_path_factory.mktemp("packs")
    port = packed.PackedDctDataset.create_classification(
        ImageFolderDataset(folder), str(root / "port"), img_size=48, num_workers=2)
    ref = jax_packed.PackedDctDataset.create_classification(
        JaxImageFolder(folder), str(root / "jax"), img_size=48, num_workers=2)
    return port, ref


@pytest.mark.parametrize("suffix", [".y.npy", ".cbcr.npy", ".labels.npz", ".meta.json"])
def test_create_classification_writes_jax_files(corpora, suffix):
    port, ref = corpora
    with open(port.stem + suffix, "rb") as a, open(ref.stem + suffix, "rb") as b:
        assert a.read() == b.read()


def test_a_jax_packed_classification_corpus_loads(corpora):
    port, ref = corpora
    loaded = packed.PackedDctDataset(ref.stem)
    assert loaded.meta == {"n": 9, "img_size": 48, "quality": 75, "task": "classification"}
    assert loaded.gt is None and loaded.labels.dtype == np.int32
    got = list(packed.PackedDctPipeline(loaded, 4, seed=5, ship_dtype="int16"))
    want = list(jax_packed.PackedDctPipeline(jax_packed.PackedDctDataset(ref.stem), 4, seed=5,
                                             ship_dtype="int16"))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"inputs", "labels"}
        np.testing.assert_array_equal(g["labels"], w["labels"])
        for a, b in zip(g["inputs"], w["inputs"]):
            assert_same(a, b)


def _tied_logits(inputs):
    """Deterministic logits with ties: 12 classes from the Y plane's means,
    rounded to 0.5."""
    y = np.asarray(inputs[0], np.float64)
    feats = y.reshape(len(y), -1, 12).mean(axis=1)
    return np.round(feats / 20.0) / 2.0


def test_classification_evaluator_matches_jax(folder):
    kw = dict(train=False, image_size=48, num_workers=2, drop_remainder=True)
    got = ClassificationEvaluator(
        lambda x: torch.from_numpy(_tied_logits(x)),
        ClassificationPipeline(ImageFolderDataset(folder), 2, **kw))()
    ref = jax_eval.ClassificationEvaluator(
        lambda x: jnp.asarray(_tied_logits(x)),
        jax_pipeline.ClassificationPipeline(JaxImageFolder(folder), 2, **kw))()
    assert got == ref and got["count"] == 8


def test_count_params_and_timed_runs():
    module, example = jax_build_model("resnet50_dct_y_cb4_cbcr_cb5", num_classes=10)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), example(), train=False))
    model, _ = build_model("resnet50_dct_y_cb4_cbcr_cb5", num_classes=10, device="cpu")
    assert count_params(model) == jax_eval.count_params(shapes["params"]) > 20_000_000
    runs = timed_runs(lambda a: a * 2, (torch.ones(3),), n_runs=3, warmup=1)
    assert runs["runs"] == 3 and runs["mean_s"] >= 0 and set(runs) == {"mean_s", "std_s", "runs"}
