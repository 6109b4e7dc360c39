"""Port parity: datasets, resize, the input transform and the detection
pipeline, JAX package vs PyTorch port (CPU).

One libjpeg, one cv2 and one PIL serve both packages here, so records,
resized images, DCT tensors and batches must be identical: any difference is
a porting fault, not a tolerance.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from jpeg_detection_resnet_ssd_tpu import data as jax_data
from jpeg_detection_resnet_ssd_tpu.boxes import AnchorSpec as JaxAnchorSpec
from jpeg_detection_resnet_ssd_tpu.boxes import TargetEncoder as JaxTargetEncoder
from jpeg_detection_resnet_ssd_tpu.data import augment as jax_aug
from jpeg_detection_resnet_ssd_tpu.data import datasets as jax_datasets
from jpeg_detection_resnet_ssd_tpu.data import pipeline as jax_pipeline
from jpeg_detection_resnet_ssd_torch import data
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.data import augment, datasets, pipeline
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes

from torch_cases import assert_same, write_voc_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    ids = write_voc_tree(root, n_images=5, seed=3)
    paths = (str(root / "JPEGImages"), str(root / "ImageSets" / "Main" / "test.txt"),
             str(root / "Annotations"))
    return root, ids, paths


@pytest.mark.parametrize("kw", [{}, {"include_difficult": False}, {"exclude_truncated": True}])
def test_voc_parser_matches_jax(voc, kw):
    _, ids, paths = voc
    got = data.parse_voc_xml(*paths, **kw)
    assert_same(got, jax_data.parse_voc_xml(*paths, **kw))
    assert [r["image_id"] for r in got] == ids
    assert sum(len(r["boxes"]) for r in got) > 5


def test_csv_parser_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    rows = ["image_name,xmin,xmax,ymin,ymax,class_id"]
    for _ in range(12):
        x0, y0 = rng.integers(0, 200, 2)
        rows.append(f"img_{rng.integers(0, 4)}.jpg,{x0},{x0 + rng.integers(5, 90)},"
                    f"{y0},{y0 + rng.integers(5, 90)},{rng.integers(1, 21)}")
    csv_path = tmp_path / "labels.csv"
    csv_path.write_text("\n".join(rows) + "\n\n")
    got = data.parse_detection_csv(str(csv_path), str(tmp_path))
    assert_same(got, jax_data.parse_detection_csv(str(csv_path), str(tmp_path)))
    assert_same(datasets.DetectionDataset.from_csv(str(csv_path), str(tmp_path)).records, got)


@pytest.mark.parametrize("include_crowd", [False, True])
def test_coco_parser_matches_jax(tmp_path, include_crowd):
    rng = np.random.default_rng(1)
    coco = {
        "images": [{"id": i, "file_name": f"{i}.jpg", "width": 300, "height": 200}
                   for i in (9, 3, 14)],
        "categories": [{"id": c, "name": f"c{c}"} for c in (18, 3, 44)],
        "annotations": [
            {"image_id": int(rng.choice([9, 3])), "category_id": int(rng.choice([18, 3, 44])),
             "bbox": [float(v) for v in rng.uniform(0, 100, 4)], "iscrowd": int(rng.random() < 0.3)}
            for _ in range(10)
        ],
    }
    p = tmp_path / "instances.json"
    p.write_text(json.dumps(coco))
    got = data.parse_coco_json(str(p), str(tmp_path), include_crowd=include_crowd)
    assert_same(got, jax_data.parse_coco_json(str(p), str(tmp_path), include_crowd=include_crowd))
    assert got[1] == {18: 1, 3: 2, 44: 3}
    assert_same(datasets.DetectionDataset.from_coco(str(p), str(tmp_path),
                                                    include_crowd=include_crowd).records, got[0])


def test_image_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for wnid in ("n02", "n01", "n03"):
        (tmp_path / wnid).mkdir()
        for j in range(int(rng.integers(1, 4))):
            Image.fromarray(rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)).save(
                tmp_path / wnid / f"im{j}.jpg")
    (tmp_path / "n01" / "notes.txt").write_text("not an image")
    index = tmp_path / "index.json"
    index.write_text(json.dumps({"0": ["n03", "c"], "1": ["n01", "a"], "2": ["n02", "b"]}))
    for kw in ({}, {"class_index_json": str(index)}):
        got = data.ImageFolderDataset(str(tmp_path), **kw)
        ref = jax_data.ImageFolderDataset(str(tmp_path), **kw)
        assert got.samples == ref.samples and got.class_to_idx == ref.class_to_idx
        assert got.idx_to_name == ref.idx_to_name and got.num_classes == ref.num_classes
        assert got.shard(1, 2).samples == ref.shard(1, 2).samples


def test_dataset_save_load_and_shard(voc, tmp_path):
    _, _, paths = voc
    ds = data.DetectionDataset.from_voc(*paths)
    ref = jax_data.DetectionDataset.from_voc(*paths)
    assert_same(ds.records, ref.records)
    ds.save(str(tmp_path / "port.pkl"))
    ref.save(str(tmp_path / "jax.pkl"))
    assert_same(data.DetectionDataset.load(str(tmp_path / "port.pkl")).records, ref.records)
    assert_same(data.DetectionDataset.load(str(tmp_path / "jax.pkl")).records, ref.records)
    assert (tmp_path / "port.pkl").read_bytes() == (tmp_path / "jax.pkl").read_bytes()
    assert_same(ds.shard(1, 3).records, ref.shard(1, 3).records)
    assert len(ds) == len(ref) and ds[2]["image_id"] == ref[2]["image_id"]


def test_hdf5_image_cache_matches_jax(voc, tmp_path):
    _, _, paths = voc
    ds = data.DetectionDataset.from_voc(*paths)
    port = datasets.Hdf5ImageCache.create(ds, str(tmp_path / "port.h5"))
    ref = jax_datasets.Hdf5ImageCache(str(tmp_path / "port.h5"))
    ref_made = jax_datasets.Hdf5ImageCache.create(ds, str(tmp_path / "jax.h5"))
    port_reads_jax = datasets.Hdf5ImageCache(str(tmp_path / "jax.h5"))
    try:
        assert len(port) == len(ref) == len(ds)
        for i in range(len(ds)):
            assert_same(port[i], ref[i])
            assert_same(port_reads_jax[i], ref_made[i])
        assert port[0]["image_bytes"] == open(ds[0]["image_path"], "rb").read()
        shard, ref_shard = port.shard(1, 2), ref.shard(1, 2)
        assert len(shard) == len(ref_shard) == 2
        assert_same([shard[i] for i in range(2)], [ref_shard[i] for i in range(2)])
    finally:
        for cache in (port, ref, ref_made, port_reads_jax):
            cache.close()


@pytest.mark.parametrize("shape", [(150, 100, 3), (333, 517, 3), (300, 300, 3), (97, 61)])
@pytest.mark.parametrize("filter_degenerate", [True, False])
def test_resize_and_inverter_match_jax(shape, filter_degenerate):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 255, shape, dtype=np.uint8)
    labels = np.concatenate(
        [rng.integers(1, 21, (6, 1)), rng.uniform(0, 60, (6, 2)), rng.uniform(0, 90, (6, 2))], 1
    ).astype(np.float32)  # some boxes inverted: degenerate
    got = augment.resize(img, labels, 300, 300, filter_degenerate=filter_degenerate,
                         return_inverter=True)
    ref = jax_aug.resize(img, labels, 300, 300, filter_degenerate=filter_degenerate,
                         return_inverter=True)
    assert_same(got[:2], ref[:2])
    preds = np.concatenate([rng.uniform(0, 1, (9, 2)), rng.uniform(0, 300, (9, 4))], 1)
    assert_same(got[2](preds), ref[2](preds))
    assert_same(augment.resize(img, None, 304, 200), jax_aug.resize(img, None, 304, 200))


def test_resize_interpolations_match_jax():
    import cv2

    img = np.random.default_rng(5).integers(0, 255, (120, 90, 3), dtype=np.uint8)
    for interp in (cv2.INTER_NEAREST, cv2.INTER_CUBIC, cv2.INTER_AREA, cv2.INTER_LANCZOS4):
        assert_same(augment.resize(img, None, 300, 300, interp)[0],
                    jax_aug.resize(img, None, 300, 300, interp)[0])


@pytest.mark.parametrize("shape", [(9, 7), (9, 7, 1), (9, 7, 3), (9, 7, 4)])
def test_to_3_channels_matches_jax(shape):
    img = np.random.default_rng(0).integers(0, 255, shape, dtype=np.uint8)
    assert_same(augment.to_3_channels(img), jax_aug.to_3_channels(img))


@pytest.mark.parametrize("fmt", ["dct", "dct_deconv", "rgb", "dct_image", "dct_255"])
def test_pack_inputs_matches_jax(fmt):
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 255, (48, 64, 3), dtype=np.uint8) for _ in range(3)]
    got = pipeline._pack_inputs(images, fmt)
    assert_same(got, jax_pipeline._pack_inputs(images, fmt))
    with pytest.raises(ValueError, match="unknown input_format"):
        pipeline._pack_inputs(images, "nope")


def test_dct_convert_matches_jax():
    img = np.random.default_rng(8).integers(0, 255, (300, 300, 3), dtype=np.uint8)
    y, cbcr = data.rgb_to_dct_tensors(img)
    assert y.shape == (38, 38, 64) and cbcr.shape == (19, 19, 128)
    assert_same((y, cbcr), jax_data.rgb_to_dct_tensors(img))
    assert_same(data.rgb_to_dct_tensors(img, quality=90, subsampling=0),
                jax_data.rgb_to_dct_tensors(img, quality=90, subsampling=0))
    assert_same(data.rgb_to_dct_image(img, crop_hw=(296, 280)),
                jax_data.rgb_to_dct_image(img, crop_hw=(296, 280)))
    assert_same(data.split_cbcr(cbcr), jax_data.split_cbcr(cbcr))


def _eval_batches(pipe):
    """The pipeline's batches with the inverters applied to seeded rows."""
    rows = np.random.default_rng(0).uniform(0, 300, (7, 6)).astype(np.float32)
    out = []
    for batch in pipe:
        batch = dict(batch)
        batch["inverters"] = [inv(rows) for inv in batch["inverters"]]
        out.append(batch)
    return out


@pytest.mark.parametrize("source", ["voc", "hdf5"])
def test_eval_pipeline_batches_match_jax(voc, tmp_path, source):
    _, ids, paths = voc
    ds = data.DetectionDataset.from_voc(*paths)
    cache = None
    if source == "hdf5":
        cache = ds = datasets.Hdf5ImageCache.create(ds, str(tmp_path / "c.h5"))
    try:
        kw = dict(train=False, encoder=None, num_workers=2)
        got = _eval_batches(data.DetectionPipeline(ds, 2, **kw))
        ref = _eval_batches(jax_data.DetectionPipeline(ds, 2, **kw))
    finally:
        if cache is not None:
            cache.close()
    assert len(got) == 3  # 5 images at batch 2, the last batch kept
    assert_same(got, ref)
    assert [i for b in got for i in b["image_ids"]] == ids
    assert got[0]["inputs"][0].shape == (2, 38, 38, 64)


def _flip_augmentation(image, labels, rng):
    """A seeded host augmentation: flip with probability 1/2, resize to 300."""
    if rng.random() < 0.5:
        image = image[:, ::-1].copy()
        labels = labels.copy()
        labels[:, [1, 3]] = image.shape[1] - labels[:, [3, 1]]
    image, labels = jax_aug.resize(image, labels, 300, 300, filter_degenerate=False)
    return image, labels


@pytest.mark.parametrize("augmentation", [None, _flip_augmentation])
def test_encoder_pipeline_batches_match_jax(voc, augmentation):
    _, _, paths = voc
    ds = data.DetectionDataset.from_voc(*paths)
    sizes = ssd_predictor_sizes("resnet_custom")
    kw = dict(train=True, augmentation=augmentation, device_encode=True, max_gt=8,
              num_workers=2, seed=11)
    port = data.DetectionPipeline(
        ds, 2, encoder=TargetEncoder(AnchorSpec(), sizes, device="cpu"), **kw)
    ref = jax_data.DetectionPipeline(ds, 2, encoder=JaxTargetEncoder(JaxAnchorSpec(), sizes), **kw)
    for _ in range(2):  # two epochs: two seeded orders
        got, want = list(port), list(ref)
        assert len(got) == 2  # training drops the remainder
        assert_same(got, want)
        assert got[0]["gt"].shape == (2, 8, 5) and got[0]["gt_mask"].any()


def test_encoder_pipeline_targets_match_jax(voc):
    """Without device_encode the batch carries the encoder's targets."""
    _, _, paths = voc
    ds = data.DetectionDataset.from_voc(*paths)
    sizes = ssd_predictor_sizes("resnet_custom")
    kw = dict(train=False, augmentation=None, num_workers=2)
    got = next(iter(data.DetectionPipeline(
        ds, 2, encoder=TargetEncoder(AnchorSpec(), sizes, device="cpu"), **kw)))
    ref = next(iter(jax_data.DetectionPipeline(
        ds, 2, encoder=JaxTargetEncoder(JaxAnchorSpec(), sizes), **kw)))
    assert_same(got["inputs"], ref["inputs"])
    assert isinstance(got["targets"], torch.Tensor)
    np.testing.assert_allclose(got["targets"].numpy(), np.asarray(ref["targets"]),
                               rtol=1e-5, atol=1e-5)


def test_default_training_augmentation_names_its_roadmap_item(voc):
    """The default training augmentation is the host SSD chain, built as the
    JAX package builds it (its draws are held to JAX's in
    `test_torch_host_augment.py`); evaluation has none."""
    _, _, paths = voc
    ds = data.DetectionDataset.from_voc(*paths)
    got = data.DetectionPipeline(ds, 2, train=True, img_height=320, img_width=288).augmentation
    ref = jax_data.DetectionPipeline(ds, 2, train=True, img_height=320, img_width=288).augmentation
    assert isinstance(got, augment.SSDDataAugmentation)
    assert isinstance(got.crop, augment.SSDRandomCrop) and isinstance(ref.crop, jax_aug.SSDRandomCrop)
    assert (got.resize.height, got.resize.width) == (ref.resize.height, ref.resize.width) == (320, 288)
    assert got.expand.background == ref.expand.background
    assert (got.flip.dim, got.flip.prob) == (ref.flip.dim, ref.flip.prob)
    assert data.DetectionPipeline(ds, 2, train=False).augmentation is None


def test_pipeline_epoch_order_and_item_generators_match_jax(voc):
    _, _, paths = voc
    ds = data.DetectionDataset.from_voc(*paths)
    port = data.DetectionPipeline(ds, 2, train=True, augmentation=None, seed=4, num_workers=1)
    ref = jax_data.DetectionPipeline(ds, 2, train=True, augmentation=None, seed=4, num_workers=1)
    for _ in range(3):
        np.testing.assert_array_equal(port._epoch_order(), ref._epoch_order())
        assert port._item_rng(3).random() == ref._item_rng(3).random()
    assert len(port) == len(ref) == 2


def test_voc_paths_are_the_parsers(voc):
    """The records point at the tree's JPEGs, which the pipeline opens."""
    root, ids, paths = voc
    rec = data.parse_voc_xml(*paths)[0]
    assert rec["image_path"] == os.path.join(str(root), "JPEGImages", ids[0] + ".jpg")
    assert os.path.exists(rec["image_path"])
