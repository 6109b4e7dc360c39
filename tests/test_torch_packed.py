"""Port parity: the packed DCT corpus (`data/packed.py`) and
`prefetch_to_device`, JAX package vs PyTorch port (CPU).

One libjpeg, one cv2 and one PIL serve both packages here, so the packed
files are identical, a corpus packed by either package loads in the other,
and the pipelines' batches are identical arrays.
"""

import json
import threading

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.data import packed as jax_packed
from jpeg_detection_resnet_ssd_torch import data
from jpeg_detection_resnet_ssd_torch.data import packed
from jpeg_detection_resnet_ssd_torch.data.pipeline import prefetch_to_device

from chip_smoke import write_detect_inputs
from torch_cases import assert_same, write_voc_tree

torch.set_num_threads(1)

FRAME = dict(img_height=96, img_width=128)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    write_voc_tree(root, n_images=7, seed=6)
    ds = data.DetectionDataset.from_voc(
        str(root / "JPEGImages"), str(root / "ImageSets" / "Main" / "test.txt"),
        str(root / "Annotations"))
    return root, ds


@pytest.fixture(scope="module")
def corpora(voc, tmp_path_factory):
    """The same dataset packed by each package (native path)."""
    _, ds = voc
    tmp = tmp_path_factory.mktemp("packed")
    port = packed.PackedDctDataset.create(ds, str(tmp / "port"), max_gt=6, num_workers=2, **FRAME)
    ref = jax_packed.PackedDctDataset.create(ds, str(tmp / "jax"), max_gt=6, num_workers=2,
                                             **FRAME)
    return port, ref


def corpus_files(stem):
    """Everything the corpus at `stem` holds, as loaded from its files."""
    labels = np.load(stem + ".labels.npz", allow_pickle=False)
    with open(stem + ".meta.json") as f:
        meta = json.load(f)
    return {
        "y": np.load(stem + ".y.npy"), "cbcr": np.load(stem + ".cbcr.npy"),
        **{k: labels[k] for k in labels.files}, "meta": meta,
    }


@pytest.mark.parametrize("use_native", [True, False])
def test_create_writes_the_files_jax_writes(voc, tmp_path, use_native):
    _, ds = voc
    kw = dict(max_gt=6, num_workers=2, use_native=use_native, **FRAME)
    packed.PackedDctDataset.create(ds, str(tmp_path / "port"), **kw)
    jax_packed.PackedDctDataset.create(ds, str(tmp_path / "jax"), **kw)
    got, ref = corpus_files(str(tmp_path / "port")), corpus_files(str(tmp_path / "jax"))
    assert_same(got, ref)
    assert got["y"].shape == (7, 12, 16, 64) and got["cbcr"].shape == (7, 6, 8, 128)
    assert got["y"].dtype == np.int16 and got["gt_mask"].any()
    assert sorted(got) == ["cbcr", "gt", "gt_mask", "image_ids", "meta", "y"]


def test_native_and_python_paths_give_the_same_boxes(voc, tmp_path):
    """Both paths rescale boxes as `aug.resize` does; their coefficients
    differ only by the resize's rounding (C++ vs cv2)."""
    _, ds = voc
    kw = dict(max_gt=6, num_workers=2, **FRAME)
    a = packed.PackedDctDataset.create(ds, str(tmp_path / "a"), use_native=True, **kw)
    b = packed.PackedDctDataset.create(ds, str(tmp_path / "b"), use_native=False, **kw)
    np.testing.assert_array_equal(a.gt, b.gt)
    np.testing.assert_array_equal(a.gt_mask, b.gt_mask)
    assert a.image_ids == b.image_ids


def loaded(ds):
    return {"meta": ds.meta, "y": np.asarray(ds.y), "cbcr": np.asarray(ds.cbcr), "gt": ds.gt,
            "gt_mask": ds.gt_mask, "labels": ds.labels, "image_ids": list(ds.image_ids),
            "len": len(ds)}


def test_corpora_load_in_either_package(corpora):
    port, ref = corpora
    for stem in (port.stem, ref.stem):
        assert_same(loaded(packed.PackedDctDataset(stem)), loaded(jax_packed.PackedDctDataset(stem)))
    assert_same(loaded(packed.PackedDctDataset(ref.stem)), loaded(port))
    assert port.labels is None and len(port) == 7


def test_a_numpy_written_corpus_loads_in_both_packages(tmp_path):
    """The VOC tree and corpus `chip_smoke.py` writes without JPEGs: both
    packages' `load_or_create` accept the corpus for the tree."""
    voc, stem = write_detect_inputs(str(tmp_path), n=5, side=64, seed=2)
    ds = data.DetectionDataset.from_voc(f"{voc}/JPEGImages", f"{voc}/ImageSets/Main/trainval.txt",
                                        f"{voc}/Annotations")
    port = packed.load_or_create(stem, ds, img_height=64, img_width=64)
    ref = jax_packed.load_or_create(stem, ds, img_height=64, img_width=64)
    assert_same(loaded(port), loaded(ref))
    for i in range(5):  # the corpus' GT is the tree's boxes scaled to the frame
        rec = ds[i]
        assert np.array_equal(port.gt[i][port.gt_mask[i]][:, 0], rec["boxes"][:, 0])
    assert_same(list(packed.PackedDctPipeline(port, 2, seed=1, ship_dtype="int16")),
                list(jax_packed.PackedDctPipeline(ref, 2, seed=1, ship_dtype="int16")))


@pytest.mark.parametrize("train,drop_last", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("ship_dtype", ["float32", "int16"])
def test_pipeline_batches_match_jax(corpora, train, drop_last, shard, ship_dtype):
    port, ref = corpora
    kw = dict(train=train, seed=3, shard_index=shard[0], shard_count=shard[1],
              drop_last=drop_last, ship_dtype=ship_dtype)
    got_pipe = packed.PackedDctPipeline(port, 2, **kw)
    ref_pipe = jax_packed.PackedDctPipeline(ref, 2, **kw)
    assert len(got_pipe) == len(ref_pipe)
    epochs = []
    for _ in range(2):
        got, want = list(got_pipe), list(ref_pipe)
        assert len(got) == len(got_pipe)
        assert_same(got, want)
        assert got[0]["inputs"][0].dtype == np.dtype(ship_dtype)
        epochs.append(np.concatenate([b["gt"][:, 0, 1] for b in got]))
    if train and shard[1] == 1:
        assert not np.array_equal(epochs[0], epochs[1])  # a new order each epoch


def test_load_or_create_packs_once_then_validates(voc, tmp_path):
    _, ds = voc
    stem = str(tmp_path / "sub" / "c")
    first = packed.load_or_create(stem, ds, num_workers=2, verbose=False, **FRAME)
    again = packed.load_or_create(stem, ds, num_workers=2, **FRAME)
    assert_same(loaded(again), loaded(first))
    assert_same(loaded(jax_packed.load_or_create(stem, ds, num_workers=2, **FRAME)), loaded(first))


@pytest.mark.parametrize("case", ["count", "frame"])
def test_load_or_create_raises_on_a_stale_cache_as_jax_does(voc, corpora, case):
    _, ds = voc
    port, _ = corpora
    kw = dict(FRAME)
    if case == "count":
        ds = ds.shard(0, 2)
    else:
        kw["img_height"] = 112
    messages = []
    for module in (packed, jax_packed):
        with pytest.raises(ValueError, match="stale cache" if case == "count" else "img_height") as e:
            module.load_or_create(port.stem, ds, **kw)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_load_or_create_names_the_classification_item(tmp_path):
    """`task="classification"` packs with `create_classification` once,
    then loads, and a stale frame size raises as in the JAX package."""
    from PIL import Image

    rng = np.random.default_rng(8)
    for c in ("a", "b"):
        (tmp_path / "imgs" / c).mkdir(parents=True)
        for j in range(2):
            Image.fromarray(rng.integers(0, 255, (40, 56, 3), dtype=np.uint8)).save(
                tmp_path / "imgs" / c / f"{j}.jpeg")
    ds = data.ImageFolderDataset(str(tmp_path / "imgs"))
    stem = str(tmp_path / "pack" / "cls")
    corpus = packed.load_or_create(stem, ds, task="classification", img_size=32, num_workers=2)
    assert corpus.meta["task"] == "classification" and list(corpus.labels) == [0, 0, 1, 1]
    assert corpus.y.shape == (4, 4, 4, 64) and corpus.cbcr.shape == (4, 2, 2, 128)
    again = packed.load_or_create(stem, ds, task="classification", img_size=32)
    np.testing.assert_array_equal(again.y, corpus.y)
    for module in (packed, jax_packed):
        with pytest.raises(ValueError, match="img_size"):
            module.load_or_create(stem, ds, task="classification", img_size=64)


def test_prefetch_yields_the_pipeline_batches_in_order(corpora):
    port, _ = corpora
    pipe = packed.PackedDctPipeline(port, 2, seed=1, ship_dtype="int16")
    want = list(packed.PackedDctPipeline(port, 2, seed=1, ship_dtype="int16"))
    before = threading.active_count()
    got = list(prefetch_to_device(pipe, size=1, device="cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for a, b in zip((*g["inputs"], g["gt"], g["gt_mask"]),
                        (*w["inputs"], w["gt"], w["gt_mask"])):
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            np.testing.assert_array_equal(a.numpy(), b)
    assert threading.active_count() == before  # the staging thread ended


def test_prefetch_passes_other_leaves_and_raises_the_iterators_error():
    def source():
        yield {"x": np.arange(3), "ids": ["a"], "n": 7}
        raise OSError("disk gone")

    stream = prefetch_to_device(source(), device="cpu")
    first = next(stream)
    assert torch.equal(first["x"], torch.arange(3)) and first["ids"] == ["a"] and first["n"] == 7
    with pytest.raises(OSError, match="disk gone"):
        next(stream)


def test_prefetch_stops_its_thread_when_the_consumer_stops():
    before = threading.active_count()
    stream = prefetch_to_device(({"x": np.full(2, i)} for i in range(1000)), size=2, device="cpu")
    assert int(next(stream)["x"][0]) == 0
    stream.close()
    assert threading.active_count() == before


def test_prefetch_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefetch_to_device(iter([]))
