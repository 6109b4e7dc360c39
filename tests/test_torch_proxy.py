"""The port's convergence proxies (`scripts/torch_*convergence_proxy.py`)
against the JAX package's scripts, on the CPU: the generated corpora, the
packed corpus from the NumPy codec, the pinned digest of `chip_smoke.py`
phase 9k's corpus, and the held-out evaluation on shared weights.

The JAX scripts are loaded by path with `scripts/` on `sys.path`, because
`cls_convergence_proxy.py` imports `_texture` from `convergence_proxy`.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import cls_convergence_proxy as jax_cls_proxy  # noqa: E402
import convergence_proxy as jax_proxy  # noqa: E402
import torch_cls_convergence_proxy as cls_proxy  # noqa: E402
import torch_convergence_proxy as proxy  # noqa: E402

from jpeg_detection_resnet_ssd_tpu import data as jax_data  # noqa: E402
from jpeg_detection_resnet_ssd_tpu.boxes import AnchorSpec as JaxAnchorSpec  # noqa: E402
from jpeg_detection_resnet_ssd_tpu.data import packed as jax_packed  # noqa: E402
from jpeg_detection_resnet_ssd_tpu.eval import DetectionEvaluator as JaxEvaluator  # noqa: E402
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model  # noqa: E402
from jpeg_detection_resnet_ssd_tpu.models import make_inference_fn as jax_inference_fn  # noqa: E402
from jpeg_detection_resnet_ssd_torch import data  # noqa: E402
from jpeg_detection_resnet_ssd_torch.data import packed  # noqa: E402

from chip_smoke import PROXY_CORPUS_SHA256, PROXY_TEST, PROXY_TRAIN, file_sha256  # noqa: E402
from torch_cases import assert_same  # noqa: E402
from torch_parity import port_module, random_flax_variables  # noqa: E402

torch.set_num_threads(1)


def tree_bytes(root):
    """{relative path: bytes} of every file under `root`."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def voc_split(root, image_set, module=data):
    return module.DetectionDataset.from_voc(f"{root}/JPEGImages", f"{root}/ImageSets/Main/{image_set}",
                                            f"{root}/Annotations")


def test_generate_corpus_writes_the_jax_scripts_files(tmp_path):
    """Same arguments, same JPEG bytes, XML and split files."""
    proxy.generate_corpus(str(tmp_path / "port"), n_train=4, n_test=2)
    jax_proxy.generate_corpus(str(tmp_path / "jax"), n_train=4, n_test=2)
    got, ref = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "jax")
    assert len(ref) == 6 * 2 + 2
    assert got == ref


def test_generate_corpus_keep_writes_the_full_corpus_first_images(tmp_path):
    """`keep=(k_train, k_test)` (phase 9k's corpus) writes the first images of
    each split of the full corpus, byte for byte."""
    proxy.generate_corpus(str(tmp_path / "full"), n_train=5, n_test=3)
    proxy.generate_corpus(str(tmp_path / "cut"), n_train=5, n_test=3, keep=(2, 1))
    full, cut = tree_bytes(tmp_path / "full"), tree_bytes(tmp_path / "cut")
    split_files = {"ImageSets/Main/trainval.txt": b"000000\n000001\n",
                   "ImageSets/Main/test.txt": b"000005\n"}
    assert {k: v for k, v in cut.items() if k not in split_files} == {
        f"{d}/{i:06d}.{e}": full[f"{d}/{i:06d}.{e}"]
        for i in (0, 1, 5) for d, e in (("JPEGImages", "jpg"), ("Annotations", "xml"))}
    assert {k: cut[k] for k in split_files} == split_files


def test_cls_generate_corpus_writes_the_jax_scripts_files(tmp_path):
    cls_proxy.generate_corpus(str(tmp_path / "port"), n_train=5, n_test=2)
    jax_cls_proxy.generate_corpus(str(tmp_path / "jax"), n_train=5, n_test=2)
    got, ref = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "jax")
    assert len(ref) == 7 and any(k.startswith("val/") for k in ref)
    assert got == ref


def corpus_files(stem):
    files = {e: Path(stem + e).read_bytes() for e in (".y.npy", ".cbcr.npy", ".meta.json")}
    return files | dict(np.load(stem + ".labels.npz").items())


def test_numpy_packed_corpus_equals_the_jax_packages(tmp_path):
    """The proxy's packed 352-px corpus: the port's `create(codec="numpy")`
    writes the files of the JAX package's `create` (its native libjpeg
    path), byte for byte."""
    voc_shapes = str(tmp_path / "voc")
    proxy.generate_corpus(voc_shapes, n_train=6, n_test=4)
    kw = dict(img_height=352, img_width=352, num_workers=2)
    packed.PackedDctDataset.create(voc_split(voc_shapes, "trainval.txt"), str(tmp_path / "port"),
                                   codec="numpy", **kw)
    jax_packed.PackedDctDataset.create(voc_split(voc_shapes, "trainval.txt", jax_data),
                                       str(tmp_path / "jax"), **kw)
    got, ref = corpus_files(str(tmp_path / "port")), corpus_files(str(tmp_path / "jax"))
    assert_same(got, ref)
    assert np.load(tmp_path / "port.y.npy").shape == (6, 44, 44, 64)


def test_numpy_classification_corpus_equals_the_jax_packages(tmp_path):
    """The classification proxy's packed corpus (`load_or_create`)."""
    cls_proxy.generate_corpus(str(tmp_path / "cls"), n_train=5, n_test=1)
    folder = str(tmp_path / "cls" / "train")
    packed.load_or_create(str(tmp_path / "port"), data.ImageFolderDataset(folder),
                          task="classification", img_size=128, num_workers=2, verbose=False,
                          codec="numpy")
    jax_packed.load_or_create(str(tmp_path / "jax"), jax_data.ImageFolderDataset(folder),
                              task="classification", img_size=128, num_workers=2, verbose=False)
    assert_same(corpus_files(str(tmp_path / "port")), corpus_files(str(tmp_path / "jax")))


@pytest.mark.parametrize("codec", ["libjpeg", "numpy"])
def test_phase_9k_corpus_digest_is_pinned(tmp_path, codec):
    """`chip_smoke.py` prints the card's digest of phase 9k's packed corpus
    beside the one pinned here from the libjpeg path; the NumPy codec
    gives the same files."""
    root = str(tmp_path / "voc")
    proxy.generate_corpus(root, keep=(PROXY_TRAIN, PROXY_TEST))
    stem = str(tmp_path / "packed")
    packed.PackedDctDataset.create(voc_split(root, "trainval.txt"), stem, img_height=proxy.PACK_SIDE,
                                   img_width=proxy.PACK_SIDE, num_workers=2, codec=codec)
    assert {ext: file_sha256(stem + ext) for ext in PROXY_CORPUS_SHA256} == PROXY_CORPUS_SHA256


def write_detections_as_gt(root, predictions, seed=0):
    """Rewrite the test split's annotations from a model's own detections
    (every third of each image's top two thirds, corners jittered by up to
    8 px), so that a random model's held-out mAP is neither 0 nor 1."""
    rng = np.random.default_rng(seed)
    per_image = {}
    for cls, rows in enumerate(predictions):
        for image_id, score, *box in rows:
            per_image.setdefault(image_id, []).append((score, cls, box))
    for image_id, dets in per_image.items():
        dets.sort(key=lambda d: -d[0])
        objs = []
        for _, cls, box in dets[: 2 * len(dets) // 3: 3]:
            x0, y0, x1, y1 = np.round(np.asarray(box) + rng.integers(-8, 9, 4)).astype(int)
            objs.append(f"<object><name>{proxy.VOC_CLASSES[cls - 1]}</name><difficult>0</difficult>"
                        f"<bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin><xmax>{max(x1, x0 + 2)}</xmax>"
                        f"<ymax>{max(y1, y0 + 2)}</ymax></bndbox></object>")
        Path(f"{root}/Annotations/{image_id}.xml").write_text(
            "<annotation><size><width>320</width><height>320</height><depth>3</depth></size>"
            + "".join(objs) + "</annotation>")


def test_heldout_evaluation_matches_jax(tmp_path):
    """The proxy's held-out evaluation: the JAX package's evaluator over the
    JAX model and the port's (`torch_convergence_proxy._selector_results`,
    NumPy codec) over the same float32 weights carried across by
    `compat/flax_bridge.py` give equal mAP (1e-6) and identical per-class
    APs, for both selectors.  The split's GT is the port's own jittered
    detections, so the APs are neither all 0 nor all 1."""
    jax_module, example = jax_build_model("ssd300_ssd_custom", n_classes=20)
    variables = random_flax_variables(jax_module, example(), train=False, seed=3)
    model = port_module("ssd300_ssd_custom", variables, n_classes=20)
    voc_shapes = str(tmp_path / "voc")
    proxy.generate_corpus(voc_shapes, n_train=6, n_test=4, keep=(0, 4))
    test_ds = voc_split(voc_shapes, "test.txt")
    first = proxy._selector_results(model, "dct", test_ds, "numpy", torch.device("cpu"))
    write_detections_as_gt(voc_shapes, first["exact"][2])
    got = proxy._selector_results(model, "dct", voc_split(voc_shapes, "test.txt"), "numpy",
                                  torch.device("cpu"))
    for selector in ("exact", "shared"):
        decode = jax_inference_fn(n_classes=20, spec=JaxAnchorSpec(), candidate_selector=selector)

        @jax.jit
        def infer(inputs, decode=decode):
            return decode(jax_module.apply(variables, inputs, train=False).astype(jax.numpy.float32))

        pipe = jax_data.DetectionPipeline(voc_split(voc_shapes, "test.txt", jax_data), 8,
                                          train=False, encoder=None, augmentation=None,
                                          num_workers=2)
        ref_map, ref_aps, _ = JaxEvaluator(infer, pipe, n_classes=20)()
        mean_ap, aps, predictions = got[selector]
        assert 0.05 < ref_map < 0.95 and sum(a > 0 for a in ref_aps) >= 3
        assert abs(mean_ap - ref_map) <= 1e-6
        assert aps == ref_aps
        assert sum(map(len, predictions)) > 100
