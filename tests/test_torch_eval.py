"""Port parity: mAP evaluation and result writers, JAX package vs PyTorch
port (CPU).

The matching and AP code is NumPy in both packages: every count, precision,
recall and AP must agree to 1e-12, and the written files byte for byte.  The
evaluator runs over the same pipeline with the same detections on both
sides; the port's infer function returns a torch tensor.
"""

import os

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu import data as jax_data
from jpeg_detection_resnet_ssd_tpu.eval import coco_writer as jax_coco_writer
from jpeg_detection_resnet_ssd_tpu.eval import map_eval as jax_map_eval
from jpeg_detection_resnet_ssd_tpu.eval import voc_writer as jax_voc_writer
from jpeg_detection_resnet_ssd_torch import data
from jpeg_detection_resnet_ssd_torch.eval import coco_writer, map_eval, voc_writer

from torch_cases import write_voc_tree

torch.set_num_threads(1)

N_CLASSES = 20
TOL = dict(rtol=0, atol=1e-12)


def seeded_eval_case(seed=0, n_images=6):
    """GT {image_id: (boxes (k, 5) float64, difficult (k,) bool)} with some
    difficult boxes, and per-class predictions: jittered copies of GT boxes
    (hits, near misses, duplicates) plus random boxes, with tied scores."""
    rng = np.random.default_rng(seed)
    gt, preds = {}, [[] for _ in range(N_CLASSES + 1)]
    for i in range(n_images):
        image_id = f"im{i:03d}"
        k = int(rng.integers(1, 7))
        cls = rng.choice([1, 3, 7, 12, 15], k)
        xy0 = rng.uniform(0, 200, (k, 2))
        xy1 = xy0 + rng.uniform(4, 120, (k, 2))
        boxes = np.concatenate([cls[:, None], np.round(xy0), np.round(xy1)], 1).astype(np.float64)
        gt[image_id] = (boxes, rng.random(k) < 0.25)
        for b in boxes:
            for _ in range(int(rng.integers(0, 3))):
                jit = b[1:] + rng.normal(0, rng.choice([0.5, 6.0, 20.0]), 4)
                score = float(rng.choice([0.9, 0.5, rng.uniform(0.01, 1)]))
                preds[int(b[0])].append((image_id, score, *map(float, jit)))
        for _ in range(3):
            xy = rng.uniform(0, 250, 2)
            preds[int(rng.integers(1, N_CLASSES + 1))].append(
                (image_id, float(rng.uniform(0, 1)), *map(float, xy), *map(float, xy + 30)))
    preds[2].append(("not_in_gt", 0.7, 1.0, 2.0, 30.0, 40.0))
    return gt, preds


@pytest.mark.parametrize("border", ["include", "half", "exclude"])
@pytest.mark.parametrize("intersection_border", [None, "half"])
def test_iou_one_to_many_matches_jax(border, intersection_border):
    rng = np.random.default_rng(1)
    box = np.array([10.0, 20.0, 60.0, 90.0])
    boxes = np.concatenate([rng.uniform(0, 80, (9, 2)), rng.uniform(40, 160, (9, 2))], 1)
    boxes[0] = [70.0, 20.0, 90.0, 40.0]  # no overlap
    got = map_eval._iou_one_to_many(box, boxes, border, intersection_border)
    ref = jax_map_eval._iou_one_to_many(box, boxes, border, intersection_border)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ignore_neutral", [True, False])
def test_num_gt_per_class_matches_jax(seed, ignore_neutral):
    gt, _ = seeded_eval_case(seed)
    got = map_eval.num_gt_per_class(gt, N_CLASSES, ignore_neutral)
    np.testing.assert_array_equal(got, jax_map_eval.num_gt_per_class(gt, N_CLASSES, ignore_neutral))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    {},
    {"intersection_border": "half"},
    {"border_pixels": "half", "matching_iou_threshold": 0.3},
    {"ignore_neutral": False},
])
def test_matching_pr_and_ap_match_jax(seed, kw):
    gt, preds = seeded_eval_case(seed)
    got = map_eval.match_predictions(preds, gt, N_CLASSES, **kw)
    ref = jax_map_eval.match_predictions(preds, gt, N_CLASSES, **kw)
    n_gt = jax_map_eval.num_gt_per_class(gt, N_CLASSES, kw.get("ignore_neutral", True))
    assert sum(int(t[-1]) for t in ref[0][1:] if len(t)) > 0  # true positives exist
    for c in range(N_CLASSES + 1):
        np.testing.assert_array_equal(got[0][c], ref[0][c])
        np.testing.assert_array_equal(got[1][c], ref[1][c])
        if c == 0:
            continue
        prec, rec = map_eval.precision_recall(got[0][c], got[1][c], int(n_gt[c]))
        prec_ref, rec_ref = jax_map_eval.precision_recall(ref[0][c], ref[1][c], int(n_gt[c]))
        np.testing.assert_allclose(prec, prec_ref, **TOL)
        np.testing.assert_allclose(rec, rec_ref, **TOL)
        for mode, points in (("integrate", 11), ("sample", 11), ("sample", 40)):
            ap = map_eval.average_precision(prec, rec, mode, points)
            np.testing.assert_allclose(
                ap, jax_map_eval.average_precision(prec_ref, rec_ref, mode, points), **TOL)


def test_average_precision_edge_cases_match_jax():
    for prec, rec in (([], []), ([1.0], [0.5]), ([1.0, 0.5, 2 / 3], [0.25, 0.25, 0.5])):
        for mode in ("integrate", "sample"):
            assert map_eval.average_precision(prec, rec, mode) == \
                jax_map_eval.average_precision(prec, rec, mode)
    with pytest.raises(ValueError, match="AP mode"):
        map_eval.average_precision([1.0], [1.0], "mean")


def test_voc_files_are_byte_identical(tmp_path):
    _, preds = seeded_eval_case(3)
    paths = voc_writer.write_voc_detection_files(preds, str(tmp_path / "port"))
    ref_paths = jax_voc_writer.write_voc_detection_files(preds, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in ref_paths]
    for p, r in zip(paths, ref_paths):
        assert open(p, "rb").read() == open(r, "rb").read()
    got = voc_writer.read_voc_detection_files(str(tmp_path / "jax"))
    assert got == jax_voc_writer.read_voc_detection_files(str(tmp_path / "port"))
    assert sum(map(len, got)) == sum(map(len, preds))


@pytest.mark.parametrize("cat_map", [None, {c: 100 + c for c in range(1, 21)}])
def test_coco_files_are_byte_identical(tmp_path, cat_map):
    _, preds = seeded_eval_case(4)
    preds[5].append(("17", 0.25, 1.0, 2.0, 3.5, 4.25))  # an integer image id
    got = coco_writer.detections_to_coco_json(preds, str(tmp_path / "port.json"), cat_map)
    ref = jax_coco_writer.detections_to_coco_json(preds, str(tmp_path / "jax.json"), cat_map)
    assert got == ref
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    write_voc_tree(root, n_images=5, seed=5)
    return (str(root / "JPEGImages"), str(root / "ImageSets" / "Main" / "test.txt"),
            str(root / "Annotations"))


def _seeded_infer(as_tensor):
    """Per-batch detections (B, 12, 6) in the 300x300 frame from a seed:
    rows with class, score (some 0: padding) and boxes."""
    rng = np.random.default_rng(9)
    table = []
    for _ in range(3):
        out = np.zeros((2, 12, 6), np.float32)
        out[..., 0] = rng.integers(1, N_CLASSES + 1, (2, 12))
        out[..., 1] = np.where(rng.random((2, 12)) < 0.8, rng.uniform(0, 1, (2, 12)), 0.0)
        xy = rng.uniform(0, 250, (2, 12, 2))
        out[..., 2:4] = xy
        out[..., 4:6] = xy + rng.uniform(5, 120, (2, 12, 2))
        table.append(out)
    calls = iter(table)

    def infer(inputs):
        out = next(calls)[: len(inputs[0])]
        return torch.from_numpy(out) if as_tensor else out

    return infer


@pytest.mark.parametrize("kw", [{}, {"average_precision_mode": "sample", "intersection_border": "half"}])
def test_evaluator_matches_jax(voc, kw):
    ev = map_eval.DetectionEvaluator(
        _seeded_infer(True), data.DetectionPipeline(
            data.DetectionDataset.from_voc(*voc), 2, train=False, encoder=None, num_workers=2),
        n_classes=N_CLASSES)
    ref = jax_map_eval.DetectionEvaluator(
        _seeded_infer(False), jax_data.DetectionPipeline(
            jax_data.DetectionDataset.from_voc(*voc), 2, train=False, encoder=None, num_workers=2),
        n_classes=N_CLASSES)
    mean_ap, aps, prs = ev(**kw)
    ref_map, ref_aps, ref_prs = ref(**kw)
    assert ev.prediction_results == ref.prediction_results
    assert sum(map(len, ev.prediction_results)) > 20
    assert ev.ground_truth.keys() == ref.ground_truth.keys()
    for k in ref.ground_truth:
        for a, b in zip(ev.ground_truth[k], ref.ground_truth[k]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(mean_ap, ref_map, **TOL)
    np.testing.assert_allclose(aps, ref_aps, **TOL)
    for (p, r), (p_ref, r_ref) in zip(prs[1:], ref_prs[1:]):
        np.testing.assert_allclose(p, p_ref, **TOL)
        np.testing.assert_allclose(r, r_ref, **TOL)


def test_evaluator_perfect_detector(tmp_path):
    """The JAX package's perfect-detector case: GT boxes returned as
    detections (in the resized frame) give AP 1 for the classes present."""
    root = tmp_path / "voc"
    for sub in ("JPEGImages", "Annotations", "ImageSets"):
        (root / sub).mkdir(parents=True)
    from PIL import Image

    rng = np.random.default_rng(0)
    ids, gt_boxes = [], {}
    for i in range(3):
        image_id = f"00000{i}"
        ids.append(image_id)
        Image.fromarray(rng.integers(0, 255, (200, 300, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{image_id}.jpg")
        boxes = [[3, 30 + i * 5, 40, 130 + i * 5, 140], [7, 150, 20, 280, 120]]
        gt_boxes[image_id] = np.array(boxes, float)
        objs = "".join(
            f"<object><name>{'bird' if b[0] == 3 else 'car'}</name><difficult>0</difficult>"
            f"<bndbox><xmin>{b[1]}</xmin><ymin>{b[2]}</ymin><xmax>{b[3]}</xmax>"
            f"<ymax>{b[4]}</ymax></bndbox></object>" for b in boxes)
        (root / "Annotations" / f"{image_id}.xml").write_text(f"<annotation>{objs}</annotation>")
    (root / "ImageSets" / "test.txt").write_text("\n".join(ids) + "\n")
    ds = data.DetectionDataset.from_voc(
        str(root / "JPEGImages"), str(root / "ImageSets" / "test.txt"), str(root / "Annotations"))
    pipe = data.DetectionPipeline(ds, batch_size=3, train=False, encoder=None, num_workers=2)

    def perfect_infer(inputs):
        out = torch.zeros(3, 10, 6)
        for i, image_id in enumerate(ids):
            for j, b in enumerate(gt_boxes[image_id]):
                # original 300x200 -> resized 300x300: x scale 1, y scale 1.5
                out[i, j] = torch.tensor([b[0], 0.9, b[1], b[2] * 1.5, b[3], b[4] * 1.5])
        return out

    mean_ap, aps, _ = map_eval.DetectionEvaluator(perfect_infer, pipe, n_classes=20)(
        average_precision_mode="sample")
    assert aps[3] == pytest.approx(1.0, abs=1e-6)  # bird
    assert aps[7] == pytest.approx(1.0, abs=1e-6)  # car
    assert mean_ap == pytest.approx(2.0 / 20.0, abs=1e-6)
