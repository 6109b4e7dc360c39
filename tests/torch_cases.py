"""Seeded inputs shared by the PyTorch-port tests: NumPy and the port only
(no jax), so the card-only tests in `test_torch_cuda.py` can use them on a
machine without JAX."""

from pathlib import Path

import numpy as np

from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
from jpeg_detection_resnet_ssd_torch.data.datasets import VOC_CLASSES
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
from jpeg_detection_resnet_ssd_torch.ops.jpeg_quant import quant_tables

N_CLASSES = 20
GOLDEN_JPEG = Path(__file__).resolve().parent / "data" / "golden.jpg"
BORDERS = {"half": 0.0, "include": 1.0, "exclude": -1.0}


def nms_problems(rng, n, k, at_threshold=True):
    """N sorted NMS problems: clustered boxes (so suppression happens), padded
    zero-score tails, exact-tie scores, and IoU-exactly-at-threshold pairs."""
    centers = rng.uniform(20, 280, (n, 4, 2))
    pick = rng.integers(0, 4, (n, k))
    xy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 12, (n, k, 2))
    wh = rng.uniform(10, 60, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.01, 1, (n, k)), axis=1)[:, ::-1].astype(np.float32)
    scores[:, : k // 8] = 1.0  # exact ties at the top, as a saturated head gives
    scores[:, -(k // 5 + 1):] = 0.0  # padded slots
    if at_threshold and k >= 4:
        # inter 9, union 20 (area 20 box containing an area 9 box): IoU is
        # 9/20, the f32 nearest 0.45 -- NOT above the threshold 0.45.
        boxes[:, 0] = [100.0, 100.0, 120.0, 101.0]
        boxes[:, 1] = [100.0, 100.0, 109.0, 101.0]
        # one ulp more inter: just above the threshold
        boxes[:, 2] = [200.0, 200.0, 220.0, 201.0]
        boxes[:, 3] = [200.0, 200.0, np.nextafter(np.float32(209.0), np.float32(300.0)), 201.0]
    return np.ascontiguousarray(boxes), np.ascontiguousarray(scores)


def raw_predictions(seed=0, batch=2):
    """(B, 8732, 33) softmax scores, offsets, SSD300 anchors and variances.

    A third of the rows are saturated: one positive class at exactly 1.0 and
    every other class at 0.0, so the top-k selections see many exact ties."""
    rng = np.random.default_rng(seed)
    anchors = build_anchors(AnchorSpec(), ssd_predictor_sizes("resnet_custom"))
    n = anchors.shape[0]
    logits = rng.normal(0, 2.5, (batch, n, N_CLASSES + 1))
    logits[..., 0] += 2.0  # background-leaning, as a detector mostly is
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    saturated = rng.random((batch, n)) < 1 / 3
    cls = rng.integers(1, N_CLASSES + 1, (batch, n))
    onehot = np.eye(N_CLASSES + 1)[cls]
    probs = np.where(saturated[..., None], onehot, probs)
    offsets = rng.normal(0, 1, (batch, n, 4))
    y = np.concatenate(
        [probs, offsets, np.broadcast_to(anchors, (batch, n, 8))], axis=-1
    ).astype(np.float32)
    return np.ascontiguousarray(y)


def gt_batch(rng, n_valid, max_gt=64, img=300):
    """Padded GT `(B, max_gt, 5)` float32 rows (class, xmin, ymin, xmax, ymax)
    in pixels and a `(B, max_gt)` mask, `n_valid[i]` boxes in image i.  The
    second box of an image repeats the first (so matching meets exact ties)
    and a third is a few pixels wide."""
    gt = np.zeros((len(n_valid), max_gt, 5), np.float32)
    mask = np.zeros((len(n_valid), max_gt), bool)
    for i, k in enumerate(n_valid):
        xy0 = rng.uniform(0, img - 60, (k, 2))
        xy1 = np.minimum(xy0 + rng.uniform(8, 220, (k, 2)), img)
        rows = np.concatenate([rng.integers(1, N_CLASSES + 1, (k, 1)), xy0, xy1], -1)
        if k >= 2:
            rows[1] = rows[0]
        if k >= 3:
            rows[2, 3:] = rows[2, 1:3] + 3.0
        gt[i, :k] = rows
        mask[i, :k] = True
    return gt, mask


def tie_sims(rng, shape):
    """Similarities on a coarse grid in [-0.25, 1): many exact ties, some
    rows below zero everywhere (never matched)."""
    sims = rng.integers(-4, 16, shape).astype(np.float32) / 16
    sims[:, -3:] = -1.0
    return sims


def augment_source(b=4, h8=12, seed=0):
    """A small augmentation batch: (B, h8, h8, 64) / (B, h8/2, h8/2, 128)
    planes and padded GT in source pixels: three boxes per image, one
    hugging the right edge in image 2, one masked out in image 1, and an
    image (the last) without valid GT."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0, 100, (b, h8, h8, 64)).astype(np.float32)
    cbcr = rng.normal(0, 30, (b, h8 // 2, h8 // 2, 128)).astype(np.float32)
    s = h8 * 8 / 96.0
    gt = np.zeros((b, 6, 5), np.float32)
    gt[:, 0] = [3, 10 * s, 12 * s, 60 * s, 70 * s]
    gt[:, 1] = [5, 40 * s, 20 * s, 90 * s, 80 * s]
    gt[:, 2] = [1, 3 * s, 3 * s, 30 * s, 25 * s]
    gt[2, 3] = [7, 80 * s, 2 * s, 95 * s, 94 * s]
    mask = np.zeros((b, 6), bool)
    mask[:, :3] = True
    mask[2, 3] = True
    mask[1, 2] = False
    mask[-1] = False
    return {"inputs": (y, cbcr), "gt": gt, "gt_mask": mask}


def assert_augment_matches(got, ref, rtol=1e-5, quality=None):
    """got, ref: (y, cbcr, gt, gt_mask) as arrays or CPU tensors.  Masks
    exactly equal, boxes within 1e-3 px, coefficients within `rtol` of the
    largest reference value; after requantization at `quality`, at most
    1e-4 of the coefficients differ, each by exactly one quantizer step (a
    value at a rounding tie)."""
    got = [np.asarray(t) for t in got]
    ref = [np.asarray(t) for t in ref]
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-3)
    if quality is not None:
        qy, qc = quant_tables(quality)
        steps = (qy.astype(np.float32), np.concatenate([qc, qc]).astype(np.float32))
    for i, (a, b) in enumerate(zip(got[:2], ref[:2])):
        assert a.shape == b.shape
        if quality is None:
            err = np.abs(a - b).max()
            assert err <= rtol * np.abs(b).max(), (i, err, np.abs(b).max())
            continue
        diff = a != b
        assert diff.sum() <= 1e-4 * a.size, (i, int(diff.sum()))
        q = np.broadcast_to(steps[i], a.shape)
        np.testing.assert_allclose(np.abs(a - b)[diff], q[diff], rtol=1e-6)


def write_voc_tree(root, n_images=4, seed=0, image_set="test.txt"):
    """A seeded Pascal-VOC tree under `root` (JPEGImages/, Annotations/,
    ImageSets/Main/<image_set>): images of varied sizes with smooth content
    written by PIL, 1-4 objects each, some 'difficult' or 'truncated', one
    of an unknown class.  Returns the image ids in set-file order."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (Path(root) / sub).mkdir(parents=True, exist_ok=True)
    ids = []
    for i in range(n_images):
        image_id = f"{seed:02d}{i:04d}"
        ids.append(image_id)
        h, w = int(rng.integers(150, 330)), int(rng.integers(150, 400))
        yy, xx = np.mgrid[0:h, 0:w]
        base = 100 + 60 * np.sin(xx / rng.uniform(6, 20)) + 0.3 * yy
        arr = np.stack([base, 0.7 * base + 30, 255 - base], -1) + rng.normal(0, 10, (h, w, 3))
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            Path(root) / "JPEGImages" / f"{image_id}.jpg", "jpeg")
        objs = []
        for j in range(int(rng.integers(1, 5))):
            x0, y0 = rng.integers(0, w - 40), rng.integers(0, h - 40)
            x1, y1 = x0 + rng.integers(20, w - x0), y0 + rng.integers(20, h - y0)
            name = "unicorn" if (i, j) == (1, 1) else VOC_CLASSES[int(rng.integers(0, 20))]
            objs.append(
                f"<object><name>{name}</name><difficult>{int(rng.random() < 0.25)}</difficult>"
                f"<truncated>{int(rng.random() < 0.25)}</truncated><bndbox><xmin>{x0}</xmin>"
                f"<ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>")
        (Path(root) / "Annotations" / f"{image_id}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height><depth>3</depth></size>"
            + "".join(objs) + "</annotation>")
    (Path(root) / "ImageSets" / "Main" / image_set).write_text("\n".join(ids) + "\n")
    return ids


def assert_same(got, ref):
    """Equal nested records/batches: arrays identical in dtype, shape and
    value; everything else ==."""
    if isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert_same(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_same(g, r)
    else:
        assert got == ref


def codec_images(seed=14):
    """Seeded RGB images for the NumPy codec's pinned digest: noise and a
    smooth gradient at the evaluation size, the packed frame and an odd
    one."""
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in ((300, 300), (352, 352), (203, 317))]
    yy, xx = np.mgrid[0:300, 0:300]
    images.append(np.stack([yy * 255 // 299, xx * 255 // 299, (yy + 2 * xx) % 256], -1).astype(np.uint8))
    return images


def codec_digest(encode, qualities=(75, 92, 50)):
    """SHA-256 over `encode(image, quality)`'s (Y, CbCr) bytes for every
    `codec_images()` image at each quality."""
    import hashlib

    h = hashlib.sha256()
    for image in codec_images():
        for q in qualities:
            for a in encode(image, q):
                h.update(np.ascontiguousarray(a, np.int32).tobytes())
    return h.hexdigest()


# `codec_digest` of the libjpeg path (PIL + dctjpeg) where libjpeg is
# installed, which the NumPy codec must reproduce anywhere (tests/test_torch_numpy_codec.py,
# tests/test_torch_cuda.py).
CODEC_DIGEST = "cdd5a2ae7a55dbc4951aa644acb49b66999d117908f2226137227dbb7d876cb2"


def run_proxy_script(main, capsys, argv):
    """Run a proxy script's `main(argv)` in this process; returns its last
    printed line parsed as JSON."""
    import json

    main([str(a) for a in argv])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
