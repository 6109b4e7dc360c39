#!/usr/bin/env python
"""Held-out-mAP convergence proxy of the PyTorch port.

The port's counterpart of `scripts/convergence_proxy.py`, importing only
`jpeg_detection_resnet_ssd_torch`: the same generated 20-class detection
corpus (per-class silhouette, texture and colour on cluttered backgrounds,
disjoint train and test splits; the generator writes the same JPEG bytes
and XML as the JAX script's for the same arguments), trained with the
port's `fit` and scored with the `evaluate` protocol (exact decode) on the
held-out split, with both candidate selectors on the same weights.

Variants (--variant), as the JAX script's:
  host      : host Caffe-SSD augmentation chain (SSDDataAugmentation)
  device    : packed 352-px corpus + the v2 DCT-domain chain in the step
  device_v3 : packed corpus + the v3 chain (continuous expand/crop/resize)
  device_v4 : v3 with the pixel-space HSV photometric leg
  device_v5 : v4 + per-view JPEG requantization at quality 75
  none      : resize only (the augmentation ablation)
  rgb       : host chain + the RGB VGG16-SSD300 (`ssd300_vgg`)

`--codec numpy` computes every DCT plane (packed corpus, host batches,
held-out batches) with the NumPy copy of libjpeg's encoder
(`data/dct_convert.py`), bit-exact with the libjpeg path, for machines
without libjpeg.  Nothing chooses it for you.

Usage:
  python scripts/torch_convergence_proxy.py --variant device_v3 --steps 2000 \\
      --seed 0 --codec numpy                          # on a card
  python scripts/torch_convergence_proxy.py --variant device_v3 --steps 2 \\
      --n-train 4 --n-test 2 --batch-size 2 --device cpu --compute-dtype float32

Prints the seconds of training and evaluation and the kernels' launches
(`run: {...}`), then one JSON line with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import colorsys
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from jpeg_detection_resnet_ssd_torch.data.datasets import VOC_CLASSES

SHAPE_CLASSES = list(VOC_CLASSES)  # all 20
VARIANTS = ("host", "device", "device_v3", "device_v4", "device_v5", "none", "rgb")
DEVICE_VARIANTS = ("device", "device_v3", "device_v4", "device_v5")
PACK_SIDE = 352  # the device chains' source frame (44 luma blocks for a 304 crop)


def _class_color(cls_idx):
    """Distinct hue per class (HSV wheel), full saturation/value."""
    h = (cls_idx * 0.413) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 1.0)
    return np.array([r, g, b])


def _texture(rng, h, w, cls_idx):
    """Per-class texture: family cls_idx // 5, colour per class."""
    yy, xx = np.mgrid[0:h, 0:w]
    kind = cls_idx // 5
    if kind == 0:    # horizontal stripes
        base = ((yy // 4) % 2) * 200.0 + 30
    elif kind == 1:  # vertical stripes
        base = ((xx // 4) % 2) * 200.0 + 30
    elif kind == 2:  # checkerboard
        base = (((yy // 5) + (xx // 5)) % 2) * 200.0 + 30
    else:            # diagonal gradient
        base = 255.0 * ((yy + xx) % 24) / 24.0
    tex = base[..., None] * _class_color(cls_idx)[None, None]
    tex += rng.normal(0, 10, tex.shape)
    return np.clip(tex, 0, 255)


def _draw_shape(img, rng, cls_idx, x0, y0, w, h):
    """Paint the class texture inside the class silhouette (family
    cls_idx % 5: rectangle, ellipse, triangle, diamond, cross); returns
    the bbox."""
    tex = _texture(rng, h, w, cls_idx)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h - 1) / 2, (w - 1) / 2
    shape = cls_idx % 5
    if shape == 0:
        mask = np.ones((h, w), bool)
    elif shape == 1:
        mask = ((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2 <= 1.0
    elif shape == 2:
        mask = (yy / max(h - 1, 1)) >= np.abs(xx - cx) / max(cx, 1)
    elif shape == 3:
        mask = (np.abs(yy - cy) / (h / 2) + np.abs(xx - cx) / (w / 2)) <= 1.0
    else:
        mask = (np.abs(xx - cx) <= w / 6) | (np.abs(yy - cy) <= h / 6)
    region = img[y0 : y0 + h, x0 : x0 + w]
    region[mask] = tex[mask]
    return x0, y0, x0 + w, y0 + h


def _corpus_images(n, size, seed):
    """The corpus stream: for image i, (uint8 image, objects) with objects
    `(class name, xmin, ymin, xmax, ymax)`, 0-based pixel corners."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        img = rng.normal(120, 30, (size, size, 3))
        for _ in range(6):  # distractor blobs (solid colour, no class texture)
            bw, bh = rng.integers(10, 40, 2)
            bx, by = rng.integers(0, size - 40, 2)
            img[by : by + bh, bx : bx + bw] = rng.integers(0, 255, 3)
        objs = []
        for _ in range(int(rng.integers(1, 4))):
            c = int(rng.integers(0, len(SHAPE_CLASSES)))
            w = int(rng.integers(48, 160))
            h = int(rng.integers(48, 160))
            x0 = int(rng.integers(0, size - w))
            y0 = int(rng.integers(0, size - h))
            objs.append((SHAPE_CLASSES[c], *_draw_shape(img, rng, c, x0, y0, w, h)))
        yield np.clip(img, 0, 255).astype(np.uint8), objs


def generate_corpus(root: str, n_train=256, n_test=64, size=320, seed=7, keep=None):
    """Write the VOC-layout corpus (JPEGImages at quality 92, Annotations,
    ImageSets/Main/{trainval,test}.txt) of the first n_train + n_test
    images of seed's stream.  `keep=(k_train, k_test)` writes only the
    first k of each split (the same images the full corpus holds)."""
    from PIL import Image

    os.makedirs(f"{root}/JPEGImages", exist_ok=True)
    os.makedirs(f"{root}/Annotations", exist_ok=True)
    os.makedirs(f"{root}/ImageSets/Main", exist_ok=True)
    k_train, k_test = keep if keep is not None else (n_train, n_test)
    splits = {"trainval": [], "test": []}
    for i, (img, objs) in enumerate(_corpus_images(n_train + n_test, size, seed)):
        split, j = ("trainval", i) if i < n_train else ("test", i - n_train)
        if j >= (k_train if split == "trainval" else k_test):
            continue
        iid = f"{i:06d}"
        splits[split].append(iid)
        Image.fromarray(img).save(f"{root}/JPEGImages/{iid}.jpg", quality=92)
        xo = "\n".join(
            f"  <object><name>{c}</name><difficult>0</difficult>"
            f"<truncated>0</truncated>\n    <bndbox><xmin>{a + 1}</xmin>"
            f"<ymin>{b + 1}</ymin><xmax>{cc}</xmax><ymax>{dd}</ymax>"
            f"</bndbox>\n  </object>"
            for c, a, b, cc, dd in objs
        )
        with open(f"{root}/Annotations/{iid}.xml", "w") as f:
            f.write(
                f"<annotation>\n  <size><width>{size}</width>"
                f"<height>{size}</height><depth>3</depth></size>\n{xo}\n"
                f"</annotation>"
            )
    for split, ids in splits.items():
        with open(f"{root}/ImageSets/Main/{split}.txt", "w") as f:
            f.write("\n".join(ids) + "\n")
    return root


def kernel_launches() -> dict:
    """The port's kernel launch counters (each wrapper counts its launches)."""
    from jpeg_detection_resnet_ssd_torch.ops import batched_nms, bipartite_match, conv_grad, dct_flip

    return {"batched_nms": batched_nms.LAUNCHES, "bipartite_match": bipartite_match.LAUNCHES,
            "dct_flip": dct_flip.LAUNCHES, "conv3x3_wgrad": conv_grad.LAUNCHES}


def launches_since(start: dict) -> dict:
    """Each kernel's launches since `start` (`kernel_launches()`), read
    after the card has finished them."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {k: v - start[k] for k, v in kernel_launches().items()}


def build_parser():
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", default="host", choices=VARIANTS)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--data-root", default=os.path.join(tmp, "voc_shapes"))
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--n-test", type=int, default=64)
    p.add_argument("--num-workers", type=int, default=12)
    p.add_argument("--output-dir", default=os.path.join(tmp, "proxy_runs"))
    p.add_argument("--seed", type=int, default=0,
                   help="training seed (init/shuffle/augment); the corpus seed is fixed")
    p.add_argument("--freeze-bn", action="store_true",
                   help="train with BatchNorm frozen (config.freeze_bn); from random init "
                        "only as the second phase of a --resume run")
    p.add_argument("--resume", action="store_true",
                   help="resume the latest run dir of this variant and seed")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--codec", default="libjpeg", choices=("libjpeg", "numpy"),
                   help="how DCT planes are computed: libjpeg through PIL, or the "
                        "bit-exact NumPy encoder (no libjpeg needed)")
    p.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    return p


def _selector_results(model, input_format, test_ds, codec, device):
    """{selector: (mAP, APs, predictions)} for 'exact' (the reference mAP
    protocol) and 'shared' (the serving default) on the same weights."""
    import torch

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.data import DetectionPipeline
    from jpeg_detection_resnet_ssd_torch.eval import DetectionEvaluator
    from jpeg_detection_resnet_ssd_torch.models import make_inference_fn

    results = {}
    for selector in ("exact", "shared"):
        decode = make_inference_fn(n_classes=20, spec=AnchorSpec(),
                                   candidate_selector=selector, device=device)

        def infer(inputs, decode=decode):
            with torch.no_grad():
                return decode(model(inputs))

        pipe = DetectionPipeline(test_ds, 8, train=False, encoder=None, augmentation=None,
                                 input_format=input_format, num_workers=4, codec=codec)
        evaluator = DetectionEvaluator(infer, pipe, n_classes=20)
        mean_ap, aps, _ = evaluator()
        results[selector] = (mean_ap, aps, evaluator.prediction_results)
    return results


def run(args):
    """Train and evaluate; returns (the JSON row, details) where details
    holds the history, each selector's mAP and predictions, the seconds of
    training and evaluation and the kernels' launches."""
    import time

    import torch

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.data import DetectionDataset, DetectionPipeline
    from jpeg_detection_resnet_ssd_torch.data.augment import SSDDataAugmentation
    from jpeg_detection_resnet_ssd_torch.models import build_model, ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, fit
    from jpeg_detection_resnet_ssd_torch.train.config import create_run_dir, find_latest_run

    root = args.data_root
    if not os.path.exists(f"{root}/ImageSets/Main/test.txt"):
        print(f"generating corpus at {root} ...", flush=True)
        generate_corpus(root, args.n_train, args.n_test)
    ds = DetectionDataset.from_voc(f"{root}/JPEGImages", f"{root}/ImageSets/Main/trainval.txt",
                                   f"{root}/Annotations")
    model_name = "ssd300_vgg" if args.variant == "rgb" else "ssd300_ssd_custom"
    input_format = "rgb" if args.variant == "rgb" else "dct"
    device = torch.device(args.device)
    # fit's epoch ends with the pipeline's pass: size epochs so that
    # max_steps is the binding limit
    steps_per_pass = max(1, len(ds) // args.batch_size)
    config = ExperimentConfig(
        model=model_name,
        model_kwargs={"n_classes": 20},
        task="detection",
        input_format=input_format,
        learning_rate=args.lr,
        batch_size=args.batch_size,
        epochs=-(-args.steps // steps_per_pass),
        steps_per_epoch=steps_per_pass,
        num_workers=args.num_workers,
        output_dir=args.output_dir,
        project=f"proxy_{args.variant}_s{args.seed}",
        seed=args.seed,
        restart=args.resume,
        freeze_bn=args.freeze_bn,
        compute_dtype=args.compute_dtype,
    )
    family = "vgg" if args.variant == "rgb" else "resnet_custom"
    augment_fn = None
    if args.variant in DEVICE_VARIANTS:
        from jpeg_detection_resnet_ssd_torch.data.packed import (
            PackedDctDataset,
            PackedDctPipeline,
        )
        from jpeg_detection_resnet_ssd_torch.ops import (
            make_dct_detection_augment_v2,
            make_dct_detection_augment_v3,
        )

        encoder = TargetEncoder(AnchorSpec(img_height=304, img_width=304),
                                ssd_predictor_sizes(family), n_classes=20, device=device)
        if args.variant == "device":
            augment_fn = make_dct_detection_augment_v2(out_y_blocks=38, device=device)
        else:
            augment_fn = make_dct_detection_augment_v3(
                out_y_blocks=38,
                photometric="pixel_hsv" if args.variant in ("device_v4", "device_v5") else True,
                requantize_quality=75 if args.variant == "device_v5" else None,
                device=device,
            )
        stem = os.path.join(root, f"packed_{PACK_SIDE}")
        if not os.path.exists(stem + ".meta.json"):
            PackedDctDataset.create(ds, stem, img_height=PACK_SIDE, img_width=PACK_SIDE,
                                    num_workers=args.num_workers, codec=args.codec)
        pipe = PackedDctPipeline(PackedDctDataset(stem), config.batch_size, train=True,
                                 seed=config.seed, ship_dtype="int16")
    else:
        encoder = TargetEncoder(AnchorSpec(), ssd_predictor_sizes(family), n_classes=20,
                                device=device)
        pipe = DetectionPipeline(
            ds, config.batch_size, train=True, encoder=encoder,
            augmentation=None if args.variant == "none" else SSDDataAugmentation(),
            input_format=input_format, num_workers=config.num_workers, seed=config.seed,
            device_encode=True, codec=args.codec,
        )

    run_dir = find_latest_run(config) if args.resume else None
    if run_dir is None:
        run_dir = create_run_dir(config)
    print(f"run dir: {run_dir}", flush=True)
    start, t0 = kernel_launches(), time.perf_counter()
    trainer, history = fit(config, pipe, run_dir=run_dir, max_steps=args.steps,
                           target_encoder=encoder, augment_fn=augment_fn,
                           save_every=50,  # tiny epochs: per-epoch saves dominate
                           device=device)
    final = history[-1] if history else {}
    t1 = time.perf_counter()

    # held-out evaluation in float32, the reference mAP protocol
    model, _ = build_model(model_name, n_classes=20, device=device)
    model.load_state_dict(trainer.model.state_dict())
    model.eval()
    test_ds = DetectionDataset.from_voc(f"{root}/JPEGImages", f"{root}/ImageSets/Main/test.txt",
                                        f"{root}/Annotations")
    results = _selector_results(model, input_format, test_ds, args.codec, device)
    mean_ap, aps, _ = results["exact"]
    out = {
        "variant": args.variant + "_freezebn" if args.freeze_bn else args.variant,
        "seed": args.seed,
        "model": model_name,
        "steps": args.steps,
        "train_images": len(ds),
        "test_images": len(test_ds),
        "final_train_loss": final.get("total_loss"),
        "heldout_mAP": round(mean_ap, 4),
        "heldout_mAP_shared_selector": round(results["shared"][0], 4),
        "selector_delta": round(results["shared"][0] - mean_ap, 5),
        "heldout_AP_nonzero": {
            VOC_CLASSES[c - 1]: round(aps[c], 4) for c in range(1, 21) if aps[c] > 0
        },
        "run_dir": run_dir,
    }
    details = {"history": history, "predictions": {k: v[2] for k, v in results.items()},
               "mAP": {k: v[0] for k, v in results.items()},
               "train_s": t1 - t0, "eval_s": time.perf_counter() - t1,
               "launches": launches_since(start)}
    return out, details


def main(argv=None):
    args = build_parser().parse_args(argv)
    out, details = run(args)
    print("run: " + json.dumps({k: details[k] for k in ("train_s", "eval_s", "launches")}))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
