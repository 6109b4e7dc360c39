"""Command line of the PyTorch port: `evaluate`, `compute-map`, `infer`.

    python -m jpeg_detection_resnet_ssd_torch.cli evaluate --run-dir RUN \\
        --voc-root VOC [--image-set test.txt] [--out-dir PRED]
    python -m jpeg_detection_resnet_ssd_torch.cli compute-map --pred-dir PRED \\
        --voc-root VOC
    python -m jpeg_detection_resnet_ssd_torch.cli infer --image IMG.jpg \\
        [--weights KERAS.h5] [--output detections.png]

The flags are those of the JAX package's `cli/main.py`, plus `--device`
(default `cuda`; `evaluate` and `infer` raise without a card unless given
`--device cpu`).  `compute-map` is NumPy only.  `--exported` serving
artifacts raise `NotImplementedError` naming ROADMAP A14.  The JAX package's
other subcommands are not ported yet: `train-detect` is ROADMAP A10b,
`train-classify`, `evaluate-classify`, `export` and `bench` are A14.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

def _exported_not_ported(args):
    if args.exported:
        raise NotImplementedError(
            f"{args.command} --exported: serving artifacts are not ported to PyTorch yet (ROADMAP A14)"
        )


def cmd_evaluate(args):
    """mAP of a training run's latest checkpoint on a VOC image set, with the
    reference's literal decode (`candidate_selector="exact"`)."""
    _exported_not_ported(args)
    import torch

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.data import DetectionDataset, DetectionPipeline
    from jpeg_detection_resnet_ssd_torch.eval import (
        DetectionEvaluator,
        write_voc_detection_files,
    )
    from jpeg_detection_resnet_ssd_torch.models import make_inference_fn
    from jpeg_detection_resnet_ssd_torch.train.checkpoints import CheckpointManager
    from jpeg_detection_resnet_ssd_torch.train.config import ExperimentConfig
    from jpeg_detection_resnet_ssd_torch.train.loop import build_trainer

    config = ExperimentConfig.load(os.path.join(args.run_dir, "saved_config.json"))
    trainer, module, _ = build_trainer(config, device=args.device)
    CheckpointManager(os.path.join(args.run_dir, "checkpoints")).restore(trainer)
    module.eval()
    # mAP protocol: literal reference semantics (full per-class top-k), not
    # the faster shared candidate pool used for serving.
    decode = make_inference_fn(
        n_classes=20, spec=AnchorSpec(), candidate_selector="exact", device=trainer.device
    )

    def infer(inputs):
        with torch.no_grad():
            return decode(module(inputs))

    ds = DetectionDataset.from_voc(
        os.path.join(args.voc_root, "JPEGImages"),
        os.path.join(args.voc_root, "ImageSets", "Main", args.image_set),
        os.path.join(args.voc_root, "Annotations"),
    )
    pipe = DetectionPipeline(
        ds, args.batch_size, train=False, encoder=None,
        input_format=config.input_format, num_workers=config.num_workers,
    )
    ev = DetectionEvaluator(infer, pipe, n_classes=20)
    if args.predict_only:
        # Test sets without annotations: inference and VOC files only.
        ev.predict_on_dataset()
        mean_ap, aps = None, []
    else:
        mean_ap, aps, _ = ev(
            average_precision_mode=args.ap_mode,
            # --reference-iou: the reference evaluator's mixed matching IoU
            # (intersection at 'half' under 'include' box areas).
            intersection_border="half" if args.reference_iou else None,
        )
    if args.out_dir:
        write_voc_detection_files(ev.prediction_results, args.out_dir)
    if args.predict_only:
        n_preds = sum(len(p) for p in ev.prediction_results)
        print(json.dumps({"predictions": n_preds, "out_dir": args.out_dir}))
    else:
        print(json.dumps({"mAP": mean_ap, "AP": aps[1:]}))


def cmd_compute_map(args):
    """Offline mAP from VOC-format txt predictions + XML ground truth."""
    from jpeg_detection_resnet_ssd_torch.data import parse_voc_xml
    from jpeg_detection_resnet_ssd_torch.eval import (
        average_precision,
        match_predictions,
        num_gt_per_class,
        read_voc_detection_files,
    )
    from jpeg_detection_resnet_ssd_torch.eval.map_eval import precision_recall

    preds = read_voc_detection_files(args.pred_dir)
    recs = parse_voc_xml(
        os.path.join(args.voc_root, "JPEGImages"),
        os.path.join(args.voc_root, "ImageSets", "Main", args.image_set),
        os.path.join(args.voc_root, "Annotations"),
    )
    gt = {
        str(r["image_id"]): (r["boxes"].astype(float), r["difficult"])
        for r in recs
    }
    n_gt = num_gt_per_class(gt, 20)
    cum_tp, cum_fp = match_predictions(
        preds, gt, 20,
        intersection_border="half" if args.reference_iou else None,
    )
    aps = []
    for c in range(1, 21):
        prec, rec = precision_recall(cum_tp[c], cum_fp[c], int(n_gt[c]))
        aps.append(average_precision(prec, rec, args.ap_mode))
    print(json.dumps({"mAP": sum(aps) / 20, "AP": aps}))


def cmd_infer(args):
    """Single-image detection: JPEG -> 300x300 DCT planes -> model -> exact
    decode -> boxes drawn on the original image, saved as a PNG."""
    _exported_not_ported(args)
    import numpy as np
    import torch
    from PIL import Image, ImageDraw

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.data.augment import resize, to_3_channels
    from jpeg_detection_resnet_ssd_torch.data.datasets import VOC_CLASSES
    from jpeg_detection_resnet_ssd_torch.data.dct_convert import rgb_to_dct_tensors
    from jpeg_detection_resnet_ssd_torch.models import build_model, make_inference_fn

    module, _ = build_model(args.model, n_classes=20, device=args.device)
    with Image.open(args.image) as im:
        orig = np.asarray(im.convert("RGB"))
    img300, _, inverter = resize(
        to_3_channels(orig), np.zeros((0, 5), np.float32), 300, 300,
        return_inverter=True,
    )
    y, cbcr = rgb_to_dct_tensors(img300)
    inputs = (y[None].astype(np.float32), cbcr[None].astype(np.float32))
    if args.weights:
        from jpeg_detection_resnet_ssd_torch.compat import import_weights_by_name

        import_weights_by_name(module, args.weights, verbose=True)
    decode = make_inference_fn(n_classes=20, spec=AnchorSpec(), device=args.device)
    with torch.no_grad():
        out = decode(module(inputs)).cpu().numpy()[0]
    rows = out[out[:, 1] >= args.confidence]
    rows = rows[np.isfinite(rows).all(axis=1)]
    rows = inverter(rows) if len(rows) else rows
    im = Image.fromarray(orig)
    draw = ImageDraw.Draw(im)
    H, W = orig.shape[:2]
    for row in rows:
        cls, conf, xmin, ymin, xmax, ymax = row
        xmin, xmax = np.clip([xmin, xmax], 0, W - 1)
        ymin, ymax = np.clip([ymin, ymax], 0, H - 1)
        if xmax <= xmin or ymax <= ymin:
            continue
        draw.rectangle([xmin, ymin, xmax, ymax], outline=(255, 0, 0), width=2)
        draw.text(
            (xmin + 2, max(0, ymin - 12)),
            f"{VOC_CLASSES[int(cls) - 1]}:{conf:.2f}",
            fill=(255, 0, 0),
        )
    im.save(args.output)
    print(f"{len(rows)} detections -> {args.output}")


def build_parser():
    p = argparse.ArgumentParser(prog="python -m jpeg_detection_resnet_ssd_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    ev = sub.add_parser("evaluate")
    ev.add_argument("--run-dir", required=True)
    ev.add_argument("--voc-root", required=True)
    ev.add_argument("--image-set", default="test.txt")
    ev.add_argument("--batch-size", type=int, default=8)
    ev.add_argument("--ap-mode", default="integrate",
                    choices=["integrate", "sample"])
    ev.add_argument("--out-dir", default=None)
    ev.add_argument("--predict-only", action="store_true",
                    help="write predictions without computing mAP "
                         "(for annotation-less test sets)")
    ev.add_argument("--reference-iou", action="store_true",
                    help="match with the reference evaluator's mixed IoU "
                         "formula (intersection with 'half' borders even "
                         "under 'include'); default: the official "
                         "consistent +1px convention")
    ev.add_argument("--exported", default=None,
                    help="serving-artifact dir (not ported: ROADMAP A14)")
    ev.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda; cpu for tests)")
    ev.set_defaults(fn=cmd_evaluate)

    cm = sub.add_parser("compute-map")
    cm.add_argument("--pred-dir", required=True)
    cm.add_argument("--voc-root", required=True)
    cm.add_argument("--image-set", default="test.txt")
    cm.add_argument("--ap-mode", default="sample",
                    choices=["integrate", "sample"])
    cm.add_argument("--reference-iou", action="store_true",
                    help="same as evaluate --reference-iou")
    cm.set_defaults(fn=cmd_compute_map)

    inf = sub.add_parser("infer")
    inf.add_argument("--image", required=True)
    inf.add_argument("--model", default="ssd300_ssd_custom")
    inf.add_argument("--weights", default=None, help="Keras H5 loaded by layer name")
    inf.add_argument("--exported", default=None,
                     help="serving-artifact dir (not ported: ROADMAP A14)")
    inf.add_argument("--confidence", type=float, default=0.2)
    inf.add_argument("--output", default="detections.png")
    inf.add_argument("--device", default="cuda",
                     help="where the model runs (default cuda; cpu for tests)")
    inf.set_defaults(fn=cmd_infer)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
