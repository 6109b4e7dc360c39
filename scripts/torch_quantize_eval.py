#!/usr/bin/env python
"""Held-out-mAP cost of the serving transforms on a trained port checkpoint.

The port's counterpart of `scripts/quantize_eval.py`, importing only
`jpeg_detection_resnet_ssd_torch`.  Evaluates one run of
`scripts/torch_convergence_proxy.py` under the reference mAP protocol
(exact decode, float32) four ways:

  float    : the checkpoint as trained (reproduces the proxy's heldout_mAP)
  folded   : BatchNorm folded (serve/folding.py); exact up to f32 rounding
  int8     : quantized trunk, default skip list (input stems and head
             float), activation scales calibrated on train batches
  int8_all : every conv quantized (no skips): what the skip list protects

Usage:
  python scripts/torch_quantize_eval.py --run-dir RUN --data-root VOC \\
      [--codec numpy] [--device cpu] [--calib-batches 4]

Prints one JSON line per variant and a summary with the mAP deltas.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--codec", default="libjpeg", choices=("libjpeg", "numpy"),
                    help="how DCT planes are computed (see data/dct_convert.py)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.data import DetectionDataset, DetectionPipeline
    from jpeg_detection_resnet_ssd_torch.eval import DetectionEvaluator
    from jpeg_detection_resnet_ssd_torch.models import build_model, make_inference_fn
    from jpeg_detection_resnet_ssd_torch.serve import fold_batch_norm, quantize_for_serving
    from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, build_trainer
    from jpeg_detection_resnet_ssd_torch.train.checkpoints import CheckpointManager

    device = torch.device(args.device)
    config = ExperimentConfig.load(os.path.join(args.run_dir, "saved_config.json"))
    trainer, _, _ = build_trainer(config, device=device)
    CheckpointManager(os.path.join(args.run_dir, "checkpoints")).restore(trainer)
    # evaluate in f32 whatever the training compute dtype (the reference
    # protocol; as the proxy's evaluation)
    module, _ = build_model(config.model, n_classes=20, device=device)
    module.load_state_dict(trainer.model.state_dict())
    module.eval()
    del trainer
    root = args.data_root
    input_format = config.input_format

    def voc(image_set):
        return DetectionDataset.from_voc(f"{root}/JPEGImages", f"{root}/ImageSets/Main/{image_set}",
                                         f"{root}/Annotations")

    test_ds, train_ds = voc("test.txt"), voc("trainval.txt")
    calib = []
    for batch in DetectionPipeline(train_ds, args.batch_size, train=False, encoder=None,
                                   augmentation=None, input_format=input_format,
                                   num_workers=2, codec=args.codec):
        calib.append(batch["inputs"])
        if len(calib) >= args.calib_batches:
            break

    decode = make_inference_fn(n_classes=20, spec=AnchorSpec(), candidate_selector="exact",
                               device=device)

    def evaluate(model):
        def infer(inputs):
            with torch.no_grad():
                return decode(model(inputs))

        pipe = DetectionPipeline(test_ds, args.batch_size, train=False, encoder=None,
                                 augmentation=None, input_format=input_format, num_workers=4,
                                 codec=args.codec)
        mean_ap, aps, _ = DetectionEvaluator(infer, pipe, n_classes=20)()
        return mean_ap, aps

    results = {}

    def record(name, model, extra=None):
        mean_ap, aps = evaluate(model)
        results[name] = mean_ap
        row = {"variant": name, "heldout_mAP": round(mean_ap, 4),
               "present_class_AP": {c: round(aps[c], 4) for c in range(1, 21) if aps[c] > 0}}
        row.update(extra or {})
        print(json.dumps(row), flush=True)

    record("float", module)
    record("folded", fold_batch_norm(module))
    qmodel, qinfo = quantize_for_serving(module, calib)
    record("int8", qmodel, {"n_quantized": len(qinfo["quantized"]),
                            "kept_float": qinfo["kept_float"]})
    qmodel_all, qinfo_all = quantize_for_serving(module, calib, skip=())
    record("int8_all", qmodel_all, {"n_quantized": len(qinfo_all["quantized"])})

    summary = {
        "run_dir": args.run_dir,
        "summary_mAP": {k: round(v, 4) for k, v in results.items()},
        "fold_delta": round(results["folded"] - results["float"], 5),
        "int8_delta": round(results["int8"] - results["float"], 5),
        "int8_all_delta": round(results["int8_all"] - results["float"], 5),
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
