#!/usr/bin/env python
"""Held-out top-1 convergence proxy of the PyTorch port (classification).

The port's counterpart of `scripts/cls_convergence_proxy.py`, importing
only `jpeg_detection_resnet_ssd_torch`: the same generated corpus of 8
texture-and-scale classes with clutter (the generator writes the same JPEG
bytes as the JAX script's), split train/val, trained with the port's
classification path and scored on the held-out split.

Variants (--variant):
  device : packed 256-px corpus + DCT-domain crop/flip/photometric in the
           step (`make_dct_classification_augment_v2`, the flip on B3)
  host   : host pixel augmentation (classification_train_view), dct inputs
  rgb    : host augmentation + ResNet50-RGB

`--codec numpy` computes the DCT planes with the bit-exact NumPy encoder
(`data/dct_convert.py`), for machines without libjpeg.

Usage:
  python scripts/torch_cls_convergence_proxy.py --variant device --steps 1500 \\
      --seed 0 --codec numpy                                       # on a card
  python scripts/torch_cls_convergence_proxy.py --variant device --steps 1 \\
      --n-train 2 --n-test 1 --batch-size 1 --device cpu --compute-dtype float32

Prints the seconds of training and evaluation and the kernels' launches
(`run: {...}`), then one JSON line with the JAX script's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from torch_convergence_proxy import _texture, kernel_launches, launches_since  # noqa: E402  (same dir)

N_CLASSES = 8
VARIANTS = ("device", "host", "rgb")


def generate_corpus(root, n_train=512, n_test=128, size=288, seed=11):
    """Write `{root}/{train,val}/class_{c}/{i:06d}.JPEG` (quality 92)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n_train + n_test):
        c = int(rng.integers(0, N_CLASSES))
        img = rng.normal(120, 30, (size, size, 3))
        for _ in range(4):  # clutter
            bw, bh = rng.integers(10, 30, 2)
            bx, by = rng.integers(0, size - 30, 2)
            img[by : by + bh, bx : bx + bw] = rng.integers(0, 255, 3)
        # the class object: texture kind = c % 4, scale family = c // 4
        small = c >= 4
        w = int(rng.integers(60, 110)) if small else int(rng.integers(140, 220))
        h = int(rng.integers(60, 110)) if small else int(rng.integers(140, 220))
        x0 = int(rng.integers(0, size - w))
        y0 = int(rng.integers(0, size - h))
        img[y0 : y0 + h, x0 : x0 + w] = _texture(rng, h, w, c % 4)
        split = "train" if i < n_train else "val"
        d = f"{root}/{split}/class_{c}"
        os.makedirs(d, exist_ok=True)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            f"{d}/{i:06d}.JPEG", quality=92
        )
    return root


def build_parser():
    tmp = tempfile.gettempdir()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", default="device", choices=VARIANTS)
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--data-root", default=os.path.join(tmp, "cls_shapes"))
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--n-test", type=int, default=128)
    p.add_argument("--num-workers", type=int, default=12)
    p.add_argument("--output-dir", default=os.path.join(tmp, "cls_proxy_runs"))
    p.add_argument("--seed", type=int, default=0,
                   help="training seed (init/shuffle/augment); the corpus seed is fixed")
    p.add_argument("--resume", action="store_true",
                   help="resume the latest run dir of this variant and seed")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--codec", default="libjpeg", choices=("libjpeg", "numpy"),
                   help="how DCT planes are computed: libjpeg through PIL, or the "
                        "bit-exact NumPy encoder (no libjpeg needed)")
    p.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    return p


def run(args):
    """Train and evaluate; returns (the JSON row, details) where details
    holds the history, the seconds of training and evaluation and the
    kernels' launches."""
    import time

    import torch

    from jpeg_detection_resnet_ssd_torch.data import ClassificationPipeline, ImageFolderDataset
    from jpeg_detection_resnet_ssd_torch.eval import ClassificationEvaluator
    from jpeg_detection_resnet_ssd_torch.models import build_model
    from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, fit
    from jpeg_detection_resnet_ssd_torch.train.config import create_run_dir, find_latest_run

    if not os.path.isdir(f"{args.data_root}/val"):
        print(f"generating corpus at {args.data_root} ...", flush=True)
        generate_corpus(args.data_root, args.n_train, args.n_test)
    train_ds = ImageFolderDataset(f"{args.data_root}/train")
    val_ds = ImageFolderDataset(f"{args.data_root}/val")
    model_name = ("resnet50_rgb" if args.variant == "rgb"
                  else "resnet50_dct_late_concat_rfa_thinner")
    input_format = "rgb" if args.variant == "rgb" else "dct"
    device = torch.device(args.device)
    steps_per_pass = max(1, len(train_ds) // args.batch_size)
    config = ExperimentConfig(
        model=model_name,
        model_kwargs={"num_classes": N_CLASSES},
        task="classification",
        input_format=input_format,
        learning_rate=args.lr,
        nesterov=True,
        lr_decay=1e-4,
        l2_regularization=0.0,
        batch_size=args.batch_size,
        epochs=-(-args.steps // steps_per_pass),
        steps_per_epoch=steps_per_pass,
        num_workers=args.num_workers,
        output_dir=args.output_dir,
        project=f"clsproxy_{args.variant}_s{args.seed}",
        seed=args.seed,
        restart=args.resume,
        compute_dtype=args.compute_dtype,
    )
    augment_fn = None
    if args.variant == "device":
        from jpeg_detection_resnet_ssd_torch.data.packed import PackedDctPipeline, load_or_create
        from jpeg_detection_resnet_ssd_torch.ops import make_dct_classification_augment_v2

        augment_fn = make_dct_classification_augment_v2(out_y_blocks=28, device=device)
        packed = load_or_create(
            os.path.join(args.data_root, "packed_256"), train_ds, task="classification",
            img_size=256, num_workers=args.num_workers, verbose=False, codec=args.codec,
        )
        pipe = PackedDctPipeline(packed, config.batch_size, train=True, seed=config.seed,
                                 ship_dtype="int16")
    else:
        pipe = ClassificationPipeline(train_ds, config.batch_size, train=True,
                                      input_format=input_format, num_workers=args.num_workers,
                                      seed=config.seed, codec=args.codec)

    run_dir = find_latest_run(config) if args.resume else None
    if run_dir is None:
        run_dir = create_run_dir(config)
    print(f"run dir: {run_dir}", flush=True)
    start, t0 = kernel_launches(), time.perf_counter()
    trainer, history = fit(config, pipe, run_dir=run_dir, max_steps=args.steps,
                           augment_fn=augment_fn,
                           save_every=50,  # tiny epochs: per-epoch saves dominate
                           device=device)
    final = history[-1] if history else {}
    t1 = time.perf_counter()

    # held-out evaluation (the deterministic 224 view) in float32
    model, _ = build_model(model_name, num_classes=N_CLASSES, device=device)
    model.load_state_dict(trainer.model.state_dict())
    model.eval()
    eval_pipe = ClassificationPipeline(val_ds, 32, train=False, input_format=input_format,
                                       num_workers=args.num_workers, codec=args.codec)
    metrics = ClassificationEvaluator(model, eval_pipe)()
    out = {
        "variant": args.variant,
        "seed": args.seed,
        "model": model_name,
        "steps": args.steps,
        "train_images": len(train_ds),
        "test_images": len(val_ds),
        "final_train_top1": final.get("top1"),
        "heldout_top1": round(float(metrics["top1"]), 4),
        "heldout_top5": round(float(metrics["top5"]), 4),
        "run_dir": run_dir,
    }
    details = {"history": history, "train_s": t1 - t0, "eval_s": time.perf_counter() - t1,
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
