"""Command line of the PyTorch port: `train-classify`, `train-detect`,
`evaluate`, `evaluate-classify`, `compute-map`, `infer`, `export`, `bench`.

    python -m jpeg_detection_resnet_ssd_torch.cli train-classify --train-dir IMAGENET \\
        [--archi ARCHI|rgb] [--device-augment --pack-cache STEM] [--pallas-wgrad]
    python -m jpeg_detection_resnet_ssd_torch.cli evaluate-classify --run-dir RUN \\
        --val-dir IMAGENET_VAL
    python -m jpeg_detection_resnet_ssd_torch.cli train-detect --voc-root VOC \\
        [--vgg | --archi ARCHI] [--device-augment --pack-cache STEM] \\
        [--pretrained-weights KERAS.h5|SHORT_NAME|URL#md5:HEX]
    python -m jpeg_detection_resnet_ssd_torch.cli evaluate --run-dir RUN \\
        --voc-root VOC [--image-set test.txt] [--out-dir PRED] [--exported ART]
    python -m jpeg_detection_resnet_ssd_torch.cli compute-map --pred-dir PRED \\
        --voc-root VOC
    python -m jpeg_detection_resnet_ssd_torch.cli infer --image IMG.jpg \\
        [--weights KERAS.h5 | --exported ART] [--output detections.png]
    python -m jpeg_detection_resnet_ssd_torch.cli export (--run-dir RUN | --model NAME \\
        [--weights KERAS.h5]) --output ART [--symbolic-batch] [--quantize int8]
    python -m jpeg_detection_resnet_ssd_torch.cli bench [--model NAME] \\
        [--batch-size 32] [--runs 10]
    torchrun --nproc-per-node P -m jpeg_detection_resnet_ssd_torch.cli train-detect ...

The flags are those of the JAX package's `cli/main.py`, plus `--device`
(default `cuda`; every subcommand but `compute-map`, which is NumPy only,
raises without a card unless given `--device cpu`).  `train-detect` trains
every SSD300 of the JAX CLI: `ssd_custom` (default), the identical-family
archis (`--archi deconv|up_sampling|cb5_only|y_cb4_cbcr_cb5`) and the DCT
VGG SSD300 (`--vgg`); `infer --model` and `evaluate` take every SSD300 of
the registry.  `export` writes a `torch.export` serving artifact (`serve/`:
BatchNorm folded, optionally int8, the decode's NMS as the port's custom
operator) that `evaluate --exported` and `infer --exported` run; it takes
`--device` where the JAX command took `--platforms`.  `bench` times the
eval-mode forward of a registry model with CUDA events and prints the JAX
command's keys plus the card's name.  `--pretrained-weights` takes a local
H5, a known short name or a URL (`compat/fetch.py`: local and `file://`
sources, or a file pre-staged in the cache; nothing is downloaded).

`train-detect` and `train-classify` train under `torchrun` (one process a
card, NCCL; `--device cpu` uses gloo) over a mesh of `WORLD_SIZE / n_model`
data ranks by `--n-model-shards` model ranks (`parallel.make_mesh`,
model-axis-minor): each rank runs on `cuda:{LOCAL_RANK}`, packs nothing but
on rank 0, reads its data index's shard of the corpus, and steps on
`--batch-size // n_data` rows of the global batch (the JAX CLI hands each
process a pipeline of the whole `--batch-size`, which its `fit` treats as
the global batch; here `fit`'s global-batch contract holds); the model axis
shards the widest kernels (tensor parallelism).  World rank 0 creates the
run dir and writes checkpoints (whole tensors, so `evaluate`, `export` and
`infer` run a tensor-parallel run's checkpoint in one process) and metrics.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_train_common(p):
    p.add_argument("--archi", default=None, help="architecture variant")
    p.add_argument("--restart", action="store_true")
    p.add_argument("--config", default=None, help="path to a config JSON")
    p.add_argument("--output-dir", default="experiments")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--pretrained-weights", default=None,
                   help="local Keras H5 for by-name transfer")
    p.add_argument("--n-model-shards", type=int, default=1)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="hand N optimization steps to one Trainer.train_steps "
                        "call; the same steps and draws as single steps")
    p.add_argument("--pallas-wgrad", action="store_true", default=None,
                   help="route eligible 3x3 stride-1 convs' filter gradient "
                        "through the CUDA kernel (ops/csrc/conv3x3_wgrad.cu); "
                        "forward unchanged, dW summed in another order")
    p.add_argument("--freeze-bn", action="store_true", default=None,
                   help="train with BatchNorm frozen (eval-mode normalization, "
                        "running statistics untouched)")
    p.add_argument("--device", default="cuda",
                   help="where training runs (default cuda; cpu for tests)")


def _load_config(args, defaults):
    from jpeg_detection_resnet_ssd_torch.train.config import ExperimentConfig

    if args.config:
        config = ExperimentConfig.load(args.config)
    else:
        config = ExperimentConfig(**defaults)
    for field in ("batch_size", "epochs", "steps_per_epoch", "output_dir",
                  "pretrained_weights", "n_model_shards", "num_workers",
                  "pallas_wgrad", "freeze_bn"):
        v = getattr(args, field, None)
        if v is not None:
            setattr(config, field, v)
    config.restart = bool(args.restart)
    return config


def _resume_or_create_run_dir(config, mesh) -> str:
    """`--restart` resumes the latest existing run of this workspace and
    project (`fit` restores its checkpoint) instead of creating a fresh dir
    whose empty checkpoints/ would train from scratch; a new run dir when
    none exists.  World rank 0 decides and hands the path to the other
    ranks."""
    from jpeg_detection_resnet_ssd_torch.train.config import create_run_dir, find_latest_run

    run_dir = [None]
    if mesh.rank == 0:
        if config.restart:
            run_dir[0] = find_latest_run(config)
            if run_dir[0] is None:
                print("restart requested but no prior run found; starting fresh",
                      file=sys.stderr)
        if run_dir[0] is None:
            run_dir[0] = create_run_dir(config)
    if mesh.n_data * mesh.n_model > 1:
        import torch.distributed as dist

        dist.broadcast_object_list(run_dir, src=0)
    return run_dir[0]


def _init_distributed(args, config):
    """Join `torchrun`'s process group (gloo with `--device cpu`, else NCCL)
    when its environment is set: (mesh of `config.n_model_shards` model
    ranks, device), the device `cuda:{LOCAL_RANK}` for `--device cuda`
    under `torchrun`."""
    from jpeg_detection_resnet_ssd_torch.parallel import make_mesh
    from jpeg_detection_resnet_ssd_torch.utils.distributed import (
        local_rank,
        maybe_initialize_distributed,
    )

    maybe_initialize_distributed(backend="gloo" if args.device == "cpu" else None)
    device = args.device
    if device == "cuda" and "LOCAL_RANK" in os.environ:
        device = f"cuda:{local_rank()}"
    return make_mesh(n_model=config.n_model_shards), device


def _rank_batch_size(config, mesh) -> int:
    """Rows a rank's pipeline yields: the global batch over the data ranks."""
    if config.batch_size % mesh.n_data:
        raise SystemExit(f"--batch-size {config.batch_size} must be divisible by the "
                         f"{mesh.n_data} data ranks")
    return config.batch_size // mesh.n_data


def _restore_run(config, run_dir: str, device):
    """(trainer, module, example_inputs) of `run_dir`'s latest checkpoint
    in this process.  A checkpoint holds whole tensors, so the run of a
    tensor-parallel mesh restores here unsharded."""
    from jpeg_detection_resnet_ssd_torch.parallel import make_mesh
    from jpeg_detection_resnet_ssd_torch.train.checkpoints import CheckpointManager
    from jpeg_detection_resnet_ssd_torch.train.loop import build_trainer

    trainer, module, example_inputs = build_trainer(config, device=device, mesh=make_mesh())
    CheckpointManager(os.path.join(run_dir, "checkpoints")).restore(trainer)
    return trainer, module, example_inputs


def _resolve_pretrained_source(spec: str) -> str:
    """`--pretrained-weights` accepts a local H5 path, a known-checkpoint
    short name (checksum-verified fetch, `compat/fetch.py`), or a URL with
    an optional `#md5:<hex>` / `#sha256:<hex>` fragment (served from the
    cache where it was pre-staged: nothing is downloaded)."""
    from jpeg_detection_resnet_ssd_torch.compat.fetch import (
        KNOWN_WEIGHTS,
        fetch_known_weights,
        fetch_weights,
    )

    if spec in KNOWN_WEIGHTS:
        return fetch_known_weights(spec)
    if "://" in spec:
        origin, _, checksum = spec.partition("#")
        return fetch_weights(origin, checksum=checksum or None)
    return spec


def _maybe_import_pretrained(config):
    """Flax-layout variables of the config's model with a Keras H5's layers
    imported by name (the others keep the seeded init `fit` would give
    them), or None without `pretrained_weights`."""
    if not config.pretrained_weights:
        return None
    spec = config.pretrained_weights = _resolve_pretrained_source(config.pretrained_weights)
    import torch

    from jpeg_detection_resnet_ssd_torch.compat import flax_variables, import_weights_by_name
    from jpeg_detection_resnet_ssd_torch.models import build_model

    module, _ = build_model(config.model, device="cpu",
                            generator=torch.Generator().manual_seed(config.seed),
                            **config.model_kwargs)
    import_weights_by_name(module, spec, verbose=True)
    return flax_variables(module)


def _check_device_augment_flags(args, config):
    """The DCT-domain device augmentation exists only for the dual-plane
    'dct' input contract, and the packed corpus only for it; falling back to
    the host pipeline would train another recipe than asked, so fail."""
    device_augment = getattr(args, "device_augment", False)
    pack_cache = getattr(args, "pack_cache", None)
    if device_augment and config.input_format != "dct":
        raise SystemExit(
            f"--device-augment requires input_format='dct' (dual-plane "
            f"Y+CbCr coefficients); this run resolves to input_format="
            f"{config.input_format!r} (archi={args.archi!r}). Drop the flag "
            f"to use the host augmentation pipeline, or pick a dct archi."
        )
    if pack_cache and not device_augment:
        raise SystemExit(
            "--pack-cache only takes effect together with --device-augment "
            "(the packed corpus stores oversized DCT coefficients for the "
            "device augmentation chain). Add --device-augment or drop "
            "--pack-cache."
        )


def _input_format(model, args):
    """The input contract of the registry model that the flags name."""
    from jpeg_detection_resnet_ssd_torch.models import MODEL_REGISTRY

    if model not in MODEL_REGISTRY:
        raise SystemExit(f"unknown --archi {args.archi!r}")
    return MODEL_REGISTRY[model].input_format


def cmd_train_classify(args):
    """Train a ResNet-50 classifier (the DCT stem of `--archi`, or `rgb`) on
    an ImageFolder tree: the host training view, or with `--device-augment`
    256-px source maps that the v2 random-resized crop, flip and
    photometric op turn into 224-px views in the train step (from a packed
    corpus with `--pack-cache`).  Prints the run dir, then the last epoch's
    history row as JSON."""
    from jpeg_detection_resnet_ssd_torch.data import ClassificationPipeline, ImageFolderDataset
    from jpeg_detection_resnet_ssd_torch.train.loop import fit

    archi = args.archi or "late_concat_rfa_thinner"
    model = "resnet50_rgb" if archi == "rgb" else f"resnet50_dct_{archi}"
    config = _load_config(
        args,
        dict(
            model=model, task="classification", input_format=_input_format(model, args),
            model_kwargs={"num_classes": 1000},
            learning_rate=0.1, nesterov=True, lr_decay=1e-4,
            l2_regularization=0.0, batch_size=256, epochs=120,
            steps_per_epoch=5000, warmup_epochs=5,
        ),
    )
    _check_device_augment_flags(args, config)
    mesh, device = _init_distributed(args, config)
    rows = _rank_batch_size(config, mesh)
    full_ds = ImageFolderDataset(args.train_dir, args.class_index_json)
    ds = full_ds.shard(mesh.data_index, mesh.n_data)  # a pack cache covers the whole corpus
    augment_fn = None
    if args.device_augment:
        from jpeg_detection_resnet_ssd_torch.ops import make_dct_classification_augment_v2

        augment_fn = make_dct_classification_augment_v2(out_y_blocks=28, device=device)
        if args.pack_cache:
            from jpeg_detection_resnet_ssd_torch.data.packed import (
                PackedDctPipeline,
                load_or_create,
            )

            packed = load_or_create(args.pack_cache, full_ds, task="classification",
                                    img_size=256, num_workers=config.num_workers)
            pipe = PackedDctPipeline(packed, rows, train=True, seed=config.seed,
                                     ship_dtype="int16", shard_index=mesh.data_index,
                                     shard_count=mesh.n_data)
        else:
            # The host ships the deterministic 256-px view (epoch shuffling
            # stays on); crops and flips happen in the step.
            pipe = ClassificationPipeline(
                ds, rows, train=True, host_augment=False, input_format="dct",
                image_size=256, num_workers=config.num_workers, seed=config.seed,
            )
    else:
        pipe = ClassificationPipeline(
            ds, rows, train=True, input_format=config.input_format,
            num_workers=config.num_workers, seed=config.seed,
        )
    run_dir = _resume_or_create_run_dir(config, mesh)
    if mesh.rank == 0:
        print(f"run dir: {run_dir}")
    _, history = fit(
        config, pipe, run_dir=run_dir, max_steps=args.max_steps,
        init_variables=_maybe_import_pretrained(config), augment_fn=augment_fn,
        steps_per_call=args.steps_per_call, device=device, mesh=mesh,
    )
    if mesh.rank == 0:
        print(json.dumps(history[-1] if history else {}))


def cmd_train_detect(args):
    """Train an SSD300 detector on VOC trees: the host Caffe-SSD chain, or
    with `--device-augment` the DCT-domain chain inside the train step
    (from a packed corpus with `--pack-cache`).  The model is
    `ssd300_{--archi}` (default `ssd_custom`), or `ssd300_vgg_dct` with
    `--vgg`; `deconv` reads Cb and Cr as two planes (`dct_deconv`), which
    the device chain does not take.  Prints the run dir, then the last
    epoch's history row as JSON."""
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.data import DetectionDataset, DetectionPipeline
    from jpeg_detection_resnet_ssd_torch.data.augment import SSDDataAugmentation
    from jpeg_detection_resnet_ssd_torch.models import ssd_family
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.train.loop import fit, make_validation_fn

    model = "ssd300_vgg_dct" if args.vgg else f"ssd300_{args.archi or 'ssd_custom'}"
    config = _load_config(
        args,
        dict(
            model=model, task="detection", input_format=_input_format(model, args),
            model_kwargs={"n_classes": 20},
            learning_rate=1e-3,
            l2_regularization=5e-4 if args.reg else 0.0,
            batch_size=32, epochs=480, steps_per_epoch=1000,
        ),
    )
    _check_device_augment_flags(args, config)
    mesh, device = _init_distributed(args, config)
    rows = _rank_batch_size(config, mesh)
    roots = args.voc_root
    full_ds = DetectionDataset.from_voc(
        [os.path.join(r, "JPEGImages") for r in roots],
        [os.path.join(r, "ImageSets", "Main", "trainval.txt") for r in roots],
        [os.path.join(r, "Annotations") for r in roots],
    )
    ds = full_ds.shard(mesh.data_index, mesh.n_data)  # a pack cache covers the whole corpus
    # The anchors of the model the run trains (a `--config` may name any SSD300).
    sizes = ssd_predictor_sizes(ssd_family(config.model))
    encoder = TargetEncoder(AnchorSpec(), sizes, n_classes=20, device=device)
    augment_fn = None
    if args.device_augment:
        # The host ships 352-px (44-block) source maps; photometric, expand
        # + min-IoU crop + resize, hflip and target encoding run in the
        # train step on the card (ops/dct_detect_augment.py v3).
        from jpeg_detection_resnet_ssd_torch.ops import make_dct_detection_augment_v3

        encoder = TargetEncoder(AnchorSpec(img_height=304, img_width=304), sizes,
                                n_classes=20, device=device)
        augment_fn = make_dct_detection_augment_v3(
            out_y_blocks=38,
            expand_prob=0.5 if args.crop else 0.0,
            scale_range=(0.3, 1.0) if args.crop else (1.0, 1.0),
            photometric="pixel_hsv" if args.photometric == "pixel" else True,
            requantize_quality=args.requantize,
            device=device,
        )
        if args.pack_cache:
            # Decode-once corpus: epochs read memmapped coefficients instead
            # of decoding JPEGs (data/packed.py).
            from jpeg_detection_resnet_ssd_torch.data.packed import (
                PackedDctPipeline,
                load_or_create,
            )

            packed = load_or_create(
                args.pack_cache, full_ds, task="detection", img_height=352, img_width=352,
                num_workers=config.num_workers,
            )
            pipe = PackedDctPipeline(packed, rows, train=True, seed=config.seed,
                                     ship_dtype="int16", shard_index=mesh.data_index,
                                     shard_count=mesh.n_data)
        else:
            pipe = DetectionPipeline(
                ds, rows, train=True, encoder=encoder, augmentation=None,
                img_height=352, img_width=352, input_format=config.input_format,
                num_workers=config.num_workers, seed=config.seed, device_encode=True,
            )
    else:
        # Padded GT to the step, which encodes the targets on the device.
        pipe = DetectionPipeline(
            ds, rows, train=True, encoder=encoder,
            augmentation=SSDDataAugmentation(crop=args.crop),
            input_format=config.input_format, num_workers=config.num_workers,
            seed=config.seed, device_encode=True,
        )
    run_dir = _resume_or_create_run_dir(config, mesh)
    if mesh.rank == 0:
        print(f"run dir: {run_dir}")
    val_fn = None
    if args.val_image_set:
        root = roots[0]
        val_ds = DetectionDataset.from_voc(
            os.path.join(root, "JPEGImages"),
            os.path.join(root, "ImageSets", "Main", args.val_image_set),
            os.path.join(root, "Annotations"),
        )
        val_pipe = DetectionPipeline(
            val_ds, config.batch_size, train=False, encoder=encoder, augmentation=None,
            input_format=config.input_format, num_workers=config.num_workers,
            device_encode=True, drop_remainder=True,
        )
        val_fn = make_validation_fn(None, val_pipe)
    _, history = fit(
        config, pipe, val_fn=val_fn, run_dir=run_dir, max_steps=args.max_steps,
        init_variables=_maybe_import_pretrained(config), target_encoder=encoder,
        augment_fn=augment_fn, steps_per_call=args.steps_per_call, device=device, mesh=mesh,
    )
    if mesh.rank == 0:
        print(json.dumps(history[-1] if history else {}))


def _exported_infer(path):
    """(infer, manifest) of a serving artifact: `infer(inputs)` takes a
    batch of NumPy arrays or tensors (one, or a tuple of planes) and returns
    the artifact's output.  A fixed-batch artifact bakes its batch into its
    signature; a smaller batch (an evaluation's last) is zero-padded up to it
    and the rows trimmed back."""
    import torch

    from jpeg_detection_resnet_ssd_torch.serve import load_serving_artifact

    fn, manifest = load_serving_artifact(path)
    device = torch.device(manifest["device"])
    fixed_b = None if manifest["symbolic_batch"] else manifest["inputs"][0]["shape"][0]

    def infer(inputs):
        inputs = inputs if isinstance(inputs, (tuple, list)) else (inputs,)
        inputs = tuple(torch.as_tensor(x, device=device) for x in inputs)
        n = int(inputs[0].shape[0])
        if fixed_b is None or n == fixed_b:
            return fn(*inputs)
        if n > fixed_b:
            raise ValueError(
                f"batch {n} exceeds the artifact's baked batch {fixed_b}; re-export "
                f"with --symbolic-batch or a larger --batch-size"
            )
        padded = tuple(torch.cat([x, x.new_zeros((fixed_b - n, *x.shape[1:]))]) for x in inputs)
        return fn(*padded)[:n]

    return infer, manifest


def cmd_evaluate(args):
    """mAP of a training run's latest checkpoint on a VOC image set, with the
    reference's literal decode (`candidate_selector="exact"`), or of a
    serving artifact (`--exported`) on the run's input contract."""
    import torch

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.data import DetectionDataset, DetectionPipeline
    from jpeg_detection_resnet_ssd_torch.eval import (
        DetectionEvaluator,
        write_voc_detection_files,
    )
    from jpeg_detection_resnet_ssd_torch.models import make_inference_fn
    from jpeg_detection_resnet_ssd_torch.train.config import ExperimentConfig

    config = ExperimentConfig.load(os.path.join(args.run_dir, "saved_config.json"))
    if args.exported:
        # mAP straight from the serving artifact: the exported program is the
        # in-process path.  Export with --candidate-selector exact for the
        # literal reference protocol.
        infer, _ = _exported_infer(args.exported)
    else:
        trainer, module, _ = _restore_run(config, args.run_dir, args.device)
        module.eval()
        # mAP protocol: literal reference semantics (full per-class top-k),
        # not the faster shared candidate pool used for serving.
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


def cmd_evaluate_classify(args):
    """Top-1/top-5 of a classification run's latest checkpoint on an
    ImageFolder tree (the evaluation view, whole batches)."""
    import torch

    from jpeg_detection_resnet_ssd_torch.data import ClassificationPipeline, ImageFolderDataset
    from jpeg_detection_resnet_ssd_torch.eval import ClassificationEvaluator
    from jpeg_detection_resnet_ssd_torch.train.config import ExperimentConfig

    config = ExperimentConfig.load(os.path.join(args.run_dir, "saved_config.json"))
    trainer, module, _ = _restore_run(config, args.run_dir, args.device)
    module.eval()

    def infer(inputs):
        with torch.no_grad():
            return module(inputs)

    ds = ImageFolderDataset(args.val_dir, args.class_index_json)
    pipe = ClassificationPipeline(
        ds, args.batch_size, train=False, input_format=config.input_format,
        num_workers=config.num_workers, drop_remainder=True,
    )
    print(json.dumps(ClassificationEvaluator(infer, pipe)()))


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
    """Single-image detection: JPEG -> 300x300 image -> the model's input
    contract (DCT planes; RGB for `ssd300_vgg`, the DCT image for
    `ssd300_vgg_dct_image`, Cb and Cr apart for `ssd300_deconv`) -> model ->
    exact decode -> boxes drawn on the original image, saved as a PNG.
    With `--exported` the serving artifact takes the place of model and
    decode (its weights and decode settings are its own)."""
    import numpy as np
    import torch
    from PIL import Image, ImageDraw

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.data.augment import resize, to_3_channels
    from jpeg_detection_resnet_ssd_torch.data.datasets import VOC_CLASSES
    from jpeg_detection_resnet_ssd_torch.data.pipeline import _pack_inputs
    from jpeg_detection_resnet_ssd_torch.models import MODEL_REGISTRY, build_model, make_inference_fn

    with Image.open(args.image) as im:
        orig = np.asarray(im.convert("RGB"))
    img300, _, inverter = resize(
        to_3_channels(orig), np.zeros((0, 5), np.float32), 300, 300,
        return_inverter=True,
    )
    if args.exported:
        infer, manifest = _exported_infer(args.exported)
        model = manifest.get("model", args.model)
        inputs = _pack_inputs([img300], MODEL_REGISTRY[model].input_format)
        out = infer(inputs).cpu().numpy()[0]
    else:
        module, _ = build_model(args.model, n_classes=20, device=args.device)
        inputs = _pack_inputs([img300], MODEL_REGISTRY[args.model].input_format)
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


def cmd_export(args):
    """Export a serving artifact: a `torch.export` program with its weights
    (`model.pt2`) and `manifest.json` (see `serve/export.py`).

    Source is either a training run (`--run-dir`, restores the checkpoint
    like `evaluate`) or a fresh model (`--model`, optionally `--weights` H5).
    Detection models export forward + decode to (B, top_k, 6) detections;
    classification models export logits.  `--device` is where the artifact
    runs (default cuda; its decode's NMS is then the CUDA kernel).
    """
    import numpy as np

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.models import MODEL_REGISTRY, build_model, make_inference_fn
    from jpeg_detection_resnet_ssd_torch.serve import build_serving_fn, export_serving_artifact

    if args.run_dir:
        from jpeg_detection_resnet_ssd_torch.train.config import ExperimentConfig

        config = ExperimentConfig.load(os.path.join(args.run_dir, "saved_config.json"))
        trainer, module, example_inputs = _restore_run(config, args.run_dir, args.device)
        model_name, task = config.model, config.task
    else:
        # Detection factories take n_classes; classification factories do
        # not (they default to 1000 ImageNet classes).
        kw = {"n_classes": 20} if args.model.startswith("ssd300") else {}
        module, example_inputs = build_model(args.model, device=args.device, **kw)
        if args.weights:
            from jpeg_detection_resnet_ssd_torch.compat import import_weights_by_name

            import_weights_by_name(module, args.weights)
        model_name = args.model
        task = "detection" if model_name.startswith("ssd300") else "classification"

    decode = None
    if task == "detection":
        decode = make_inference_fn(
            n_classes=20, spec=AnchorSpec(),
            confidence_thresh=args.confidence, top_k=args.top_k,
            nms_impl=args.nms_impl, candidate_selector=args.candidate_selector,
            device=args.device,
        )
    if args.quantize == "int8":
        from jpeg_detection_resnet_ssd_torch.serve import quantize_for_serving

        if args.calib_voc_root:
            from jpeg_detection_resnet_ssd_torch.data import DetectionDataset, DetectionPipeline

            ds = DetectionDataset.from_voc(
                os.path.join(args.calib_voc_root, "JPEGImages"),
                os.path.join(args.calib_voc_root, "ImageSets", "Main", args.calib_image_set),
                os.path.join(args.calib_voc_root, "Annotations"),
            )
            pipe = DetectionPipeline(
                ds, args.batch_size, train=False, encoder=None,
                input_format=MODEL_REGISTRY[model_name].input_format, num_workers=2,
            )
            calib = []
            for batch in pipe:
                calib.append(batch["inputs"])
                if len(calib) >= args.calib_batches:
                    break
        else:
            print("warning: int8 calibration on synthetic example inputs; "
                  "pass --calib-voc-root for real activation ranges", file=sys.stderr)
            calib = [example_inputs()]
        qmodel, qinfo = quantize_for_serving(module, calib, fold_bn=not args.no_fold_bn)
        print(json.dumps({"quantized_convs": len(qinfo["quantized"]),
                          "kept_float": qinfo["kept_float"]}), file=sys.stderr)
        serving_fn = build_serving_fn(qmodel, decode, fold_bn=False)
    else:
        serving_fn = build_serving_fn(module, decode, fold_bn=not args.no_fold_bn)

    example = example_inputs()
    example = example if isinstance(example, tuple) else (example,)
    inputs = tuple(np.zeros((args.batch_size, *x.shape[1:]), x.dtype) for x in example)
    manifest = export_serving_artifact(
        serving_fn, inputs, args.output, device=args.device,
        symbolic_batch=args.symbolic_batch,
        manifest_extra={
            "model": model_name,
            "task": task,
            "fold_bn": not args.no_fold_bn,
            "quantize": args.quantize,
            "decode": None if decode is None else {
                "confidence_thresh": args.confidence,
                "top_k": args.top_k,
                "nms_impl": args.nms_impl,
                "candidate_selector": args.candidate_selector,
            },
        },
    )
    print(json.dumps({
        "output": args.output, "bytes": manifest["bytes"],
        "device": manifest["device"], "inputs": manifest["inputs"],
    }))


def cmd_bench(args):
    """Forward throughput and parameter count of a registry model at its
    seeded init (the JAX `bench`, role of the reference's
    `inference_time.py`): the eval-mode forward only, at `--batch-size`
    copies of the example input's first row; on the card `--runs` calls a
    CUDA-event window (`utils.timing.cuda_times_ms`), on the CPU a host-clock
    window; the best images/s of 3 windows.  Prints JSON with the JAX keys
    (`model`, `params`, `batch_size`, `images_per_sec`) and `device`, the
    card's name (or "cpu")."""
    import time

    import numpy as np
    import torch

    from jpeg_detection_resnet_ssd_torch.eval.imagenet_eval import count_params
    from jpeg_detection_resnet_ssd_torch.models import build_model
    from jpeg_detection_resnet_ssd_torch.utils.timing import cuda_times_ms

    kwargs = {"n_classes": 20} if args.model.startswith("ssd300") else {"num_classes": 1000}
    module, example = build_model(args.model, device=args.device, **kwargs)
    device = next(module.parameters()).device
    example_inputs = example()
    leaves = example_inputs if isinstance(example_inputs, tuple) else (example_inputs,)
    batch = tuple(torch.as_tensor(np.repeat(x[:1], args.batch_size, axis=0), device=device)
                  for x in leaves)
    inputs = batch if isinstance(example_inputs, tuple) else batch[0]

    def forward():
        with torch.no_grad():
            module(inputs)

    windows = 3
    if device.type == "cuda":
        window_ms = cuda_times_ms(forward, iters=args.runs, windows=windows)
        name = torch.cuda.get_device_name(device)
    else:
        forward()
        window_ms = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(args.runs):
                forward()
            window_ms.append((time.perf_counter() - t0) * 1e3 / args.runs)
        name = "cpu"
    print(json.dumps({
        "model": args.model,
        "params": count_params(module),
        "batch_size": args.batch_size,
        "images_per_sec": round(max(args.batch_size * 1e3 / t for t in window_ms), 1),
        "device": name,
    }))


def build_parser():
    p = argparse.ArgumentParser(prog="python -m jpeg_detection_resnet_ssd_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)

    tc = sub.add_parser("train-classify")
    _add_train_common(tc)
    tc.add_argument("--train-dir", required=True)
    tc.add_argument("--class-index-json", default=None)
    tc.add_argument("--device-augment", action="store_true",
                    help="DCT-domain random-resized crop, flip and photometric "
                         "inside the train step, on the card (256-px host "
                         "source, 224-px crops; no re-encode)")
    tc.add_argument("--pack-cache", default=None,
                    help="with --device-augment: stem path for a decode-once "
                         "memmapped DCT corpus (created if absent)")
    tc.set_defaults(fn=cmd_train_classify)

    td = sub.add_parser("train-detect")
    _add_train_common(td)
    td.add_argument("--voc-root", nargs="+", required=True)
    td.add_argument("--crop", dest="crop", action="store_true", default=True)
    td.add_argument("--no_crop", dest="crop", action="store_false")
    td.add_argument("--reg", dest="reg", action="store_true", default=True)
    td.add_argument("--no_reg", dest="reg", action="store_false")
    td.add_argument("--vgg", action="store_true",
                    help="train the DCT VGG SSD300 (ssd300_vgg_dct) instead of "
                         "ssd300_{--archi}")
    td.add_argument("--device-augment", action="store_true",
                    help="DCT-domain augmentation chain (photometric + expand + "
                         "min-IoU crop + flip) and target encoding inside the "
                         "train step, on the card")
    td.add_argument("--pack-cache", default=None,
                    help="with --device-augment: stem path for a decode-once "
                         "memmapped DCT corpus (created if absent)")
    td.add_argument("--photometric", default="dct", choices=["dct", "pixel"],
                    help="with --device-augment: 'dct' = coefficient-domain "
                         "photometric; 'pixel' = the reference's HSV semantics "
                         "on reconstructed pixels (ops/pixel_photometric.py)")
    td.add_argument("--requantize", default=None, type=int, metavar="Q",
                    help="with --device-augment: snap each augmented view's "
                         "coefficients to the JPEG quality-Q grid (ops/jpeg_quant.py)")
    td.add_argument("--val-image-set", default=None,
                    help="ImageSets/Main/<file> for per-epoch validation loss")
    td.set_defaults(fn=cmd_train_detect)

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
                    help="serving-artifact dir from `export`: run it in place of "
                         "the checkpoint (the run dir gives the input contract)")
    ev.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda; cpu for tests)")
    ev.set_defaults(fn=cmd_evaluate)

    ec = sub.add_parser("evaluate-classify")
    ec.add_argument("--run-dir", required=True)
    ec.add_argument("--val-dir", required=True)
    ec.add_argument("--class-index-json", default=None)
    ec.add_argument("--batch-size", type=int, default=64)
    ec.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda; cpu for tests)")
    ec.set_defaults(fn=cmd_evaluate_classify)

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
                     help="serving-artifact dir from `export` (no model build; "
                          "weights come from the artifact)")
    inf.add_argument("--confidence", type=float, default=0.2)
    inf.add_argument("--output", default="detections.png")
    inf.add_argument("--device", default="cuda",
                     help="where the model runs (default cuda; cpu for tests)")
    inf.set_defaults(fn=cmd_infer)

    ex = sub.add_parser("export")
    src = ex.add_mutually_exclusive_group(required=True)
    src.add_argument("--run-dir", default=None,
                     help="training run to export (restores the checkpoint)")
    src.add_argument("--model", default=None,
                     help="registry model name (seeded init; combine with "
                          "--weights for a Keras H5)")
    ex.add_argument("--weights", default=None)
    ex.add_argument("--output", required=True, help="artifact directory")
    ex.add_argument("--batch-size", type=int, default=32)
    ex.add_argument("--symbolic-batch", action="store_true",
                    help="export with a symbolic batch dimension (one "
                         "artifact serves any batch size)")
    ex.add_argument("--no-fold-bn", action="store_true",
                    help="skip BatchNorm folding (kept for A/B checks)")
    ex.add_argument("--quantize", default=None, choices=["int8"],
                    help="post-training int8 trunk quantization "
                         "(serve/quantize.py): ~4x smaller artifact; input "
                         "stems + heads stay float")
    ex.add_argument("--calib-voc-root", default=None,
                    help="VOC root for activation-range calibration "
                         "(recommended with --quantize; decodes JPEGs, so "
                         "needs libjpeg)")
    ex.add_argument("--calib-image-set", default="trainval.txt")
    ex.add_argument("--calib-batches", type=int, default=8)
    ex.add_argument("--confidence", type=float, default=0.01)
    ex.add_argument("--top-k", type=int, default=200)
    ex.add_argument("--nms-impl", default="auto", choices=["auto", "kernel", "reference"],
                    help="the decode's NMS: auto (the custom operator: the CUDA "
                         "kernel on the card, the plain version on the CPU), "
                         "kernel (the card only) or reference (plain, traced "
                         "into the graph)")
    ex.add_argument("--candidate-selector", default="exact",
                    choices=["exact", "shared"])
    ex.add_argument("--device", default="cuda",
                    help="where the artifact runs (default cuda; cpu for tests)")
    ex.set_defaults(fn=cmd_export)

    be = sub.add_parser("bench")
    be.add_argument("--model", default="ssd300_ssd_custom")
    be.add_argument("--batch-size", type=int, default=32)
    be.add_argument("--runs", type=int, default=10,
                    help="forward calls a timed window (3 windows, the best reported)")
    be.add_argument("--device", default="cuda",
                    help="where the model runs (default cuda; cpu for tests)")
    be.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
