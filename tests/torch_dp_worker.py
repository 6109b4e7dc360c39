"""Data- and tensor-parallel cases of the PyTorch port, one rank a process.

    python tests/torch_dp_worker.py CASE RANK WORLD STORE OUT [JSON_KWARGS]

joins a gloo group of WORLD ranks through the file store STORE (no port to
collide on), runs `CASES[CASE](**kwargs)` on its rows of the global batch
(with `n_model` > 1, on a mesh of WORLD / n_model data ranks whose model
axis shards the kernels of at least `min_features` outputs) and
`torch.save`s the result to `OUT.RANK`.  The tests call the same case
functions in their own process, without a process group, for the
single-process reference on the global batch.  NumPy, torch and the port
only (no jax), so the card-only tests can start these workers too.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from jpeg_detection_resnet_ssd_torch import ops  # noqa: E402
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder  # noqa: E402
from jpeg_detection_resnet_ssd_torch.losses import SSDLoss  # noqa: E402
from jpeg_detection_resnet_ssd_torch.models import layers  # noqa: E402
from jpeg_detection_resnet_ssd_torch.models.zoo import MODEL_REGISTRY, RegistryEntry  # noqa: E402
from jpeg_detection_resnet_ssd_torch.models.ssd import _FC6CenterTap  # noqa: E402
from jpeg_detection_resnet_ssd_torch.parallel import (  # noqa: E402
    data_parallel,
    make_mesh,
    model_shards,
    shard_batch,
    shard_parameters,
    tensor_parallel_rule,
)
from jpeg_detection_resnet_ssd_torch.train import (  # noqa: E402
    BF16MomentumSGD,
    ExperimentConfig,
    Trainer,
    build_trainer,
    checkpoint_state,
    classification_loss_fn,
    detection_loss_fn,
    fit,
)
from jpeg_detection_resnet_ssd_torch.utils import (  # noqa: E402
    is_primary_process,
    maybe_initialize_distributed,
    process_count,
    process_index,
)

TIMEOUT = datetime.timedelta(seconds=60)
REPO = Path(__file__).resolve().parent.parent

# The tiny detector's anchors: 64-px frames, two predictor maps (8x8, 4x4).
TINY_SPEC = AnchorSpec(img_height=64, img_width=64, scales=[0.2, 0.5, 0.9],
                       aspect_ratios=[[1.0, 2.0, 0.5], [1.0, 2.0, 0.5]], steps=[8, 16])
TINY_SIZES = ((8, 8), (4, 4))
N_CLASSES = 20


class TinySSD(nn.Module):
    """A few `Conv` + `BatchNorm` layers of the port on (Y (B, 8, 8, 64),
    CbCr (B, 4, 4, 128)) planes, two heads of 4 boxes a cell (named as the
    SSD neck and heads are, so the L2 penalty takes them): softmax
    scores, offsets and 8 zero columns where the SSD loss ignores the
    anchors, as the detectors' output is laid out."""

    def __init__(self, dtype=torch.float32, generator=None, n_classes=N_CLASSES):
        super().__init__()
        self.dtype, self.n_classes = dtype, n_classes
        g = generator
        self.conv_y = layers.Conv(64, 16, 3, generator=g)
        self.bn_y = layers.BatchNorm(16)
        self.conv_c = layers.Conv(128, 16, 1, generator=g)
        self.bn_c = layers.BatchNorm(16)
        self.conv6_2 = layers.Conv(32, 16, 3, strides=2, generator=g)
        self.bn_b = layers.BatchNorm(16)
        self.a_mbox_pred = layers.Conv(16, 4 * (n_classes + 5), 3, generator=g)
        self.b_mbox_pred = layers.Conv(16, 4 * (n_classes + 5), 3, generator=g)

    def forward(self, inputs):
        y, cbcr = (x.to(self.dtype) / 100 for x in inputs)
        a = torch.relu(self.bn_y(self.conv_y(y)))
        c = layers.upsample2x(torch.relu(self.bn_c(self.conv_c(cbcr))))
        b = torch.relu(self.bn_b(self.conv6_2(torch.cat([a, c], -1))))
        out = torch.cat([self.a_mbox_pred(a).reshape(a.shape[0], -1, self.n_classes + 5),
                         self.b_mbox_pred(b).reshape(b.shape[0], -1, self.n_classes + 5)], 1)
        scores = torch.softmax(out[..., :self.n_classes + 1].float(), -1)
        pad = scores.new_zeros(*scores.shape[:2], 8)
        return torch.cat([scores, out[..., self.n_classes + 1:].float(), pad], -1)


class TinyTPSSD(nn.Module):
    """`TinySSD`'s layout with an SSD neck's `fc6` (`_FC6CenterTap`, 32
    outputs, on the 4x4 map) before the second head, and 32-wide Y convs:
    at `min_features=32` the B4-eligible 3x3 `conv_y`, `fc6` and both heads
    are sharded over the model axis while `conv_c` and `conv6_2` stay
    replicated (the L2 penalty takes `fc6`, `conv6_2` and the heads)."""

    def __init__(self, dtype=torch.float32, generator=None, n_classes=N_CLASSES):
        super().__init__()
        self.dtype, self.n_classes = dtype, n_classes
        g = generator
        self.conv_y = layers.Conv(64, 32, 3, generator=g)
        self.bn_y = layers.BatchNorm(32)
        self.conv_c = layers.Conv(128, 16, 1, generator=g)
        self.bn_c = layers.BatchNorm(16)
        self.conv6_2 = layers.Conv(48, 16, 3, strides=2, generator=g)
        self.bn_b = layers.BatchNorm(16)
        self.fc6 = _FC6CenterTap(16, 32, dilation=6, generator=g)
        self.a_mbox_pred = layers.Conv(32, 4 * (n_classes + 5), 3, generator=g)
        self.b_mbox_pred = layers.Conv(32, 4 * (n_classes + 5), 3, generator=g)

    def forward(self, inputs):
        y, cbcr = (x.to(self.dtype) / 100 for x in inputs)
        a = torch.relu(self.bn_y(self.conv_y(y)))
        c = layers.upsample2x(torch.relu(self.bn_c(self.conv_c(cbcr))))
        b = torch.relu(self.fc6(torch.relu(self.bn_b(self.conv6_2(torch.cat([a, c], -1))))))
        out = torch.cat([self.a_mbox_pred(a).reshape(a.shape[0], -1, self.n_classes + 5),
                         self.b_mbox_pred(b).reshape(b.shape[0], -1, self.n_classes + 5)], 1)
        scores = torch.softmax(out[..., :self.n_classes + 1].float(), -1)
        pad = scores.new_zeros(*scores.shape[:2], 8)
        return torch.cat([scores, out[..., self.n_classes + 1:].float(), pad], -1)


class WideDetector(nn.Module):
    """The port's counterpart of the JAX trainer test's `TinyDetector`
    (`tests/test_trainer.py`): a 1024-wide 3x3 `fc6`, which the default
    rule shards, a global average pool and a `Dense` head of `n_boxes`
    boxes; anchor columns 0.1."""

    def __init__(self, n_classes=3, n_boxes=32, in_features=16, generator=None):
        super().__init__()
        self.n_classes, self.n_boxes = n_classes, n_boxes
        self.fc6 = layers.Conv(in_features, 1024, 3, generator=generator)
        self.head = layers.Dense(1024, n_boxes * (n_classes + 5), generator=generator)

    def forward(self, inputs):
        x = torch.relu(self.fc6(inputs[0])).mean(dim=(1, 2))
        out = self.head(x).reshape(x.shape[0], self.n_boxes, -1)
        conf = torch.softmax(out[..., :self.n_classes + 1], -1)
        loc = out[..., self.n_classes + 1:]
        return torch.cat([conf, loc, loc.new_full((*loc.shape[:-1], 8), 0.1)], -1)


class TinyClassifier(nn.Module):
    """`Conv` + `BatchNorm` on the planes, global average pool, `Dropout`
    and a `Dense` head: the classification step with dropout."""

    def __init__(self, dtype=torch.float32, generator=None, num_classes=10):
        super().__init__()
        g = generator
        self.conv = layers.Conv(64 + 128, 32, 3, generator=g)
        self.bn = layers.BatchNorm(32)
        self.drop = layers.Dropout(0.5)
        self.fc = layers.Dense(32, num_classes, generator=g)

    def forward(self, inputs):
        y, cbcr = (x.float() / 100 for x in inputs)
        x = torch.cat([y, layers.upsample2x(cbcr)], -1)
        x = torch.relu(self.bn(self.conv(x))).mean(dim=(1, 2))
        return self.fc(self.drop(x))


def _tiny_inputs(batch):
    def make(rng=None):
        rng = rng or np.random.default_rng(0)
        return (rng.normal(0, 100, (batch, 8, 8, 64)).astype(np.float32),
                rng.normal(0, 30, (batch, 4, 4, 128)).astype(np.float32))

    return make


@contextlib.contextmanager
def tiny_models():
    """`tiny_ssd` and `tiny_tp_ssd` in the model registry inside the block
    (so `fit` builds them), removed after it."""
    MODEL_REGISTRY["tiny_ssd"] = RegistryEntry(lambda **kw: (TinySSD(**kw), _tiny_inputs(2)), "dct")
    MODEL_REGISTRY["tiny_tp_ssd"] = RegistryEntry(
        lambda **kw: (TinyTPSSD(**kw), _tiny_inputs(2)), "dct")
    try:
        yield
    finally:
        del MODEL_REGISTRY["tiny_ssd"], MODEL_REGISTRY["tiny_tp_ssd"]


def gt_rows(rng, n_valid, img, max_gt=8):
    """Padded GT (B, max_gt, 5) in pixels of an `img`-px frame, `n_valid[i]`
    boxes in image i (0: an image without objects)."""
    gt = np.zeros((len(n_valid), max_gt, 5), np.float32)
    mask = np.zeros((len(n_valid), max_gt), bool)
    for i, k in enumerate(n_valid):
        xy0 = rng.uniform(0, img * 0.6, (k, 2))
        xy1 = np.minimum(xy0 + rng.uniform(img * 0.2, img * 0.6, (k, 2)), img)
        gt[i, :k] = np.concatenate([rng.integers(1, N_CLASSES + 1, (k, 1)), xy0, xy1], -1)
        mask[i, :k] = True
    return gt, mask


def detection_batches(steps, global_batch, seed=0, n_valid=None, source_blocks=12):
    """Seeded global batches of 12-block DCT source maps and padded GT; the
    last rows of each batch hold no objects when `n_valid` says so."""
    rng = np.random.default_rng(seed)
    n_valid = n_valid or [2] * global_batch
    out = []
    for _ in range(steps):
        gt, mask = gt_rows(rng, n_valid, 8 * source_blocks)
        out.append({
            "inputs": (rng.normal(0, 100, (global_batch, source_blocks, source_blocks, 64))
                       .astype(np.float32),
                       rng.normal(0, 30, (global_batch, source_blocks // 2, source_blocks // 2,
                                          128)).astype(np.float32)),
            "gt": gt, "gt_mask": mask,
        })
    return out


def _state(module):
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def _rule(min_features):
    return functools.partial(tensor_parallel_rule, min_features=min_features)


def _whole(trainer):
    """The trainer's whole parameters and statistics, the momentum buffers
    by state_dict key, and the shapes this rank holds of each (a collective
    under tensor parallelism: every rank calls it)."""
    state = checkpoint_state(trainer)
    keys = {id(p): k for k, p in trainer.model.named_parameters()}
    params = [p for group in trainer.optimizer.param_groups for p in group["params"]]
    local = {keys[id(p)]: trainer.optimizer.state[p]["momentum_buffer"] for p in params
             if "momentum_buffer" in trainer.optimizer.state[p]}
    whole = {keys[id(params[i])]: s["momentum_buffer"].cpu().clone()
             for i, s in state["optimizer"]["state"].items()}
    return {"state": {k: v.detach().cpu().clone() for k, v in state["model"].items()},
            "momentum": whole,
            "shapes": {"weights": {k: tuple(p.shape) for k, p in trainer.model.named_parameters()},
                       "momentum": {k: tuple(v.shape) for k, v in local.items()},
                       "momentum_dtype": {k: v.dtype for k, v in local.items()}}}


def _encoder(device):
    return TargetEncoder(TINY_SPEC, TINY_SIZES, n_classes=N_CLASSES, device=device)


def detect_steps(steps=3, global_batch=4, device="cpu", n_valid=None, l2=5e-4, tp=False,
                 n_model=1, min_features=32, momentum_dtype="float32", noise=0.0):
    """`steps` train steps of `TinySSD` (with `tp`, `TinyTPSSD` with the B4
    route on, its kernels of at least `min_features` outputs sharded over
    `n_model` model ranks) through the v3 device augment (12 -> 8 blocks),
    the target encoder and the SSD loss with the L2 penalty, on this rank's
    rows of seeded global batches.  Returns the per-step metrics, the final
    weights and BatchNorm statistics (whole) and, with `tp`, the momentum
    and the shapes this rank holds.  `noise` times the model index is added
    to every replicated parameter's gradient, as a nondeterministic kernel
    would make the ranks' gradients differ."""
    mesh = make_mesh(n_model=n_model)
    model = (TinyTPSSD if tp else TinySSD)(generator=torch.Generator().manual_seed(0))
    shard_parameters(model, mesh, _rule(min_features))
    if noise:
        shards = model_shards(model)
        for name, p in model.named_parameters():
            if name not in shards:
                p.register_hook(lambda g, eps=noise * mesh.model_index: g + eps)
    optimizer = (BF16MomentumSGD(model.parameters(), lr=0.05, momentum=0.9)
                 if momentum_dtype == "bfloat16"
                 else torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9))
    trainer = Trainer(
        model=model,
        loss_fn=detection_loss_fn(SSDLoss(), l2_scale=l2),
        optimizer=optimizer,
        target_encoder=_encoder(device),
        augment_fn=ops.make_dct_detection_augment_v3(8, device=device),
        pallas_wgrad=tp, device=device, mesh=mesh,
    )
    batches = [shard_batch(b, mesh) for b in detection_batches(steps, global_batch, 0, n_valid)]
    metrics = trainer.train_steps(batches, seed=7)
    return {"metrics": {k: v.cpu() for k, v in metrics.items()}, **_whole(trainer)}


def ssd_custom_step(steps=1, global_batch=2, device="cpu", compute_dtype="float32",
                    pallas_wgrad=False, n_model=1, min_features=1024):
    """`steps` train steps of the full `ssd300_ssd_custom` (`build_trainer`)
    through the v3 device augment (44 -> 38 blocks) on this rank's rows,
    its kernels of at least `min_features` outputs sharded over `n_model`
    model ranks; the state whole."""
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes

    mesh = make_mesh(n_model=n_model)
    encoder = TargetEncoder(AnchorSpec(img_height=304, img_width=304),
                            ssd_predictor_sizes("resnet_custom"), device=device)
    config = ExperimentConfig(compute_dtype=compute_dtype, batch_size=global_batch,
                              pallas_wgrad=pallas_wgrad, n_model_shards=n_model)
    trainer, module, _ = build_trainer(
        config, target_encoder=encoder, augment_fn=ops.make_dct_detection_augment_v3(38, device=device),
        device=device, mesh=mesh, tp_rule=_rule(min_features))
    batches = [shard_batch(b, mesh)
               for b in detection_batches(steps, global_batch, 0, source_blocks=44)]
    metrics = trainer.train_steps(batches, seed=config.seed + 1)
    state = checkpoint_state(trainer)["model"]
    return {"metrics": {k: v.cpu() for k, v in metrics.items()},
            "state": {k: v.detach().cpu().clone() for k, v in state.items()},
            "n_params": sum(p.numel() for p in module.parameters())}


def classify_steps(steps=3, global_batch=4, device="cpu", n_model=1, min_features=10):
    """`steps` classification steps of `TinyClassifier` (dropout 0.5,
    Nesterov SGD) on this rank's rows of seeded global batches, its conv
    and Dense kernels of at least `min_features` outputs sharded over
    `n_model` model ranks."""
    mesh = make_mesh(n_model=n_model)
    model = TinyClassifier(generator=torch.Generator().manual_seed(0))
    shard_parameters(model, mesh, _rule(min_features))
    trainer = Trainer(
        model=model, loss_fn=classification_loss_fn(),
        optimizer=torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True),
        device=device, mesh=mesh,
    )
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(steps):
        inputs = _tiny_inputs(global_batch)(rng)
        labels = rng.integers(0, 10, global_batch).astype(np.int32)
        batches.append(shard_batch({"inputs": inputs, "labels": labels}, mesh))
    metrics = trainer.train_steps(batches, seed=3)
    return {"metrics": {k: v.cpu() for k, v in metrics.items()}, **_whole(trainer)}


def mining_problem(global_batch=4, n_anchors=64, n_classes=3):
    """(y_true, y_pred) of a global batch where the last half of the rows
    hold no positive, and the negatives' class losses take four values, so
    the hard-negative threshold falls inside a group of ties spread over all
    rows."""
    rng = np.random.default_rng(5)
    y_true = np.zeros((global_batch, n_anchors, n_classes + 1 + 12), np.float32)
    y_true[:, :, 0] = 1.0
    for i in range(global_batch // 2):
        for j in rng.choice(n_anchors, 3, replace=False):
            y_true[i, j, :n_classes + 1] = np.eye(n_classes + 1)[1 + j % n_classes]
    y_true[:, :, n_classes + 1:n_classes + 5] = rng.normal(0, 1, (global_batch, n_anchors, 4))
    levels = np.array([0.9, 0.7, 0.5, 0.3], np.float32)
    background = levels[rng.integers(0, 4, (global_batch, n_anchors))]
    rest = (1 - background)[..., None] * np.full(n_classes, 1.0 / n_classes, np.float32)
    y_pred = np.concatenate([background[..., None], rest,
                             rng.normal(0, 1, (global_batch, n_anchors, 12))], -1)
    return y_true, y_pred.astype(np.float32)


def mining_loss(global_batch=4):
    """The SSD loss on this rank's rows of `mining_problem` inside
    `data_parallel`: the rank's loss share and its rows' gradient."""
    mesh = make_mesh()
    y_true, y_pred = (torch.from_numpy(a) for a in shard_batch(mining_problem(global_batch), mesh))
    y_pred.requires_grad_(True)
    with data_parallel(mesh):
        loss = SSDLoss()(y_true, y_pred)
    loss.backward()
    return {"loss": loss.detach(), "grad": y_pred.grad}


def fit_run(run_dir, epochs, restart=False, global_batch=4, model="tiny_ssd", n_model=1,
            min_features=32):
    """`fit` of the registry's `model` with checkpoints in `run_dir`, one
    step an epoch, its kernels of at least `min_features` outputs sharded
    over `n_model` model ranks, counting `CheckpointManager.save` calls on
    this rank.  Returns the history, the saves and the final state
    (whole)."""
    from jpeg_detection_resnet_ssd_torch.train import checkpoints

    mesh = make_mesh(n_model=n_model)
    saves = []
    original = checkpoints.CheckpointManager.save

    def counting_save(self, step, trainer, *args):
        saves.append(step)
        return original(self, step, trainer, *args)

    config = ExperimentConfig(model=model, compute_dtype="float32", batch_size=global_batch,
                              epochs=epochs, steps_per_epoch=1, learning_rate=0.05,
                              restart=restart, n_model_shards=n_model, model_kwargs={})
    batches = [shard_batch(b, mesh) for b in detection_batches(epochs, global_batch, 2)]

    class Epochs:  # epoch e yields batch e, as a seeded pipeline would
        epoch = 0

        def __iter__(self):
            batch = batches[Epochs.epoch % len(batches)]
            Epochs.epoch += 1
            return iter([batch])

    Epochs.epoch = 0
    if restart:  # the epochs before the checkpoint are not iterated again
        from jpeg_detection_resnet_ssd_torch.train.checkpoints import CheckpointManager

        Epochs.epoch = CheckpointManager(os.path.join(run_dir, "checkpoints")).latest_step()
    checkpoints.CheckpointManager.save = counting_save
    try:
        with tiny_models():
            trainer, history = fit(config, Epochs(), run_dir=run_dir, log_every=1,
                                   target_encoder=_encoder("cpu"),
                                   augment_fn=ops.make_dct_detection_augment_v3(8, device="cpu"),
                                   device="cpu", mesh=mesh, tp_rule=_rule(min_features))
    finally:
        checkpoints.CheckpointManager.save = original
    return {"history": history, "saves": saves, **_whole(trainer)}


def pack_corpus(stem, voc_root):
    """`load_or_create` of a VOC tree's corpus on every rank, counting the
    ranks that packed."""
    from jpeg_detection_resnet_ssd_torch.data import DetectionDataset
    from jpeg_detection_resnet_ssd_torch.data.packed import PackedDctDataset, load_or_create

    ds = DetectionDataset.from_voc(os.path.join(voc_root, "JPEGImages"),
                                   os.path.join(voc_root, "ImageSets", "Main", "trainval.txt"),
                                   os.path.join(voc_root, "Annotations"))
    packed_here = []
    original = PackedDctDataset.create.__func__

    def counting_create(cls, *args, **kwargs):
        packed_here.append(True)
        return original(cls, *args, **kwargs)

    PackedDctDataset.create = classmethod(counting_create)
    try:
        packed = load_or_create(stem, ds, task="detection", img_height=64, img_width=64,
                                num_workers=1, verbose=False)
    finally:
        PackedDctDataset.create = classmethod(original)
    return {"packed_here": bool(packed_here), "n": len(packed),
            "y0": np.asarray(packed.y[0]).copy()}


def mesh_layout(n_model, bad_n_data):
    """`make_mesh(n_model=n_model)` as this rank sees it: its indices and
    the ranks of its data and model groups; and the error of a mesh of
    `bad_n_data` x `n_model`."""
    mesh = make_mesh(n_model=n_model)

    def members(group):
        return [mesh.rank] if group is None else torch.distributed.get_process_group_ranks(group)

    try:
        make_mesh(n_data=bad_n_data, n_model=n_model)
        error = None
    except ValueError as e:
        error = str(e)
    return {"shape": mesh.shape, "rank": mesh.rank, "data_index": mesh.data_index,
            "model_index": mesh.model_index, "data_group": members(mesh.data_group),
            "model_group": members(mesh.model_group), "error": error}


def _tree(path):
    """A nested dict of the arrays an .npz file holds under '/'-joined keys."""
    tree = {}
    with np.load(path) as f:
        for key in f.files:
            *scope, leaf = key.split("/")
            node = tree
            for part in scope:
                node = node.setdefault(part, {})
            node[leaf] = f[key]
    return tree


def wide_steps(variables, batch, steps=2, n_model=1):
    """`steps` SGD steps (lr 1e-3, momentum 0.9) of `WideDetector` from the
    flax `variables` (.npz) on `batch` (.npz: y, cbcr, targets), the SSD
    loss and the L2 penalty, its 1024-wide `fc6` sharded by the default rule
    over `n_model` model ranks: the port's side of the JAX tensor-parallel
    step.  Returns the per-step metrics and the whole final weights."""
    from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables

    mesh = make_mesh(n_model=n_model)
    model = load_flax_variables(WideDetector(), _tree(variables))
    shard_parameters(model, mesh)
    trainer = Trainer(model=model, loss_fn=detection_loss_fn(SSDLoss(), l2_scale=5e-4),
                      optimizer=torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9),
                      device="cpu", mesh=mesh)
    with np.load(batch) as f:
        rows = {"inputs": (f["y"], f["cbcr"]), "targets": f["targets"]}
    metrics = trainer.train_steps([rows] * steps, seed=0)
    return {"metrics": {k: v.cpu() for k, v in metrics.items()}, **_whole(trainer)}


def batch_norm_inputs(shape=(8, 19, 19, 256), dtype="bfloat16", device="cpu", seed=0):
    """A seeded global (x, dy) and BatchNorm state: x with a per-channel
    offset and a constant channel of 0.1 (inexact sums), and the
    parameters and running statistics on `device`."""
    gen = torch.Generator().manual_seed(seed)
    c, dt = shape[-1], getattr(torch, dtype)
    x = (2 * torch.randn(shape, generator=gen) + torch.randn(c, generator=gen)).to(device, dt)
    x[..., 1] = 0.1
    dy = torch.randn(shape, generator=gen).to(device, dt)
    state = {"weight": (1 + 0.1 * torch.randn(c, generator=gen)).to(device),
             "bias": (0.1 * torch.randn(c, generator=gen)).to(device),
             "running_mean": (0.1 * torch.randn(c, generator=gen)).to(device),
             "running_var": (1 + torch.rand(c, generator=gen)).to(device),
             "num_batches_tracked": torch.tensor(3, device=device)}
    return x, dy, state


def batch_norm_op(impl="auto", **kwargs):
    """One train-mode BatchNorm (`ops.batch_norm`) forward and backward of
    this rank's rows of `batch_norm_inputs(**kwargs)` inside
    `data_parallel(make_mesh())`: y and dx of the rank's rows, its dweight
    and dbias, the moved state and the kernels' launches."""
    from jpeg_detection_resnet_ssd_torch.ops import batch_norm
    from jpeg_detection_resnet_ssd_torch.parallel import active_mesh

    x, dy, state = batch_norm_inputs(**kwargs)
    mesh = make_mesh()
    x = shard_batch(x, mesh).clone().requires_grad_(True)
    w, b = state["weight"].requires_grad_(True), state["bias"].requires_grad_(True)
    before = batch_norm.LAUNCHES
    with data_parallel(mesh):
        y = batch_norm.batch_norm_train(x, w, b, state["running_mean"], state["running_var"],
                                        state["num_batches_tracked"], 0.01, 1e-3,
                                        mesh=active_mesh(), impl=impl)
    y.backward(shard_batch(dy, mesh))
    out = {"y": y.detach(), "dx": x.grad, "dweight": w.grad, "dbias": b.grad,
           **{k: state[k] for k in ("running_mean", "running_var", "num_batches_tracked")}}
    return {"out": {k: v.cpu() for k, v in out.items()}, "launches": batch_norm.LAUNCHES - before}


CASES = {
    "batch_norm": batch_norm_op,
    "detect": detect_steps,
    "ssd_custom": ssd_custom_step,
    "classify": classify_steps,
    "mining": mining_loss,
    "fit": fit_run,
    "pack": pack_corpus,
    "mesh": mesh_layout,
    "wide": wide_steps,
}


def run_ranks(case, tmp_dir, procs, world=2, timeout=90, **kwargs):
    """Start `world` processes of this worker on `case` with `kwargs` (file
    store and logs under `tmp_dir`), wait for each at most `timeout` s
    (killing them all and raising on the first late or failed one) and
    return their results.  Every process started is appended to `procs`."""
    import subprocess

    call = f"{case}{len(procs)}"  # a store of its own: a used one holds the last group's keys
    store, out = os.path.join(tmp_dir, f"{call}.store"), os.path.join(tmp_dir, f"{call}.out")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(os.path.join(tmp_dir, f"{call}.{r}.log"), "w+") for r in range(world)]
    started = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world), store, out,
         json.dumps(kwargs)], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    procs.extend(started)
    try:
        for r, p in enumerate(started):
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} of {case} did not finish in {timeout} s") from None
            if p.returncode != 0:
                logs[r].seek(0)
                raise RuntimeError(f"rank {r} of {case} failed:\n{logs[r].read()}")
    finally:
        for p in started:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        for log in logs:
            log.close()
    results = []
    for r in range(world):  # a full model's state is ~200 MB a rank: load, then delete
        results.append(torch.load(f"{out}.{r}", weights_only=False))
        os.remove(f"{out}.{r}")
    return results


def batch_norm_ranks_against_one_process(tmp_dir, **kw):
    """`batch_norm_op(**kw)` on two gloo ranks and in this process on the
    global batch: the ranks' gaps to one process (`chip_smoke.bn_gaps`: y
    and dx their rows joined, dweight and dbias summed over the ranks, the
    state rank 0's), the ranks' outputs and each side's launches."""
    from chip_smoke import bn_conditioning, bn_gaps

    ranks = run_ranks("batch_norm", tmp_dir, [], timeout=120, **kw)
    one = batch_norm_op(**kw)
    outs = [r["out"] for r in ranks]
    joined = {**outs[0], "y": torch.cat([o["y"] for o in outs]),
              "dx": torch.cat([o["dx"] for o in outs]),
              "dweight": outs[0]["dweight"] + outs[1]["dweight"],
              "dbias": outs[0]["dbias"] + outs[1]["dbias"]}
    x = batch_norm_inputs(**{k: v for k, v in kw.items() if k != "impl"})[0]
    return bn_gaps(joined, one["out"], bn_conditioning(x.cpu())), outs, (
        [r["launches"] for r in ranks], one["launches"])


def run_cli_ranks(argv, tmp_path, outs, world=2, timeout=120):
    """The CLI command `argv` and its `--restart`, `world` ranks each under
    the environment `torchrun` sets; appends rank 0's (run dir line, last
    row) to `outs`.  The other ranks must print nothing."""
    for extra in (["--epochs", "1"], ["--epochs", "2", "--restart"]):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen(argv + extra, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True, cwd=str(tmp_path),
                                  env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                                           LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                                           MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                                           PYTHONPATH=str(REPO)))
                 for r in range(world)]
        try:
            done = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
        for r, (p, (out, err)) in enumerate(zip(procs, done)):
            assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
        assert all(out.strip() == "" for out, _ in done[1:])  # rank 0 alone prints
        lines = done[0][0].strip().splitlines()
        outs.append((lines[0], json.loads(lines[-1])))


def main(argv):
    case, rank, world, store, out = argv[:5]
    kwargs = json.loads(argv[5]) if len(argv) > 5 else {}
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_distributed(init_method=f"file://{store}", world_size=world, rank=rank,
                                 backend="gloo", timeout=TIMEOUT)
    try:
        result = CASES[case](**kwargs)
        # the process-group helpers as this rank sees them
        result["dist"] = {"again": maybe_initialize_distributed(), "index": process_index(),
                          "count": process_count(), "primary": is_primary_process()}
        torch.save(result, f"{out}.{rank}")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
