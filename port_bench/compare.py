"""What decides `correct`: the program's outputs against the plain reference.

The reference network is the configuration's (`reference/net_<network>.py`).

Training (`train`): the reference repeats the kept steps from the same
seeded pool slots, boxes, labels, weights and draws: its own augment (in
float64), its own target encoding (float64), and SGD on its own network
(float32, TF32 off).  Compared, each as a share of the reference's value:

  loss_gap     the widest gap of a step's loss
  forward_gap  the widest gap of one image's network outputs in the first
               step (train mode: BatchNorm on batch statistics), as a share
               of their norm, the worst output
  grad_gap     the widest gap of a leaf's first-gradient norm
  grad_median_gap  the median leaf's gap of its first-gradient norm
  update_gap   the widest gap of a leaf's change over the kept steps
  planes_gap   the widest gap of one image's augmented plane
  box_gap      the widest gap of an augmented box coordinate, in frames
               (a box kept on one side only counts 1)
  target_gap   the share of the reference's non-background anchors whose
               matched class or offsets differ, in the worst step

A norm's gap is measured against the reference's norm of that leaf or of
the median leaf, whichever is larger.  Leaves whose reference gradient is
under a thousandth of the median leaf's (biases under a train-mode
BatchNorm) are left out of both: they move by rounding alone.

Serving (`serve`): for one kept batch at each pool slot, the reference's
forward (float32) of the same planes with the same weights and BatchNorm
statistics, and the reference's decode of the raw output the program's
model produced in that batch.  Compared, per image, worst image:

  <output>_gap each network output's gap (`OUTPUTS` of the network:
               score and offset of a detector, logit of a classifier), as
               a share of its norm
  decode_gap   the share of served detections with no detection of the
               same class and score at IoU >= 0.9 in the reference's
               decode of the same raw output, both ways
  top5_gap     how far the reference's logit of a served top-5 class lies
               below the reference's 5th best, in its logits' deviations

The decode is judged on the program's own raw output because a greedy NMS
and a top-k are not continuous in the scores: the reference's decode of
its own forward picks other boxes at the cut.  The forward that made that
raw output is judged by itself, against the reference's.
"""

from __future__ import annotations

import contextlib
import statistics

import torch

from port_bench import inputs
from port_bench.counts import kernels
from port_bench.reference import augment, nets, ssd
from port_bench.reference import train as ref_train

CHUNK = 32


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32 (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel_rows(a, b):
    """Per-row ||a - b|| / ||b|| of two (N, ...) tensors, float64."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return (a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)


def _worst_rows(a, b) -> float:
    """The widest per-row gap; infinite where the shapes differ (a batch
    that lost rows, say)."""
    if tuple(a.shape) != tuple(b.shape):
        return float("inf")
    return float(_rel_rows(a.to(b.device), b).max())


def leaf_gaps(prog: dict, ref: dict, ref_grad: dict) -> dict:
    """|prog - ref| / max(ref, median) of each leaf that moves."""
    med = float(torch.tensor(list(ref_grad.values())).median())
    keys = [k for k in ref if ref_grad[k] >= 1e-3 * med]
    med_r = float(torch.tensor([ref[k] for k in keys]).median())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med_r) for k in keys}


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def hyper(cfg: dict) -> dict:
    t = cfg["train"]
    return {"lr": t["learning_rate"], "momentum": t["momentum"], "nesterov": t["nesterov"],
            "lr_decay": t["lr_decay"], "l2": t["l2_regularization"], "n_classes": cfg["n_classes"]}


def reference_train(spec, seed, W, pool, gts, device, prec=nets.FLOAT32,
                    aug_dtype=torch.float64, enc_dtype=torch.float64) -> dict:
    """The kept steps computed by the reference (or, with lower dtypes, by
    the control): planes, boxes, targets, losses, the first step's network
    outputs, first gradient, change."""
    cfg, mix, network = spec["config"], spec["traffic"], spec["network"]
    task, B, ob = cfg["task"], mix["batch"], mix["out_blocks"]
    batches, planes, targets = [], [], []
    for s in range(mix["compare_steps"]):
        slot = s % len(pool)
        y, c = (t.to(device) for t in pool[slot])
        g = inputs.step_generator(seed, s)
        h8 = y.shape[1]
        if task == "detection":
            gt, mask = (torch.as_tensor(a).to(device) for a in gts[slot])
            d = augment.sample_detection_v3(g, B, h8, h8)
            ya, ca, ga, ma = augment.detection_v3(y, c, gt, mask, d, ob, aug_dtype)
            t = ssd.encode(network.ANCHORS, ga, ma, ob * 8, cfg["n_classes"], enc_dtype)
            batches.append({"y": ya.float(), "cbcr": ca.float(), "targets": t.float()})
            planes.append((ya.float(), ca.float(), ga.float(), ma))
            targets.append(t.float())
        else:
            d = augment.sample_classification_v2(g, B, h8, h8)
            ya, ca = augment.classification_v2(y, c, d, ob, aug_dtype)
            batches.append({"y": ya.float(), "cbcr": ca.float(),
                            "labels": torch.as_tensor(gts[slot]).to(device)})
            planes.append((ya.float(), ca.float()))
        del y, c
    with exact_float32():
        losses, outputs, grad1, change = ref_train.run(network, W, batches, hyper(cfg), prec)
    return {"planes": planes, "targets": targets, "losses": losses, "outputs": outputs,
            "grad1": grad1, "change": change}


def _target_gap(tp, tr, n_cls):
    """Share of the reference's non-background anchors whose one-hot row
    differs, or whose offsets differ by more than 1e-3 on a positive."""
    if tp.shape != tr.shape:
        return float("inf")
    tp, tr = tp.to(tr.device).double(), tr.double()
    pos_or_neutral = tr[..., 0] < 0.5
    cls_diff = (tp[..., :n_cls] - tr[..., :n_cls]).abs().amax(-1) > 0.5
    positive = tr[..., 1:n_cls].amax(-1) > 0.5
    off_diff = positive & ((tp[..., n_cls:n_cls + 4] - tr[..., n_cls:n_cls + 4]).abs().amax(-1) > 1e-3)
    return float((cls_diff | off_diff).sum()) / max(1.0, float(pos_or_neutral.sum()))


def state_gaps(prog: dict, ref: dict) -> dict:
    """The gaps of the losses, the first gradient and the change."""
    grads = leaf_gaps(prog["grad1"], ref["grad1"], ref["grad1"]).values()
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
        "grad_gap": max(grads),
        "grad_median_gap": statistics.median(grads),
        "update_gap": max(leaf_gaps(prog["change"], ref["change"], ref["grad1"]).values()),
    }


def _outputs_gap(prog: tuple, ref: tuple) -> float:
    """The widest per-image gap over a network's outputs."""
    return max(_worst_rows(p, r) for p, r in zip(prog, ref))


def train_numbers(spec, prog: dict, ref: dict) -> dict:
    """The compared numbers of a training cell (see the module docstring).
    `prog["outputs"]` is the program's first-step output tensor, or a tuple
    already split as the reference's."""
    cfg, network = spec["config"], spec["network"]
    task, frame_px, n_classes = cfg["task"], spec["traffic"]["out_blocks"] * 8, cfg["n_classes"]
    out = state_gaps(prog, ref)
    outputs = prog["outputs"]
    if isinstance(outputs, torch.Tensor):
        outputs = network.split(outputs, n_classes)
    out["forward_gap"] = _outputs_gap(outputs, ref["outputs"])
    gaps, boxes = [], []
    for p, r in zip(prog["planes"], ref["planes"]):
        for k in (0, 1):
            gaps.append(_worst_rows(p[k], r[k]))
        if task == "detection":
            if p[2].shape != r[2].shape:
                boxes.append(float("inf"))
                continue
            pg, pm = p[2].to(r[2].device), p[3].to(r[3].device)
            rg, rm = r[2], r[3]
            diff = ((pg - rg).abs().amax(-1) / frame_px).double()
            boxes.append(float(torch.where(pm != rm, 1.0, torch.where(rm, diff, 0.0)).max()))
    out["planes_gap"] = max(gaps)
    if task == "detection":
        out["box_gap"] = max(boxes)
        out["target_gap"] = max(_target_gap(tp, tr, n_classes + 1)
                                for tp, tr in zip(prog["targets"], ref["targets"]))
    return out


def train(spec, seed, W, pool, gts, prog: dict, device):
    """The numbers of a training run from what its set-up kept (`prog`:
    planes, targets, losses, outputs, grad1, change), and the three leaves
    of widest first-gradient and change gaps."""
    ref = reference_train(spec, seed, W, pool, gts, device)
    worst = {}
    for name, key in (("grad", "grad1"), ("update", "change")):
        gaps = leaf_gaps(prog[key], ref[key], ref["grad1"])
        worst[name] = sorted(((round(v, 5), k) for k, v in gaps.items()), reverse=True)[:3]
    worst["losses"] = [prog["losses"], ref["losses"]]
    return train_numbers(spec, prog, ref), worst


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _planes(pair, device):
    return tuple(t.to(device).float() for t in pair)


def calibrate(spec, W, pair, n_images, device) -> None:
    """Set W's BatchNorm running statistics to the reference's batch
    statistics of the first `n_images` of a pool slot (float32)."""
    y, c = (t[:n_images] for t in _planes(pair, device))
    stats: dict = {}
    net = nets.Net(W, nets.FLOAT32, train=True, stats=stats)
    with torch.no_grad(), exact_float32():
        spec["network"].forward(net, y, c, spec["config"]["n_classes"])
    for name, (mean, var) in stats.items():
        W[name + ".running_mean"] = mean
        W[name + ".running_var"] = var


def reference_forward(spec, W, pair, device, prec=nets.FLOAT32) -> tuple:
    """The reference's eval forward of one batch, in chunks of images: the
    network's outputs (scores and offsets, or logits)."""
    y, c = _planes(pair, device)
    net = nets.Net(W, prec)
    outs = []
    with torch.no_grad(), exact_float32():
        for i in range(0, y.shape[0], CHUNK):
            outs.append(spec["network"].forward(net, y[i:i + CHUNK], c[i:i + CHUNK],
                                                spec["config"]["n_classes"]))
    return tuple(torch.cat(parts) for parts in zip(*outs))


COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def reference_decode(spec, scores, offsets):
    """The reference's decode of (scores, offsets) in float64, in chunks,
    and the keep masks of its NMS (for B1's least work).  The anchors are
    rounded to the configuration's compute dtype, in which the head emits
    them."""
    cfg = spec["config"]
    dets, keeps = [], []
    with torch.no_grad():
        for i in range(0, scores.shape[0], CHUNK):
            d, keep = ssd.decode(spec["network"].ANCHORS, scores[i:i + CHUNK],
                                 offsets[i:i + CHUNK], cfg["n_classes"],
                                 pool=spec["traffic"]["shared_pool"], return_keep=True,
                                 anchor_dtype=COMPUTE_DTYPES[cfg["compute_dtype"]])
            dets.append(d)
            keeps.append(keep)
    return torch.cat(dets), torch.cat(keeps)


def _decode_gap(served, ref):
    """Per image, the share of detections (served or reference) with no
    detection of the same class and score at IoU >= 0.9 on the other side."""
    served, ref = served.double().to(ref.device), ref.double()
    ious = ssd.iou(served[..., 2:], ref[..., 2:])  # (B, K, K)
    same = ((served[..., None, 0] == ref[..., None, :, 0])
            & ((served[..., None, 1] - ref[..., None, :, 1]).abs() <= 1e-6)
            & (ious >= 0.9))
    live_s, live_r = served[..., 1] > 0, ref[..., 1] > 0
    same = same & live_s[..., :, None] & live_r[..., None, :]
    miss = (live_s & ~same.any(2)).sum(1) + (live_r & ~same.any(1)).sum(1)
    return miss.double() / (live_s.sum(1) + live_r.sum(1)).clamp_min(1).double()


def serve_numbers(spec, raw: dict, served: dict, ref_raw: dict):
    """The compared numbers of a serving cell, worst image over the kept
    batches, and B1's least seconds for each kept pool slot."""
    cfg, network = spec["config"], spec["network"]
    gaps: dict = {f"{name}_gap": [] for name in network.OUTPUTS}
    gaps["decode_gap" if cfg["task"] == "detection" else "top5_gap"] = []
    nms_least = {}
    for slot, r in raw.items():
        prog, ref = network.split(r, cfg["n_classes"]), ref_raw[slot]
        for name, p, q in zip(network.OUTPUTS, prog, ref):
            gaps[f"{name}_gap"].append(_worst_rows(p, q))
        if cfg["task"] == "detection":
            ps, po = (t.to(ref[0].device) for t in prog)
            if ps.shape != ref[0].shape:
                gaps["decode_gap"].append(float("inf"))
                continue
            dets, keep = reference_decode(spec, ps, po)
            gaps["decode_gap"].append(float("inf") if served[slot].shape != dets.shape
                                      else float(_decode_gap(served[slot], dets).max()))
            nbytes, ops = kernels.nms(keep.reshape(-1, keep.shape[-1]),
                                      keep.numel() // keep.shape[-1], keep.shape[-1])
            nms_least[slot] = kernels.least_seconds(nbytes, ops)
        else:
            k = spec["traffic"]["top_k"]
            rl = ref[0].double()
            if served[slot].shape != (rl.shape[0], 2 * k):
                gaps["top5_gap"].append(float("inf"))
                continue
            idx = served[slot][:, k:].long().to(rl.device).clamp(0, rl.shape[1] - 1)
            kth = rl.topk(k, -1).values[:, -1:]
            below = (kth - rl.gather(1, idx)).clamp_min(0) / rl.std(-1, keepdim=True)
            gaps["top5_gap"].append(float(below.max()))
    return {name: float(max(v)) if v else None for name, v in gaps.items()}, nms_least


def serve(spec, W, pool, served: dict, raw: dict, device):
    """The numbers of a serving run from its kept batches."""
    if len(raw) < len(pool):
        return {}, {}
    ref_raw = {slot: reference_forward(spec, W, pool[slot], device) for slot in raw}
    return serve_numbers(spec, raw, served, ref_raw)
