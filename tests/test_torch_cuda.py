"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (a kernel has no CPU mode) and
skip without a card.  They import no jax, so they run on a machine without
it; there, skip this directory's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_torch.boxes import decode, geometry
from jpeg_detection_resnet_ssd_torch.eval.map_eval import DetectionEvaluator
from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
from jpeg_detection_resnet_ssd_torch.ops import (
    _draws, batch_norm, batched_nms, bipartite_match, conv_grad, dct_flip,
)
from jpeg_detection_resnet_ssd_torch.ops.dct_detect_augment import make_dct_detection_augment_v3

from chip_smoke import (
    BN_LAUNCHES_PER_STEP, bench_gt, bn_conditioning, bn_gaps, bn_params, bn_run, train_batch,
    write_detect_inputs,
)
from torch_cases import (
    BORDERS, CODEC_DIGEST, N_CLASSES, assert_augment_matches, augment_source, codec_digest,
    gt_batch, nms_problems, raw_predictions, tie_sims,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,k", [(640, 400), (7, 37), (3, 1), (5, 63), (5, 64), (5, 65), (2, 4096)])
@pytest.mark.parametrize("border", sorted(BORDERS))
def test_kernel_mask_equals_reference(cuda, n, k, border):
    """One call (two launches: pair bitmask, scan) per `LAUNCHES` count."""
    boxes, scores = nms_problems(np.random.default_rng(n), n, k)
    b, s = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    before = batched_nms.LAUNCHES
    got = batched_nms.batched_nms_mask(b, s, 0.45, BORDERS[border])
    torch.cuda.synchronize()
    assert batched_nms.LAUNCHES == before + 1
    assert got.dtype == torch.bool and got.device.type == "cuda"
    assert torch.equal(got, batched_nms.batched_nms_mask_reference(b, s, 0.45, BORDERS[border]))


def test_kernel_threshold_is_strict(cuda):
    boxes, scores = nms_problems(np.random.default_rng(3), 4, 16)
    got = batched_nms.batched_nms_mask(
        torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    ).cpu()
    assert got[:, 1].all() and not got[:, 3].any()


def test_kernel_rejects_what_it_does_not_take(cuda):
    b = torch.zeros(4, 8, 4, device=cuda)
    s = torch.ones(4, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        batched_nms.batched_nms_mask(b.transpose(0, 1).contiguous().transpose(0, 1), s)
    with pytest.raises(TypeError):
        batched_nms.batched_nms_mask(b.half(), s.half())
    with pytest.raises(ValueError, match="K <= 14,272"):
        batched_nms.batched_nms_mask(torch.zeros(1, 14_273, 4, device=cuda), torch.ones(1, 14_273, device=cuda))


@pytest.mark.parametrize("selector", ["exact", "shared"])
def test_kernel_decode_equals_reference_decode(cuda, selector):
    y = torch.from_numpy(raw_predictions()).to(cuda)
    kw = dict(n_classes=N_CLASSES, candidate_selector=selector)
    got = decode.decode_detections(y, nms_impl="kernel", **kw)
    ref = decode.decode_detections(y, nms_impl="reference", **kw)
    assert torch.equal(got, ref)


def _iou_sims(n_valid, seed):
    anchors = build_anchors(AnchorSpec(), ssd_predictor_sizes("resnet_custom"), coords="centroids")
    gt, mask = gt_batch(np.random.default_rng(seed), n_valid)
    cent = geometry.corners_to_centroids(torch.from_numpy(gt[..., 1:]) / 300.0)
    sims = geometry.iou_matrix(cent, torch.from_numpy(anchors[:, :4]), "centroids")
    return torch.where(torch.from_numpy(mask)[..., None], sims, -1.0).contiguous()


def _holes(sims, seed):
    """A (B, M) row mask with seeded holes, on the device of `sims`."""
    keep = np.random.default_rng(seed).random(sims.shape[:2]) < 0.6
    return torch.from_numpy(keep).to(sims.device)


@pytest.mark.parametrize("make", [
    lambda: _iou_sims([1, 3, 10, 64, 0, 7], seed=0),
    lambda: torch.from_numpy(tie_sims(np.random.default_rng(1), (5, 64, 300))),
    lambda: torch.from_numpy(tie_sims(np.random.default_rng(2), (3, 7, 33))),
    lambda: torch.from_numpy(tie_sims(np.random.default_rng(3), (4, 1, 300))),  # M = 1
    lambda: _iou_sims([2, 5, 64], seed=4)[..., :8731].contiguous(),  # N % 4 = 3
])
@pytest.mark.parametrize("mask", [None, "valid", "holes"])
def test_match_kernel_equals_reference(cuda, make, mask):
    """With no mask, the GT mask (rows >= 0 somewhere) or seeded holes."""
    sims = make().to(cuda)
    row_mask = {None: None, "valid": sims.amax(-1) >= 0, "holes": _holes(sims, 5)}[mask]
    before = bipartite_match.LAUNCHES
    got = bipartite_match.bipartite_match(sims, impl="kernel", row_mask=row_mask)
    torch.cuda.synchronize()
    assert bipartite_match.LAUNCHES == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, bipartite_match.bipartite_match_reference(sims, row_mask))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_match_kernel_takes_an_unaligned_view(cuda, offset):
    """A contiguous view `offset` floats past an aligned base: every row
    starts off the 16-byte grid, so the kernel reads scalar heads and tails."""
    sims = _iou_sims([3, 1, 64], seed=6).to(cuda)
    flat = torch.empty(sims.numel() + offset, device=cuda)
    view = flat[offset:].view(sims.shape)
    view.copy_(sims)
    assert view.data_ptr() % 16 != 0
    mask = sims.amax(-1) >= 0
    for row_mask in (None, mask):
        got = bipartite_match.bipartite_match(view, impl="kernel", row_mask=row_mask)
        assert torch.equal(got, bipartite_match.bipartite_match_reference(sims, row_mask))


def test_match_kernel_rejects_what_it_does_not_take(cuda):
    sims = torch.zeros(2, 4, 33, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bipartite_match.bipartite_match(sims.transpose(0, 1), impl="kernel")
    with pytest.raises(ValueError, match="row_mask"):
        bipartite_match.bipartite_match(sims, impl="kernel", row_mask=torch.ones(2, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="shared memory"):
        bipartite_match.bipartite_match(torch.zeros(1, 20_000, 1, device=cuda), impl="kernel")


@pytest.mark.parametrize("shape", [
    (2, 38, 38, 128, 128), (4, 5, 5, 512, 512), (3, 3, 3, 256, 100), (2, 1, 1, 256, 100),
    (1, 7, 9, 40, 150),
    # dy rows of 200 and 300 bytes (K = 100, 150: padded to 104, 152 for TMA)
    (4, 38, 38, 128, 100), (4, 38, 38, 128, 150), (4, 19, 19, 256, 100), (4, 19, 19, 256, 150),
    (3, 7, 9, 40, 24), (1, 1, 1, 256, 100), (1, 3, 3, 256, 100),  # H != W, C = 40; tiny maps
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_filter_grad_kernel_matches_reference(cuda, shape, dtype):
    """Both accumulate in float32; only the order of the sums differs.  Two
    calls give the same bits (the split sum is added in a fixed order)."""
    b, h, w, c, k = shape
    gen = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(b, h, w, c, generator=gen).to(cuda, dtype)
    dy = torch.randn(b, h, w, k, generator=gen).to(cuda, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    before = conv_grad.LAUNCHES
    got = conv_grad.conv3x3_filter_grad(x, dy)
    torch.cuda.synchronize()
    assert conv_grad.LAUNCHES == before + 1
    ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
    assert got.shape == (3, 3, c, k) and got.dtype == torch.float32
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(conv_grad.conv3x3_filter_grad(x, dy).view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("which", ["x", "dy"])
def test_filter_grad_kernel_takes_a_misaligned_view(cuda, which):
    """A view 2 bytes past an aligned base: the bf16 path copies it once
    (TMA needs a 16-byte-aligned base) and gives the plain version's dW."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    shapes = {"x": (2, 19, 19, 128), "dy": (2, 19, 19, 128)}
    t = {n: torch.randn(s, generator=gen).to(cuda, torch.bfloat16) for n, s in shapes.items()}
    n = t[which].numel()
    t[which] = torch.cat([t[which].new_zeros(1), t[which].reshape(-1)])[1:].view(shapes[which])
    assert t[which].data_ptr() % 16 != 0
    before = conv_grad.PAD_COPIES
    got = conv_grad.conv3x3_filter_grad(t["x"], t["dy"])
    torch.cuda.synchronize()
    assert conv_grad.PAD_COPIES == before + 1 and t[which].numel() == n
    ref = conv_grad.conv3x3_filter_grad_reference(t["x"], t["dy"])
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("shape", [(32, 38, 38, 64), (32, 19, 19, 128), (7, 3, 5, 9, 192),
                                   (3, 1, 1, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flip_kernel_equals_reference_bit_for_bit(cuda, shape, dtype):
    gen = torch.Generator(device="cpu").manual_seed(len(shape))
    x = (50 * torch.randn(shape, generator=gen)).to(cuda, dtype)
    x.view(-1)[:2] = 0.0  # a zero flips to -0.0 in an odd column, as the multiply gives
    before = dct_flip.LAUNCHES
    got = dct_flip.dct_flip_horizontal(x, impl="kernel")
    torch.cuda.synchronize()
    assert dct_flip.LAUNCHES == before + 1
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), dct_flip.dct_flip_horizontal_reference(x).view(bits))


def test_flip_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 3, 4, 64, device=cuda)
    with pytest.raises(TypeError):
        dct_flip.dct_flip_horizontal(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        dct_flip.dct_flip_horizontal(x.transpose(0, 1))
    with pytest.raises(ValueError, match="aligned"):
        dct_flip.dct_flip_horizontal(torch.zeros(1 + 3 * 4 * 64, device=cuda)[1:].view(3, 4, 64))
    with pytest.raises(ValueError, match="multiple of 64"):
        dct_flip.dct_flip_horizontal(torch.zeros(2, 3, 4, 96, device=cuda))


@pytest.mark.parametrize("photometric,quality", [(True, None), ("pixel_hsv", None), (True, 75)])
def test_chain_on_the_card_equals_the_cpu(cuda, photometric, quality):
    """The v3 chain's apply with one set of host draws, on the card (B3, TF32
    off) and on the CPU (plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = augment_source(4, 12)
    kw = dict(out_y_blocks=8, photometric=photometric, requantize_quality=quality)
    gpu, cpu = make_dct_detection_augment_v3(**kw), make_dct_detection_augment_v3(**kw, device="cpu")
    draws = cpu.sample(4, 12, 12, torch.Generator().manual_seed(0))
    before = dct_flip.LAUNCHES
    got = gpu.apply(gpu.to_device(batch), _draws.to_device(draws, cuda))
    torch.cuda.synchronize()
    assert dct_flip.LAUNCHES == before + 2
    ref = cpu.apply(cpu.to_device(batch), draws)
    assert_augment_matches([t.cpu() for t in (*got["inputs"], got["gt"], got["gt_mask"])],
                           [*ref["inputs"], ref["gt"], ref["gt_mask"]],
                           rtol=1e-4 if photometric == "pixel_hsv" else 1e-5, quality=quality)


# The A16 decoders on the card: the same raw predictions through the NMS
# kernel and through its plain version.
A16_DECODERS = {
    "fast": lambda y, impl: decode.decode_detections_fast(y, confidence_thresh=0.3, nms_impl=impl),
    "debug": lambda y, impl: decode.decode_detections_debug(y, n_classes=N_CLASSES, nms_impl=impl),
}


@pytest.mark.parametrize("name", sorted(A16_DECODERS))
def test_a16_decoder_kernel_equals_reference(cuda, name):
    y = torch.from_numpy(raw_predictions(seed=8, batch=4)).to(cuda)
    before = batched_nms.LAUNCHES
    got = A16_DECODERS[name](y, "kernel")
    torch.cuda.synchronize()
    assert batched_nms.LAUNCHES == before + 1
    assert torch.equal(got, A16_DECODERS[name](y, "reference"))
    assert int((got[..., -5] > 0).sum()) > 0


@pytest.mark.parametrize("k", [400, 1])
def test_nms_per_class_kernel_equals_reference(cuda, k):
    y = torch.from_numpy(raw_predictions(seed=9, batch=1)).to(cuda)
    _, boxes = decode.decode_raw_predictions(y[0], img_height=300, img_width=300)
    for cls in (1, 7, N_CLASSES):
        kw = dict(confidence_thresh=0.01, nms_max_output_size=k)
        before = batched_nms.LAUNCHES
        got = decode.nms_per_class(boxes, y[0, :, cls], nms_impl="kernel", **kw)
        torch.cuda.synchronize()
        assert batched_nms.LAUNCHES == before + 1
        ref = decode.nms_per_class(boxes, y[0, :, cls], nms_impl="reference", **kw)
        assert got[0].shape == (k,)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_evaluator_kernel_and_plain_nms_give_identical_lists(cuda):
    """DetectionEvaluator through the exact decode, B1 against its plain
    version, on the same raw predictions: three batches, one B1 call each."""
    raw = [torch.from_numpy(raw_predictions(seed=10 + b, batch=3)).to(cuda) for b in range(3)]
    rng = np.random.default_rng(0)
    batches = []
    for b in range(3):
        gt, mask = gt_batch(rng, [1, 3, 5])
        batches.append({
            "inputs": (b,), "image_ids": [f"{b}_{i}" for i in range(3)], "inverters": [None] * 3,
            "labels": [gt[i][mask[i]] for i in range(3)],
            "difficult": [rng.random(int(mask[i].sum())) < 0.3 for i in range(3)],
        })
    results = {}
    for impl in ("kernel", "reference"):
        before = batched_nms.LAUNCHES
        ev = DetectionEvaluator(
            lambda inputs: decode.decode_detections(
                raw[inputs[0]], n_classes=N_CLASSES, candidate_selector="exact", nms_impl=impl),
            batches, n_classes=N_CLASSES)
        results[impl] = (ev(), ev.prediction_results, batched_nms.LAUNCHES - before)
    (map_k, aps_k, _), preds_k, launches_k = results["kernel"]
    (map_r, aps_r, _), preds_r, launches_r = results["reference"]
    assert (launches_k, launches_r) == (3, 0)
    assert preds_k == preds_r and sum(map(len, preds_k)) > 100
    assert map_k == map_r and aps_k == aps_r


@pytest.mark.parametrize("ship_dtype", ["int16", "float32"])
def test_packed_pipeline_through_prefetch_lands_on_the_card(cuda, tmp_path, ship_dtype):
    """A NumPy-written packed corpus, its batches staged by
    `prefetch_to_device` from pinned memory on a side stream: on the card
    they equal the host arrays."""
    from jpeg_detection_resnet_ssd_torch.data.packed import PackedDctDataset, PackedDctPipeline
    from jpeg_detection_resnet_ssd_torch.data.pipeline import prefetch_to_device

    _, stem = write_detect_inputs(str(tmp_path), n=7, side=96, seed=3)
    corpus = PackedDctDataset(stem)
    want = list(PackedDctPipeline(corpus, 2, seed=4, ship_dtype=ship_dtype))
    got = list(prefetch_to_device(PackedDctPipeline(corpus, 2, seed=4, ship_dtype=ship_dtype),
                                  size=2, device=cuda))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip((*g["inputs"], g["gt"], g["gt_mask"]), (*w["inputs"], w["gt"], w["gt_mask"])):
            assert a.is_cuda
            np.testing.assert_array_equal(a.cpu().numpy(), b)


# The 3x3 stride-1 convs of the classifiers at 224 px, (H, C, K): the DCT
# stems (late_concat_rfa_thinner: 28x28 256/128, 14x14 256/128, 7x7 256,
# 4x4 512) and resnet50_rgb (56x56 64, 7x7 512).
CLS_WGRAD_SHAPES = [(28, 256, 256), (28, 128, 128), (14, 256, 256), (14, 128, 128),
                    (7, 256, 256), (4, 512, 512), (56, 64, 64), (7, 512, 512)]


@pytest.mark.parametrize("h,c,k", CLS_WGRAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_filter_grad_kernel_at_the_classification_shapes(cuda, h, c, k, dtype):
    """The small maps (7x7, 4x4: a stage box wider than the map) and the
    RGB stem's 56x56 64-channel conv, at batch 8: within 1e-4 of the
    largest value, and a second call bit-identical."""
    gen = torch.Generator(device="cpu").manual_seed(h * 1000 + c)
    x = torch.randn(8, h, h, c, generator=gen).to(cuda, dtype)
    dy = torch.randn(8, h, h, k, generator=gen).to(cuda, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = conv_grad.tiling_plan(8, h, h, c, k)
    assert plan.w_box >= h and plan.stage_rows % 16 == 0
    before = conv_grad.LAUNCHES
    got = conv_grad.conv3x3_filter_grad(x, dy)
    torch.cuda.synchronize()
    assert conv_grad.LAUNCHES == before + 1
    ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(conv_grad.conv3x3_filter_grad(x, dy).view(torch.int32), got.view(torch.int32))


# Maps wider than a stage holds (W > 128), whose rows the plan cuts into
# column groups (C3), (B, H, W, C, K): ssd300_vgg's conv1_x and conv2_x at
# batch 32, the VGG classifiers' block 1 at batch 64, and a ragged last group.
WIDE_WGRAD_SHAPES = [(32, 300, 300, 3, 64), (32, 300, 300, 64, 64), (32, 150, 150, 64, 128),
                     (32, 150, 150, 128, 128), (64, 224, 224, 3, 64), (64, 224, 224, 64, 64),
                     (3, 7, 201, 40, 24)]


@pytest.mark.parametrize("b,h,w,c,k", WIDE_WGRAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_filter_grad_kernel_on_maps_wider_than_a_stage(cuda, b, h, w, c, k, dtype):
    """Within 1e-4 of the largest value, and a second call bit-identical."""
    gen = torch.Generator(device="cpu").manual_seed(w * 1000 + c)
    x = torch.randn(b, h, w, c, generator=gen).to(cuda, dtype)
    dy = torch.randn(b, h, w, k, generator=gen).to(cuda, dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = conv_grad.tiling_plan(b, h, w, c, k)
    assert plan.w_groups > 1 and plan.w_groups * plan.w_box >= w
    before = conv_grad.LAUNCHES
    got = conv_grad.conv3x3_filter_grad(x, dy)
    torch.cuda.synchronize()
    assert conv_grad.LAUNCHES == before + 1
    ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    assert torch.equal(conv_grad.conv3x3_filter_grad(x, dy).view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_classification_augment_on_the_card_equals_the_cpu(cuda, version):
    """The classification augments' apply with one set of host draws, on the
    card (B3, two launches, TF32 off) and on the CPU (plain versions):
    coefficients within 1e-5 of the largest CPU value."""
    from jpeg_detection_resnet_ssd_torch.ops.dct_augment import (
        make_dct_classification_augment,
        make_dct_classification_augment_v2,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    maker = make_dct_classification_augment if version == "v1" else make_dct_classification_augment_v2
    out = 28 if version == "v1" else 8
    rng = np.random.default_rng(7)
    batch = {"inputs": (rng.normal(0, 100, (4, 32, 32, 64)).astype(np.int16),
                        rng.normal(0, 30, (4, 16, 16, 128)).astype(np.int16)),
             "labels": np.arange(4, dtype=np.int32)}
    gpu, cpu = maker(out), maker(out, device="cpu")
    draws = cpu.sample(4, 32, 32, torch.Generator().manual_seed(1))
    before = dct_flip.LAUNCHES
    got = gpu.apply(gpu.to_device(batch), _draws.to_device(draws, cuda))
    torch.cuda.synchronize()
    assert dct_flip.LAUNCHES == before + 2
    ref = cpu.apply(cpu.to_device(batch), draws)
    for a, b in zip(got["inputs"], ref["inputs"]):
        assert a.is_cuda and a.dtype == torch.float32
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("remat", [False, True])
def test_classification_step_launches_b4_and_b3(cuda, remat):
    """One bf16 classification step of resnet50_dct_late_concat_rfa_thinner
    on 16-block maps with the v2 augment: 18 filter gradients on B4 (the
    recompute keeps the switch) and 2 flips on B3; the loss is finite."""
    from jpeg_detection_resnet_ssd_torch.ops.dct_augment import make_dct_classification_augment_v2
    from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, build_trainer

    trainer, _, _ = build_trainer(ExperimentConfig(
        model="resnet50_dct_late_concat_rfa_thinner", task="classification", pallas_wgrad=True,
        remat=remat, momentum_dtype="bfloat16" if remat else "float32",
        model_kwargs={"num_classes": 10}), augment_fn=make_dct_classification_augment_v2(8))
    rng = np.random.default_rng(2)
    batch = {"inputs": (rng.normal(0, 100, (4, 12, 12, 64)).astype(np.int16),
                        rng.normal(0, 30, (4, 6, 6, 128)).astype(np.int16)),
             "labels": rng.integers(0, 10, 4).astype(np.int32)}
    conv_grad.LAUNCHES = dct_flip.LAUNCHES = 0
    metrics = trainer.train_step(batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert (conv_grad.LAUNCHES, dct_flip.LAUNCHES) == (18, 2)
    assert np.isfinite(float(metrics["loss"]))


def test_artifact_nms_runs_the_kernel_and_equals_the_plain_version(cuda, tmp_path):
    """An exported decode loaded back: each call reaches B1 through the
    custom operator (one launch), and its detections equal the plain NMS's."""
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.models import make_inference_fn
    from jpeg_detection_resnet_ssd_torch.serve import (
        build_serving_fn, export_serving_artifact, load_serving_artifact,
    )

    y = torch.from_numpy(raw_predictions(seed=10, batch=4)).to(cuda)
    decode = make_inference_fn(n_classes=N_CLASSES, spec=AnchorSpec(), top_k=50, device=cuda)
    serving = build_serving_fn(torch.nn.Identity(), decode_fn=decode, fold_bn=False)
    export_serving_artifact(serving, y[:2], str(tmp_path), device=cuda, symbolic_batch=True)
    fn, manifest = load_serving_artifact(str(tmp_path))
    assert manifest["device"] == "cuda:0"
    ref_decode = make_inference_fn(n_classes=N_CLASSES, spec=AnchorSpec(), top_k=50,
                                   nms_impl="reference", device=cuda)
    for b in (1, 4):
        before = batched_nms.LAUNCHES
        got = fn(y[:b])
        torch.cuda.synchronize()
        assert batched_nms.LAUNCHES == before + 1
        assert torch.equal(got, ref_decode(y[:b])) and int((got[..., 1] > 0).sum()) > 0
    with pytest.raises(ValueError, match="cuda:0.*cpu"):
        fn(y[:1].cpu())


@pytest.mark.parametrize("conv", ["3x3", "1x1/2", "fc6"])
def test_int8_conv_accumulators_on_the_card_equal_the_cpu(cuda, conv):
    """`torch._int_mm` accumulators of a quantized conv, card against CPU:
    integer sums, so exactly equal (batch 1: M padded past 16 rows)."""
    from jpeg_detection_resnet_ssd_torch.models.layers import Conv
    from jpeg_detection_resnet_ssd_torch.models.ssd import _FC6CenterTap
    from jpeg_detection_resnet_ssd_torch.serve.quantize import QuantizedConv, quantize_conv_weights

    g = torch.Generator().manual_seed(0)
    layer, hw, cin = {"3x3": (Conv(128, 128, 3, generator=g), 19, 128),
                      "1x1/2": (Conv(256, 512, 1, 2, "VALID", generator=g), 38, 256),
                      "fc6": (_FC6CenterTap(2048, 1024, 6, generator=g), 5, 2048)}[conv]
    root = torch.nn.Module()
    root.c = layer
    (w_q, s_w), = quantize_conv_weights(root, ["c"], skip=()).values()
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (1, hw, hw, cin)).astype(np.float32))
    cpu = QuantizedConv(layer, w_q, s_w, 4.0 / 127)
    gpu = QuantizedConv(layer.to(cuda), w_q.to(cuda), s_w.to(cuda), 4.0 / 127)
    acc = gpu.accumulate(x.to(cuda))
    assert acc.dtype == torch.int32 and acc.is_cuda
    assert torch.equal(acc.cpu(), cpu.accumulate(x))


def test_two_gloo_ranks_on_one_card_equal_one_process(cuda, tmp_path):
    """The data-parallel step on the card: two gloo ranks (NCCL refuses two
    ranks on one device) take one f32 step of `ssd300_ssd_custom` with B2,
    B3 (the v3 augment) and B4 (`pallas_wgrad`) on 4 rows each of a global
    batch of 8; one process on the global batch is the reference.  One step:
    at this random init a second step's loss moves by ~1e-3 of itself from
    a rounding-level change of the first update, in one process alone too
    (1 against 3 CPU threads).  1e-4 of the loss and 1e-3 of the largest
    parameter, as `chip_smoke.py` holds; the ranks stay bit-identical."""
    import torch_dp_worker as worker

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    kw = dict(device="cuda", pallas_wgrad=True, global_batch=8, steps=1)
    procs = []
    try:
        results = worker.run_ranks("ssd_custom", str(tmp_path), procs, timeout=300, **kw)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ref = worker.ssd_custom_step(**kw)
    loss = ref["metrics"]["total_loss"]
    largest = max(float(v.abs().max()) for v in ref["state"].values() if v.is_floating_point())
    for r in results:
        assert float((r["metrics"]["total_loss"] - loss).abs().max()) <= 1e-4 * float(loss.abs().max())
    for key, want in ref["state"].items():
        got = [r["state"][key] for r in results]
        assert torch.equal(got[0], got[1]), key
        if want.is_floating_point():
            assert float((got[0] - want).abs().max()) <= 1e-3 * largest, key



@pytest.mark.parametrize("min_features", [1024, 512])
def test_two_model_ranks_on_one_card_equal_one_process(cuda, tmp_path, min_features):
    """The tensor-parallel step on the card: two gloo ranks of a 1x2 mesh
    take one f32 step of `ssd300_ssd_custom` with B2, B3 and B4 on the
    whole global batch of 8, the kernels of at least `min_features` outputs
    sharded (at 512 B4 takes stage 5's 3x3 convs on 256-column output
    slices); one process is the reference, held as the data-parallel step
    is, and the ranks' gathered states are bit-identical."""
    import torch_dp_worker as worker

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    kw = dict(device="cuda", pallas_wgrad=True, global_batch=8, steps=1)
    procs = []
    try:
        results = worker.run_ranks("ssd_custom", str(tmp_path), procs, timeout=300, n_model=2,
                                   min_features=min_features, **kw)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ref = worker.ssd_custom_step(**kw)
    loss = ref["metrics"]["total_loss"]
    largest = max(float(v.abs().max()) for v in ref["state"].values() if v.is_floating_point())
    for r in results:
        assert float((r["metrics"]["total_loss"] - loss).abs().max()) <= 1e-4 * float(loss.abs().max())
        assert r["n_params"] < ref["n_params"]
    for key, want in ref["state"].items():
        got = [r["state"][key] for r in results]
        assert torch.equal(got[0], got[1]), key
        if want.is_floating_point():
            assert float((got[0] - want).abs().max()) <= 1e-3 * largest, key


def test_numpy_codec_reproduces_the_pinned_digest(cuda):
    """The card's machine has no libjpeg: the NumPy codec (NumPy alone, no
    PIL) gives there the coefficients that the libjpeg path gives on the CPU
    machine (digest pinned by `test_torch_numpy_codec.py`)."""
    from jpeg_detection_resnet_ssd_torch.data.dct_convert import rgb_to_dct_tensors_numpy

    assert codec_digest(rgb_to_dct_tensors_numpy) == CODEC_DIGEST


def test_detection_proxy_runs_on_the_card(cuda, tmp_path, capsys):
    """`chip_smoke.py` phase 9k's proxy at a few steps: `device_v3` at batch 4
    in bf16 from 8 train images packed by the NumPy codec, 2 held out; B2
    once and B3 twice a step, B1 once in each selector's decode."""
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import torch_convergence_proxy as proxy

    bipartite_match.LAUNCHES = dct_flip.LAUNCHES = batched_nms.LAUNCHES = 0
    proxy.main([str(a) for a in (
        "--variant", "device_v3", "--steps", 4, "--batch-size", 4, "--n-train", 8, "--n-test", 2,
        "--codec", "numpy", "--num-workers", 4, "--data-root", tmp_path / "voc",
        "--output-dir", tmp_path / "runs")])
    torch.cuda.synchronize()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (bipartite_match.LAUNCHES, dct_flip.LAUNCHES, batched_nms.LAUNCHES) == (4, 8, 2)
    assert np.isfinite(out["final_train_loss"]) and 0.0 <= out["heldout_mAP"] <= 1.0
    assert (out["train_images"], out["test_images"]) == (8, 2)


# The detector's BatchNorm inputs at batch 256: the largest (384 channels),
# the widest at 38x38 (256), one a stage, and a 1x1 map.
BN_CASES = [(256, 38, 38, 384), (256, 38, 38, 256), (256, 19, 19, 512), (256, 10, 10, 1024),
            (256, 5, 5, 2048), (256, 1, 1, 256)]


def _bn_inputs(shape, dtype, cuda, seed):
    """x with a per-channel offset and two constant channels, dy, seeded
    parameters and running statistics.  Channel 2 is 3.0 (exact sums: a
    variance of exactly 0).  Channel 1 is 0.1, whose sums are inexact, so
    E[x^2] - E[x]^2 may come out below 0 and be clipped; there
    rsqrt(var + eps) takes that difference's rounding, which the order of
    the sums moves: `chip_smoke.bn_conditioning` bounds how far, and the
    float32 tolerance takes it."""
    gen = torch.Generator().manual_seed(seed)
    c = shape[-1]
    x = (2 * torch.randn(shape, generator=gen) + torch.randn(c, generator=gen)).to(cuda, dtype)
    x[..., 1], x[..., 2] = 0.1, 3.0
    return x, torch.randn(shape, generator=gen).to(cuda, dtype), bn_params(c, gen, cuda)


@pytest.mark.parametrize("shape", BN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_kernels_match_the_plain_version(cuda, shape, dtype):
    """y, running mean and variance, the step counter, dx, dweight and
    dbias within `chip_smoke.bn_gaps`' tolerances (one bf16 rounding apart;
    float32 sums in another order); three launches each way; a second call
    gives the same bits."""
    x, dy, params = _bn_inputs(shape, dtype, cuda, seed=shape[-1])
    before = batch_norm.LAUNCHES
    got = bn_run("kernel", x, params, dy)
    torch.cuda.synchronize()
    assert batch_norm.LAUNCHES == before + 6
    assert got["y"].dtype == got["dx"].dtype == dtype and got["dweight"].dtype == torch.float32
    gaps = bn_gaps(got, bn_run("reference", x, params, dy), bn_conditioning(x))
    assert max(gaps.values()) <= 1.0, gaps
    again = bn_run("kernel", x, params, dy)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_batch_norm_kernels_frozen_and_cumulative(cuda):
    """Under `running_stats_frozen()` (update=False) the state stays as it
    was, bit for bit; with momentum=None the factor is 1 / the new count."""
    x, dy, params = _bn_inputs((8, 10, 10, 64), torch.bfloat16, cuda, seed=3)
    got = bn_run("kernel", x, params, dy, update=False)
    for k in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(got[k], params[k])
    assert max(bn_gaps(got, bn_run("reference", x, params, dy, update=False)).values()) <= 1.0
    got = bn_run("kernel", x, params, dy, momentum=None)
    assert int(got["num_batches_tracked"]) == int(params["num_batches_tracked"]) + 1
    assert max(bn_gaps(got, bn_run("reference", x, params, dy, momentum=None)).values()) <= 1.0


@pytest.mark.parametrize("shape", [(4, 9, 7, 3), (3, 5, 5, 100)])
def test_batch_norm_kernels_take_ragged_channels_and_views(cuda, shape):
    """C = 3 and 100 (no multiple of 8 bf16 channels) and a view 2 bytes past
    an aligned base take the scalar path."""
    x, dy, params = _bn_inputs(shape, torch.bfloat16, cuda, seed=4)
    assert max(bn_gaps(bn_run("kernel", x, params, dy), bn_run("reference", x, params, dy)).values()) <= 1.0
    view = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(shape)
    assert view.data_ptr() % 16 != 0
    assert max(bn_gaps(bn_run("kernel", view, params, dy), bn_run("reference", x, params, dy)).values()) <= 1.0


def test_batch_norm_kernels_reject_what_they_do_not_take(cuda):
    x, _, p = _bn_inputs((2, 3, 3, 64), torch.float32, cuda, seed=5)
    state = (p["running_mean"], p["running_var"], p["num_batches_tracked"], 0.01, 1e-3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        batch_norm.batch_norm_train(x.half(), p["weight"], p["bias"], *state, impl="kernel")
    with pytest.raises(ValueError, match="weight"):
        batch_norm.batch_norm_train(x, p["weight"].double(), p["bias"], *state, impl="kernel")
    with pytest.raises(ValueError, match="num_batches_tracked"):
        batch_norm.batch_norm_train(x, p["weight"], p["bias"], *state[:2], torch.tensor(3), *state[3:],
                                    impl="kernel")
    with pytest.raises(ValueError, match="weight"):
        batch_norm.batch_norm_train(x, p["weight"].cpu(), p["bias"], *state, impl="kernel")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_kernels_on_two_data_ranks_equal_one_process(cuda, tmp_path, dtype):
    """Two gloo ranks on the card, each with half of a global batch of 8 at
    (19, 19, 256), all-reduce each direction's totals between the kernels'
    halves (4 launches a direction); the rows they give, their summed
    dweight and dbias and their bit-identical running statistics agree
    with one process's kernels on the global batch (3 a direction) within
    `bn_gaps`' tolerances."""
    import torch_dp_worker as worker

    gaps, outs, (rank_launches, one_launches) = worker.batch_norm_ranks_against_one_process(
        str(tmp_path), shape=[8, 19, 19, 256], dtype=dtype, device="cuda")
    assert max(gaps.values()) <= 1.0, gaps
    assert all(torch.equal(outs[0][k], outs[1][k])
               for k in ("running_mean", "running_var", "num_batches_tracked"))
    assert rank_launches == [8, 8] and one_launches == 6


def test_detector_step_runs_every_batch_norm_on_the_kernels(cuda):
    """One bf16 `ssd_custom` train step: each of the 71 train-mode BatchNorms
    launches 3 kernels forward and 3 backward (2 for the two input
    BatchNorms, whose input needs no gradient)."""
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.models import layers
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, build_trainer

    trainer, model, _ = build_trainer(
        ExperimentConfig(compute_dtype="bfloat16", batch_size=2),
        target_encoder=TargetEncoder(AnchorSpec(), ssd_predictor_sizes("resnet_custom")))
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(args[0].requires_grad))
             for m in model.modules() if isinstance(m, layers.BatchNorm)]
    batch = train_batch(np.random.default_rng(6), *bench_gt(2), cuda)
    batch_norm.LAUNCHES = 0
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    assert len(seen) == 71 and seen.count(False) == 2
    assert batch_norm.LAUNCHES == BN_LAUNCHES_PER_STEP == 3 * 71 + 3 * 69 + 2 * 2
    assert np.isfinite(float(metrics["loss"]))
