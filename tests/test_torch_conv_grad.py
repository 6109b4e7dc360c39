"""The filter gradient of 3x3 stride-1 SAME convolutions (CPU).

The port's plain dW (nine tap matmuls, float32 accumulation) against the
JAX package's Pallas kernel in interpret mode and its float64 oracle, at
the JAX tests' shapes and tolerances (`tests/test_pallas_conv_grad.py`);
the autograd Function against plain `F.conv2d` autograd; the switch that
routes the model's eligible convolutions through it; and the bf16 kernel's
tiling plan, whose tiled sum is emulated here (the kernel itself runs only
on the card, `test_torch_cuda.py`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jpeg_detection_resnet_ssd_tpu.ops.pallas_conv_grad import (
    conv3x3_filter_grad as jax_filter_grad,
    reference_filter_grad,
)
from jpeg_detection_resnet_ssd_torch.models import build_model, layers
from jpeg_detection_resnet_ssd_torch.ops import conv_grad

from test_torch_models import _PortBlocks

torch.set_num_threads(1)


@pytest.mark.parametrize("b,h,w,c,k", [(2, 6, 6, 8, 8), (4, 5, 7, 16, 8), (1, 8, 8, 4, 12)])
def test_plain_filter_grad_matches_pallas_and_oracle(b, h, w, c, k):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    dy = rng.normal(0, 1, (b, h, w, k)).astype(np.float32)
    got = conv_grad.conv3x3_filter_grad(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32 and got.shape == (3, 3, c, k)
    got = got.numpy()
    np.testing.assert_allclose(got, reference_filter_grad(x, dy), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_filter_grad(x, dy, interpret=True)),
                               rtol=1e-5, atol=1e-4)


def test_plain_filter_grad_bf16_accumulates_in_f32():
    """bf16 operands: each product is exact in float32, so the result is the
    oracle on the bf16-rounded values to float32 summation order (the JAX
    test allows rtol 0.02 / atol 0.3 against the unrounded values)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (2, 6, 6, 8)).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rng.normal(0, 1, (2, 6, 6, 8)).astype(np.float32)).bfloat16()
    got = conv_grad.conv3x3_filter_grad(x, dy)
    assert got.dtype == torch.float32
    want = reference_filter_grad(x.float().numpy(), dy.float().numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    ref = jax_filter_grad(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                          jnp.asarray(dy.float().numpy(), jnp.bfloat16), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_function_matches_conv2d_autograd():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0, 1, (4, 9, 9, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.1, (16, 8, 3, 3)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(0, 1, (4, 9, 9, 16)).astype(np.float32))
    x1, w1 = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    x2, w2 = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    got = conv_grad.conv3x3_same_wgrad(x1, w1)
    ref = F.conv2d(x2.permute(0, 3, 1, 2), w2, None, 1, 1).permute(0, 2, 3, 1)
    assert torch.equal(got, ref)
    (got * ct).sum().backward()
    (ref * ct).sum().backward()
    np.testing.assert_allclose(x1.grad.numpy(), x2.grad.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w1.grad.numpy(), w2.grad.numpy(), rtol=1e-5, atol=1e-4)


def test_function_returns_dw_in_the_weight_dtype():
    """The bf16 forward gets the weight cast to bf16, so dW comes back in
    bf16 (and autograd widens it to the float32 parameter), as in JAX."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(0, 0.1, (4, 6, 3, 3)).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.normal(0, 1, (1, 5, 5, 6)).astype(np.float32)).bfloat16()
    conv_grad.conv3x3_same_wgrad(x, w.to(torch.bfloat16)).float().square().sum().backward()
    assert w.grad.dtype == torch.float32
    assert torch.equal(w.grad, w.grad.bfloat16().float())


def _record_filter_grads(monkeypatch):
    calls = []
    plain = conv_grad.conv3x3_filter_grad

    def record(x, dy):
        calls.append((tuple(x.shape[1:]), dy.shape[-1]))
        return plain(x, dy)

    monkeypatch.setattr(conv_grad, "conv3x3_filter_grad", record)
    return calls


def test_switch_routes_the_eligible_blocks_convs(monkeypatch):
    calls = _record_filter_grads(monkeypatch)
    port = _PortBlocks(6).train()
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (2, 9, 9, 6)).astype(np.float32))
    grads = {}
    for on in (False, True):
        port.zero_grad()
        with layers.pallas_wgrad(on):
            port(x).square().sum().backward()
        grads[on] = {k: p.grad.clone() for k, p in port.named_parameters()}
    assert not layers.pallas_wgrad_enabled()
    # Blocks a (3x3 at 5x5) and d (3x3 at 5x5); b has a 2x2 kernel, c a 1x1.
    assert calls == [((5, 5, 4), 4), ((5, 5, 4), 4)]
    # Another summation order; the biases of convs that feed a train-mode
    # BatchNorm have a gradient of 0 up to rounding (~1e-5 here).
    for k in grads[False]:
        np.testing.assert_allclose(grads[True][k].numpy(), grads[False][k].numpy(),
                                   rtol=1e-4, atol=5e-5)


def test_switch_routes_24_convs_of_ssd_custom(monkeypatch):
    """The 18 bottleneck 3x3 convs and the 6 fused head convs, nothing else
    (the kernel-1 and kernel-2 middles, the VALID extras and fc6 stay on
    the library's conv); parameter names do not change."""
    calls = _record_filter_grads(monkeypatch)
    model, example = build_model("ssd300_ssd_custom", n_classes=20, device="cpu")
    keys = list(model.state_dict())
    y, cbcr = (torch.from_numpy(a[:1]) for a in example())
    model.train()
    with layers.pallas_wgrad(True):
        model((y, cbcr)).square().mean().backward()
    assert list(model.state_dict()) == keys
    want = (
        [((38, 38, 256), 256)] + [((38, 38, 128), 128)] * 4 + [((19, 19, 256), 256)]
        + [((19, 19, 128), 128)] * 3 + [((10, 10, 256), 256)] * 6
        + [((5, 5, 512), 512)] * 3
        + [((38, 38, 384), 100), ((19, 19, 512), 150), ((10, 10, 1024), 150),
           ((5, 5, 1024), 150), ((3, 3, 256), 100), ((1, 1, 256), 100)]
    )
    assert sorted(calls) == sorted(want)


# The bf16 kernel's tiling plan (`conv_grad.tiling_plan`), checked on the CPU.
# The 12 filter-gradient shapes of one `ssd_custom` train step at batch 32,
# (H = W, C, K), and the ragged cases the card tests add, (B, H, W, C, K).
STEP_SHAPES = [(38, 256, 256), (38, 128, 128), (19, 256, 256), (19, 128, 128), (10, 256, 256),
               (5, 512, 512), (38, 384, 100), (19, 512, 150), (10, 1024, 150), (5, 1024, 150),
               (3, 256, 100), (1, 256, 100)]
# Maps wider than a stage holds (W > 128: ssd300_vgg's conv1_x and conv2_x,
# the VGG classifiers' block 1) at batch 1-2; the column groups do not depend
# on B.
WIDE_CASES = [(1, 300, 300, 3, 64), (1, 300, 300, 64, 64), (1, 150, 150, 64, 128),
              (1, 224, 224, 3, 64), (2, 224, 224, 64, 64)]
PLAN_CASES = ([(32, h, h, c, k) for h, c, k in STEP_SHAPES]
              # a rank's 16 rows of the global batch of 32 on two ranks
              + [(16, h, h, c, k) for h, c, k in STEP_SHAPES]
              + [(1, 7, 9, 40, 150), (3, 7, 9, 40, 24), (1, 1, 1, 256, 100), (1, 3, 3, 256, 100)]
              + WIDE_CASES)
# The plans that the kernel ran before rows wider than a stage were cut into
# column groups, (c_pad, k_pad, w_box, rows, images, n_tile, h_groups,
# stages, per_split, splits, ring): the detector's and the classifiers'
# shapes and the ragged card cases, each still one column group.
FIT_PLANS = {
    (32, 38, 38, 256, 256): (256, 256, 40, 1, 2, 256, 38, 608, 87, 7, 3),
    (32, 38, 38, 128, 128): (128, 128, 40, 1, 2, 128, 38, 608, 44, 14, 5),
    (32, 19, 19, 256, 256): (256, 256, 20, 1, 4, 256, 19, 152, 22, 7, 3),
    (32, 19, 19, 128, 128): (128, 128, 20, 1, 4, 128, 19, 152, 14, 11, 5),
    (32, 10, 10, 256, 256): (256, 256, 10, 1, 8, 256, 10, 40, 10, 4, 3),
    (32, 5, 5, 512, 512): (512, 512, 5, 1, 16, 256, 5, 10, 10, 1, 3),
    (32, 38, 38, 384, 100): (384, 104, 40, 1, 2, 104, 38, 608, 152, 4, 5),
    (32, 19, 19, 512, 150): (512, 152, 20, 1, 4, 152, 19, 152, 51, 3, 4),
    (32, 10, 10, 1024, 150): (1024, 152, 10, 1, 8, 152, 10, 40, 40, 1, 4),
    (32, 5, 5, 1024, 150): (1024, 152, 5, 1, 16, 152, 5, 10, 10, 1, 4),
    (32, 3, 3, 256, 100): (256, 104, 3, 1, 16, 104, 3, 6, 6, 1, 6),
    (32, 1, 1, 256, 100): (256, 104, 1, 1, 16, 104, 1, 2, 2, 1, 6),
    (1, 7, 9, 40, 150): (40, 152, 12, 4, 1, 152, 2, 2, 2, 1, 6),
    (3, 7, 9, 40, 24): (40, 24, 10, 2, 4, 64, 4, 4, 1, 4, 6),
    (1, 1, 1, 256, 100): (256, 104, 1, 1, 16, 104, 1, 1, 1, 1, 6),
    (1, 3, 3, 256, 100): (256, 104, 4, 2, 2, 104, 2, 2, 2, 1, 6),
    (64, 28, 28, 256, 256): (256, 256, 28, 1, 4, 256, 28, 448, 64, 7, 2),
    (64, 28, 28, 128, 128): (128, 128, 28, 1, 4, 128, 28, 448, 32, 14, 4),
    (64, 14, 14, 256, 256): (256, 256, 14, 1, 8, 256, 14, 112, 16, 7, 2),
    (64, 14, 14, 128, 128): (128, 128, 14, 1, 8, 128, 14, 112, 8, 14, 4),
    (64, 7, 7, 256, 256): (256, 256, 7, 1, 16, 256, 7, 28, 7, 4, 2),
    (64, 4, 4, 512, 512): (512, 512, 4, 2, 16, 256, 2, 8, 8, 1, 2),
    (64, 56, 56, 64, 64): (64, 64, 56, 1, 2, 64, 56, 1792, 128, 14, 5),
    (64, 7, 7, 512, 512): (512, 512, 7, 1, 16, 256, 7, 28, 28, 1, 2),
    (32, 38, 38, 128, 100): (128, 104, 40, 1, 2, 104, 38, 608, 44, 14, 5),
    (32, 38, 38, 128, 150): (128, 152, 40, 1, 2, 152, 38, 608, 44, 14, 4),
    (32, 19, 19, 256, 100): (256, 104, 20, 1, 4, 104, 19, 152, 22, 7, 5),
    (32, 19, 19, 256, 150): (256, 152, 20, 1, 4, 152, 19, 152, 22, 7, 4),
}


def _split_stages(plan):
    """The stages of each chunk of P, in the kernel's order."""
    return [range(z * plan.per_split, min(plan.stages, (z + 1) * plan.per_split))
            for z in range(plan.splits)]


def _emulate_plan(plan, x, dy):
    """The plan's tiled sum: for each chunk, each stage's boxes as TMA fills
    them (zero outside x and dy) multiplied tap by tap, the chunks added in
    order, in float32."""
    b, h, w, c = x.shape
    k = dy.shape[-1]
    b_pad = plan.stages // (plan.h_groups * plan.w_groups) * plan.images
    h_pad, w_pad = plan.h_groups * plan.rows, plan.w_groups * plan.w_box
    # Every coordinate a box reaches (x's from -1), zero outside the tensors.
    xz = x.new_zeros(b_pad, h_pad + 2, w_pad + 2, plan.c_pad)
    xz[:b, 1:h + 1, 1:w + 1, :c] = x
    dyz = dy.new_zeros(b_pad, h_pad, w_pad, plan.k_pad)
    dyz[:b, :h, :w, :k] = dy
    total = None
    for stages in _split_stages(plan):
        acc = x.new_zeros(9, plan.c_pad, plan.k_pad)
        for u in stages:
            b0, y0, x0 = plan.stage_origin(u)
            d = dyz[b0:b0 + plan.images, y0:y0 + plan.rows, x0:x0 + plan.w_box]
            d = d.reshape(plan.stage_rows, -1)
            for tap in range(9):
                kh, kw = divmod(tap, 3)
                a = xz[b0:b0 + plan.images, y0 + kh:y0 + kh + plan.rows,
                       x0 + kw:x0 + kw + plan.w_box]
                acc[tap] += a.reshape(plan.stage_rows, -1).T @ d
        total = acc if total is None else total + acc
    return total[:, :c, :k].reshape(3, 3, c, k)


@pytest.mark.parametrize("b,h,w,c,k", PLAN_CASES)
def test_plan_covers_every_row_of_p_once(b, h, w, c, k):
    plan = conv_grad.tiling_plan(b, h, w, c, k)
    assert plan.stage_rows % 16 == 0 and plan.stage_rows <= conv_grad.MAX_STAGE_ROWS
    assert plan.n_tile in conv_grad.N_TILES and plan.w_box * plan.w_groups >= w
    assert plan.w_groups == 1 or plan.w_box % 16 == 0
    assert plan.c_pad % 8 == 0 and plan.k_pad % 8 == 0 and plan.c_pad >= c and plan.k_pad >= k
    assert (plan.splits - 1) * plan.per_split < plan.stages <= plan.splits * plan.per_split
    stage_bytes = (2 + -(-plan.n_tile // conv_grad.BOX_C)) * plan.stage_rows * 128
    assert 2 <= plan.ring <= conv_grad.MAX_RING and plan.ring * stage_bytes <= conv_grad.SMEM_BYTES
    seen = torch.zeros(b, h, w, dtype=torch.int32)
    for stages in _split_stages(plan):
        for u in stages:
            b0, y0, x0 = plan.stage_origin(u)
            seen[b0:b0 + plan.images, y0:y0 + plan.rows, x0:x0 + plan.w_box] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("shape", list(FIT_PLANS))
def test_plan_is_unchanged_where_a_row_fits_a_stage(shape):
    plan = conv_grad.tiling_plan(*shape)
    assert plan.w_groups == 1
    got = dataclasses.astuple(plan)
    assert got[:7] + got[8:] == FIT_PLANS[shape]


@pytest.mark.parametrize("b,h,w,c,k", PLAN_CASES)
def test_plan_tiled_sum_matches_references(b, h, w, c, k):
    """The plan of the full-width problem, emulated at 8 -> 6 channels (dy
    padded to 8, as the wrapper pads K = 100 and 150)."""
    plan = dataclasses.replace(conv_grad.tiling_plan(b, h, w, c, k), c_pad=8, k_pad=8)
    rng = np.random.default_rng(h * 1000 + k)
    x = rng.normal(0, 1, (b, h, w, 8)).astype(np.float32)
    dy = rng.normal(0, 1, (b, h, w, 6)).astype(np.float32)
    got = _emulate_plan(plan, torch.from_numpy(x), torch.from_numpy(dy)).numpy()
    for ref in (conv_grad.conv3x3_filter_grad_reference(torch.from_numpy(x), torch.from_numpy(dy)).numpy(),
                reference_filter_grad(x, dy)):
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))


def test_tma_operand_pads_channels_and_realigns_with_one_counted_copy():
    t = torch.arange(2 * 3 * 3 * 100, dtype=torch.float32).bfloat16().reshape(2, 3, 3, 100)
    before = conv_grad.PAD_COPIES
    padded = conv_grad._tma_operand(t, 104)
    assert padded.shape == (2, 3, 3, 104) and torch.equal(padded[..., :100], t)
    assert not bool(padded[..., 100:].any())
    assert conv_grad.PAD_COPIES == before + 1
    assert conv_grad._tma_operand(padded, 104) is padded and conv_grad.PAD_COPIES == before + 1
    flat = torch.zeros(1 + 2 * 3 * 3 * 104, dtype=torch.bfloat16)
    view = flat[1:].view(2, 3, 3, 104)  # 2 bytes past an aligned base
    assert view.data_ptr() % 16 != 0
    copy = conv_grad._tma_operand(view, 104)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, view)
    assert conv_grad.PAD_COPIES == before + 2
