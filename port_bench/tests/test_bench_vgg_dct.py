"""The configuration `ssd300_vgg_dct` and what it brings: its plain reference
against the program at a tiny size on the CPU (forward, target encoding,
loss, one SGD step through the harness's own comparison), the frozen
operation count against a count by hand, the convolution readers on
synthetic records, and the manifest's entries."""

import json
from pathlib import Path

import pytest
import torch

from port_bench import compare, core, inputs, weights
from port_bench.counts import convolution, flops
from port_bench.reference import nets, ssd
from port_bench.reference import net_ssd300_vgg_dct as vgg
from port_bench.tests import tiny

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

CELL = "ssd300_vgg_dct.train_v3aug_b512"
TRAIN_CELLS = ["ssd300_vgg_dct.train_v3aug_b512", "ssd300_ssd_custom.train_v3aug_b512",
               "resnet50_dct_rfa_thinner.train_v2aug_b1024"]
BOXES = {"max_gt": 8, "max_boxes": 6, "p_extra": 0.3, "side_share": [0.1, 0.7], "n_classes": 20}


def _planes(b, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(b, 38, 38, 64, generator=g) * 100).round()
    c = (torch.randn(b, 19, 19, 128, generator=g) * 30).round()
    return y, c


@pytest.fixture(scope="module")
def program():
    """The program's `ssd300_vgg_dct` (float32, CPU) and the reference's
    weights it holds, BatchNorm statistics calibrated on two images."""
    from jpeg_detection_resnet_ssd_torch.models import build_model

    W = weights.make(vgg.layers(20), 7, "cpu")
    compare.calibrate({"network": vgg, "config": {"n_classes": 20}}, W, _planes(2), 2,
                      torch.device("cpu"))
    module, _ = build_model("ssd300_vgg_dct", device="cpu", n_classes=20)
    weights.load_into(module, W)
    return module, W


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_and_loss_against_the_reference(program, train):
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.losses import SSDLoss
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes

    module, W = program
    y, c = _planes(2, seed=1)
    module.train(train)
    with torch.no_grad():
        out = module((y, c))
        rs, ro = vgg.forward(nets.Net(W, train=train), y, c, 20)
    module.eval()
    scores, offsets = vgg.split(out, 20)
    assert compare._rel_rows(scores, rs).max() < 1e-4
    assert compare._rel_rows(offsets, ro).max() < 1e-4
    gt, mask = (torch.as_tensor(a) for a in inputs.boxes(3, 1, 2, 304, BOXES)[0])
    enc = TargetEncoder(AnchorSpec(img_height=304, img_width=304), ssd_predictor_sizes("vgg_dct"),
                        n_classes=20, device="cpu")
    t_prog, t_ref = enc(gt, mask), ssd.encode(vgg.ANCHORS, gt, mask, 304, 20)
    assert abs(float(SSDLoss()(t_prog, out)) - float(ssd.loss(t_ref.float(), rs, ro))) < 1e-3


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_vgg_dct_target_encoding_against_the_reference(seed):
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes

    gt, mask = (torch.as_tensor(a) for a in inputs.boxes(seed, 1, 4, 304, BOXES)[0])
    enc = TargetEncoder(AnchorSpec(img_height=304, img_width=304), ssd_predictor_sizes("vgg_dct"),
                        n_classes=20, device="cpu")
    t_prog, t_ref = enc(gt, mask), ssd.encode(vgg.ANCHORS, gt, mask, 304, 20)
    assert t_prog.shape[:2] == t_ref.shape[:2] == (4, vgg.ANCHORS.count())
    # Two anchors at the same IoU with one box (seed 3: anchors 6141 and 6369
    # of image 2, 0.485669818 each) tie in the bipartite match, and float32
    # and float64 break the tie apart; the cell's limit allows for that.
    gap = compare._target_gap(t_prog[..., :25], t_ref, 21)
    assert gap < core.load_cell(CELL)["limits"]["target_gap"]["limit"]


def test_one_float32_sgd_step_through_the_harness():
    """The cell's run at batch 2 with the configuration's compute dtype set
    to float32: the augment, matching, losses, first gradient and change of
    the program against the reference, by the harness's own comparison."""
    s = tiny.spec(CELL)
    s["config"] = dict(s["config"], compute_dtype="float32")
    s["traffic"].update(compare_steps=1)
    out, result = tiny.run(s, seconds=0.0)
    n = out["numbers"]
    assert n["loss_gap"] < 1e-4 and n["forward_gap"] < 1e-4
    assert n["grad_gap"] < 1e-3 and n["grad_median_gap"] < 1e-4 and n["update_gap"] < 1e-3
    assert n["planes_gap"] < 1e-5 and n["box_gap"] < 1e-5 and n["target_gap"] == 0.0
    assert result["correct"] is True


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    out, result = tiny.run(tiny.spec(CELL), seconds=0.0)
    assert result["correct"] is False and out["numbers"]["update_gap"] > 0.9


def _macs(size, cout, cin, k):
    return size * size * cout * cin * k * k


def test_frozen_flops_against_a_count_by_hand():
    trunk = (_macs(38, 256, 64, 3) + _macs(38, 512, 256, 3) + 2 * _macs(38, 512, 512, 3)
             + _macs(19, 512, 640, 3) + 2 * _macs(19, 512, 512, 3))
    # fc6: at dilation 6 on 19x19 every one of the nine taps reads data
    neck = _macs(19, 1024, 512, 3) + _macs(19, 1024, 1024, 1)
    extras = (_macs(19, 256, 1024, 1) + _macs(10, 512, 256, 3) + _macs(10, 128, 512, 1)
              + _macs(5, 256, 128, 3) + _macs(5, 128, 256, 1) + _macs(3, 256, 128, 3)
              + _macs(3, 128, 256, 1) + _macs(1, 256, 128, 3))
    # conf (21 a box) and loc (4 a box) of each source; on the 1x1 map only
    # the centre tap of the head's 3x3 reads data
    head = sum(_macs(size, boxes * 25, width, 3) for size, width, boxes in
               zip((38, 19, 10, 5, 3), vgg.HEAD_WIDTHS, vgg.ANCHORS.boxes()))
    head += 1 * 1 * vgg.ANCHORS.boxes()[5] * 25 * vgg.HEAD_WIDTHS[5]
    assert flops.forward_flops(vgg, 38, 20) == 2 * (trunk + neck + extras + head) == 30_109_731_840
    assert flops.train_flops(vgg, 38, 20) == 3 * 30_109_731_840
    assert vgg.ANCHORS.count() == 8732


# The kernels of the training cells' traced steps on the card, each put down
# to the operator that launched it (see the file's "_about").
KERNELS = json.loads((Path(__file__).parent / "h100_train_kernels.json").read_text())


def _conv(name):
    return any(f in name for f in convolution.FRAGMENTS)


def test_fragments_name_the_convolution_kernels_of_the_traced_steps():
    assert all(_conv(n) for n in KERNELS["convolution"])
    # the bias add and the bias gradient's sum: ATen kernels other operators share
    assert not any(_conv(n) for n in KERNELS["convolution_aten"])
    assert not any(_conv(n) for n in KERNELS["other"])
    # the classifier's dense layer: a cuBLAS GEMM, counted with the convolutions
    assert all(_conv(n) for n in KERNELS["dense"])


def _reader(name):
    return core.load_module(core.BENCH_DIR / "metrics" / f"{name}.py")


def _record(conv_s, other_s, steps=10, step_flops=3e12):
    ops = {n: conv_s / len(KERNELS["convolution"]) for n in KERNELS["convolution"]}
    ops.update({n: other_s / len(KERNELS["other"]) for n in KERNELS["other"]})
    return {"device_ops": ops, "steps": steps, "step_flops": step_flops, "busy_s": 9.0,
            "window_s": 10.0}


def test_convolution_readers_on_synthetic_records():
    rec = _record(conv_s=0.6, other_s=0.8)
    assert convolution.seconds(rec) == pytest.approx(0.6)
    assert _reader("conv_device_ms.train").read(rec) == pytest.approx(1e3 * 0.6 / 10)
    assert _reader("conv_roofline.train").read(rec) == pytest.approx(
        100.0 * 10 * 3e12 / 0.6 / 989e12)


def test_convolution_readers_find_nothing_without_a_match():
    rec = _record(conv_s=0.6, other_s=0.8)
    rec["device_ops"] = {n: s for n, s in rec["device_ops"].items() if not _conv(n)}
    assert _reader("conv_device_ms.train").read(rec) is None
    assert _reader("conv_roofline.train").read(rec) is None
    # no steps in the window, or no frozen count: nothing to divide by
    rec = _record(conv_s=0.6, other_s=0.8)
    assert _reader("conv_device_ms.train").read(dict(rec, steps=0)) is None
    assert _reader("conv_roofline.train").read(dict(rec, step_flops=0)) is None


def test_manifest_takes_the_configuration_the_cell_and_the_metrics():
    manifest = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in manifest["configs"] if c["name"] == "ssd300_vgg_dct"]
    assert entry["reduced"] == [] and entry["file"] == "port_bench/configs/ssd300_vgg_dct.json"
    spec = core.load_cell(CELL)
    cfg = spec["config"]
    assert (cfg["model"], cfg["network"], cfg["anchor_family"]) == ("ssd300_vgg_dct",) * 2 + ("vgg_dct",)
    assert (cfg["n_classes"], cfg["input_blocks"], cfg["compute_dtype"]) == (20, 38, "bfloat16")
    assert spec["network"] is not None and spec["network"].layers(20) == vgg.layers(20)
    assert spec["cell"]["chips"] == 1 and spec["traffic"]["batch"] == 512
    assert {m["name"] for m in spec["end_to_end"]} == {"train_images_per_s", "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == {
        "step_host_ms.train", "data_wait_ms.train", "augment_host_ms.train",
        "b3_flip_roofline.train", "b2_match_roofline.train", "mfu.train",
        "device_idle_pct.train", "peak_mem_gib.train", "conv_device_ms.train",
        "conv_roofline.train"}
    per_layer = {m["name"]: m for m in manifest["per_layer"]}
    assert per_layer["conv_device_ms.train"]["workloads"] == TRAIN_CELLS
    assert per_layer["conv_roofline.train"]["workloads"] == TRAIN_CELLS[:2]
    for name in ("conv_device_ms.train", "conv_roofline.train"):
        assert per_layer[name]["source"] == "device_trace"
        assert per_layer[name]["moves"] == "train_images_per_s"


def test_limits_lie_between_their_readings():
    limits = core.load_cell(CELL)["limits"]
    numbers = {k: v for k, v in limits.items() if not k.startswith("_")}
    assert set(numbers) == {"loss_gap", "forward_gap", "grad_gap", "grad_median_gap",
                            "update_gap", "planes_gap", "box_gap", "target_gap"}
    for name, v in numbers.items():
        assert v["lower"] < v["limit"] < v["upper"], name


def test_the_reference_imports_nothing_of_the_program_or_of_jax():
    import ast

    tree = ast.parse((core.BENCH_DIR / "reference" / "net_ssd300_vgg_dct.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert all(n.split(".")[0] in ("__future__", "torch", "port_bench") for n in names), names
