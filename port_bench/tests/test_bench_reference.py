"""The plain reference against the program at a tiny size on the CPU: the
augments from the same draws, the networks from the same weights, the
target encoding, the loss and the decode."""

import pytest
import torch

from port_bench import compare, inputs, weights
from port_bench.reference import augment, nets, ssd
from port_bench.reference import net_resnet50_dct_rfa_thinner as classifier
from port_bench.reference import net_ssd300_resnet_custom as detector

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _planes(b, h8, seed=0):
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn(b, h8, h8, 64, generator=g) * 100).round().to(torch.int16)
    c = (torch.randn(b, h8 // 2, h8 // 2, 128, generator=g) * 30).round().to(torch.int16)
    return y, c


BOXES = {"max_gt": 8, "max_boxes": 6, "p_extra": 0.3, "side_share": [0.1, 0.7], "n_classes": 20}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_v3_augment(seed):
    from jpeg_detection_resnet_ssd_torch.ops import make_dct_detection_augment_v3

    y, c = _planes(8, 44, seed)
    gt, mask = (torch.as_tensor(a) for a in inputs.boxes(seed, 1, 8, 352, BOXES)[0])
    out = make_dct_detection_augment_v3(38, device="cpu")(
        {"inputs": (y, c), "gt": gt, "gt_mask": mask}, inputs.step_generator(seed, 0))
    d = augment.sample_detection_v3(inputs.step_generator(seed, 0), 8, 44, 44)
    ry, rc, rg, rm = augment.detection_v3(y, c, gt, mask, d)
    assert compare._rel_rows(out["inputs"][0], ry).max() < 1e-5
    assert compare._rel_rows(out["inputs"][1], rc).max() < 1e-5
    assert torch.equal(out["gt_mask"], rm)
    assert (out["gt"].double() - rg).abs().max() < 1e-3


def test_classification_v2_augment():
    from jpeg_detection_resnet_ssd_torch.ops import make_dct_classification_augment_v2

    y, c = _planes(8, 32)
    out = make_dct_classification_augment_v2(28, device="cpu")(
        {"inputs": (y, c)}, inputs.step_generator(5, 0))
    d = augment.sample_classification_v2(inputs.step_generator(5, 0), 8, 32, 32)
    ry, rc = augment.classification_v2(y, c, d)
    assert compare._rel_rows(out["inputs"][0], ry).max() < 1e-5
    assert compare._rel_rows(out["inputs"][1], rc).max() < 1e-5


def _program(name, W, **kw):
    from jpeg_detection_resnet_ssd_torch.models import build_model

    module, _ = build_model(name, device="cpu", **kw)
    weights.load_into(module, W)
    return module


def test_detector_forward_encode_loss_and_decode():
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.losses import SSDLoss
    from jpeg_detection_resnet_ssd_torch.models.ssd import make_inference_fn, ssd_predictor_sizes

    W = weights.make(detector.layers(20), 1, "cpu")
    y, c = (t.float() for t in _planes(2, 38))
    compare.calibrate({"network": detector, "config": {"n_classes": 20}}, W, (y, c), 2,
                      torch.device("cpu"))
    m = _program("ssd300_ssd_custom", W, n_classes=20)
    with torch.no_grad():
        out = m((y, c))
        rs, ro = detector.forward(nets.Net(W), y, c, 20)
    assert compare._rel_rows(out[..., :21], rs).max() < 1e-4
    assert compare._rel_rows(out[..., 21:25], ro).max() < 1e-4
    dets = make_inference_fn(20, AnchorSpec(), candidate_selector="shared", device="cpu")(out)
    ref = ssd.decode(detector.ANCHORS, *detector.split(out, 20), 20, 1024)
    assert compare._decode_gap(dets, ref).max() == 0.0

    gt, mask = (torch.as_tensor(a) for a in inputs.boxes(3, 1, 2, 304, BOXES)[0])
    enc = TargetEncoder(AnchorSpec(img_height=304, img_width=304),
                        ssd_predictor_sizes("resnet_custom"), n_classes=20, device="cpu")
    t_prog, t_ref = enc(gt, mask), ssd.encode(detector.ANCHORS, gt, mask, 304, 20)
    assert compare._target_gap(t_prog[..., :25], t_ref, 21) == 0.0
    m.train()
    out = m((y, c))
    rs, ro = detector.forward(nets.Net(W, train=True), y, c, 20)
    assert abs(float(SSDLoss()(t_prog, out)) - float(ssd.loss(t_ref.float(), rs, ro))) < 1e-3
    assert max(compare._worst_rows(p, r) for p, r in zip(detector.split(out, 20), (rs, ro))) < 1e-4


def test_classifier_forward():
    W = weights.make(classifier.layers(1000), 2, "cpu")
    y, c = (t.float() for t in _planes(2, 16))
    m = _program("resnet50_dct_late_concat_rfa_thinner", W, num_classes=1000).train()
    with torch.no_grad():
        (ref,) = classifier.forward(nets.Net(W, train=True), y, c, 1000)
        assert compare._rel_rows(m((y, c)), ref).max() < 1e-4
