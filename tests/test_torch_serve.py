"""The port's `serve/` against the JAX package's, on the CPU: BatchNorm
folding, `torch.export` artifacts and int8 quantization.

Each case mirrors one of `tests/test_serve.py`.  Weights are seeded flax
variables (`torch_parity.random_flax_variables`: every BatchNorm has
non-trivial running statistics and affine parameters, so folding has real
work) carried into the port with `compat.load_flax_variables`; models run at
batch 1.  Paths compare with the JAX package's '/' read as '.'.

Tolerances, each with its reason:
  * folded against unfolded eval outputs: 1e-5 of the largest output (the
    JAX test's bound; folding reassociates one multiply per BatchNorm);
  * folded weights and affines against the JAX package's folded variables:
    1 float32 ulp (the same float32 operations; sqrt and division are
    correctly rounded on both sides);
  * the exported program against the in-process serving module: equal (the
    same aten operations on the same CPU);
  * the port's exported detector against JAX's folded decode: the end-to-end
    tolerance of `test_torch_slice.py` (class ids equal, scores 1e-4, boxes
    1e-3 px: the forwards' convolutions sum in other orders);
  * int8 accumulators: exact (integer sums); a quantized conv's output: one
    float32 ulp of the rescale's largest term (XLA may fuse the rescale's
    multiply and add);
  * the quantized detector with JAX's activation scales: relative RMS of
    conf and loc under 0.05 (below the JAX test's int8-against-float bound;
    an activation that lands on the other side of a rounding step between
    the two frameworks' float convolutions moves by one int8 step).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import traverse_util

from jpeg_detection_resnet_ssd_tpu.boxes import AnchorSpec as JaxAnchorSpec
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_tpu.models import make_inference_fn as jax_inference_fn
from jpeg_detection_resnet_ssd_tpu.serve import (
    bn_fold_pairs as jax_bn_fold_pairs,
    calibrate_activation_scales as jax_calibrate,
    fold_batch_norm as jax_fold_batch_norm,
    make_quantized_apply as jax_make_quantized_apply,
    quantize_conv_weights as jax_quantize_conv_weights,
)
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import kernel_to_torch
from jpeg_detection_resnet_ssd_torch.models import make_inference_fn
from jpeg_detection_resnet_ssd_torch.models.layers import Conv
from jpeg_detection_resnet_ssd_torch.ops import batched_nms
from jpeg_detection_resnet_ssd_torch.serve import (
    bn_fold_pairs,
    build_serving_fn,
    calibrate_activation_scales,
    export_serving_artifact,
    fold_batch_norm,
    load_serving_artifact,
    make_quantized_apply,
    quantize_conv_weights,
    quantize_for_serving,
)
from jpeg_detection_resnet_ssd_torch.serve.folding import ChannelAffine
from jpeg_detection_resnet_ssd_torch.serve.quantize import DEFAULT_SKIP, QuantizedConv

from torch_parity import port_module, random_flax_variables

FOLD_NAMES = ["ssd300_ssd_custom", "resnet50_rgb", "resnet50_dct_deconv", "vggd_dct"]


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this module's full-size models, and the
    process's count back afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _dotted(path: str) -> str:
    return path.replace("/", ".")


def _build(name, seed=0):
    """(JAX module, seeded variables, the port module holding them, batch-1
    NumPy inputs as a tuple)."""
    kw = {"n_classes": 20} if name.startswith("ssd300") else {}
    module, example = jax_build_model(name, **kw)
    ex = example()
    ex = ex if isinstance(ex, tuple) else (ex,)
    inputs = tuple(np.asarray(x[:1]) for x in ex)
    model_in = inputs[0] if len(inputs) == 1 else inputs
    variables = random_flax_variables(module, model_in, train=False, seed=seed)
    return module, variables, port_module(name, variables, **kw), inputs


@pytest.fixture(scope="module")
def models():
    return {name: _build(name) for name in FOLD_NAMES + ["ssd300_vgg_dct"]}


def _port_in(inputs):
    t = tuple(torch.from_numpy(x) for x in inputs)
    return t[0] if len(t) == 1 else t


def _jax_in(inputs):
    return inputs[0] if len(inputs) == 1 else inputs


# --------------------------------------------------------------------------
# Folding


@pytest.mark.parametrize("name", ["ssd300_ssd_custom", "resnet50_rgb"])
def test_fold_pairs_match_jax(models, name):
    _, variables, port, _ = models[name]
    jax_pairs, jax_affine = jax_bn_fold_pairs(variables)
    pairs, affine = bn_fold_pairs(port)
    assert pairs == {_dotted(b): _dotted(c) for b, c in jax_pairs.items()}
    assert affine == [_dotted(b) for b in jax_affine]
    if name == "ssd300_ssd_custom":
        assert len(pairs) == 69 and affine == ["bn_cbcr_in", "bn_y_in"]
    else:
        assert pairs["bn_conv1"] == "conv1"


@pytest.mark.parametrize("name", FOLD_NAMES)
def test_fold_preserves_eval_outputs(models, name):
    _, _, port, inputs = models[name]
    folded = fold_batch_norm(port)
    with torch.no_grad():
        a = port(_port_in(inputs)).double().numpy()
        b = folded(_port_in(inputs)).double().numpy()
    assert np.isfinite(a).all()
    scale = max(np.abs(a).max(), 1.0)
    assert np.max(np.abs(a - b)) / scale < 1e-5


@pytest.mark.parametrize("name", FOLD_NAMES)
def test_folded_parameters_equal_jax(models, name):
    """Each folded conv's weight and bias and each input BatchNorm's affine
    equal the JAX package's folded variables, carried through the bridge's
    layout, to 1 float32 ulp."""
    _, variables, port, _ = models[name]
    pairs, affine = bn_fold_pairs(port)
    folded = fold_batch_norm(port)
    want = traverse_util.flatten_dict(jax_fold_batch_norm(variables)["params"], sep="/")
    for conv_path in pairs.values():
        conv = folded.get_submodule(conv_path)
        flax_path = conv_path.replace(".", "/")
        np.testing.assert_array_max_ulp(
            conv.weight.numpy(), kernel_to_torch(conv, np.asarray(want[f"{flax_path}/kernel"])), 1)
        np.testing.assert_array_max_ulp(conv.bias.numpy(), np.asarray(want[f"{flax_path}/bias"]), 1)
    for bn_path in affine:
        mod = folded.get_submodule(bn_path)
        assert isinstance(mod, ChannelAffine)
        flax_path = bn_path.replace(".", "/")
        np.testing.assert_array_max_ulp(mod.weight.numpy(), np.asarray(want[f"{flax_path}/scale"]), 1)
        np.testing.assert_array_max_ulp(mod.bias.numpy(), np.asarray(want[f"{flax_path}/bias"]), 1)
    assert len(pairs) + len(affine) > 0


@pytest.mark.parametrize("name", FOLD_NAMES)
def test_folded_module_has_no_batch_norm(models, name):
    _, _, port, _ = models[name]
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules())
    folded = fold_batch_norm(port)
    assert n_bn > 0
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    assert not any(p.requires_grad for p in folded.parameters())
    # the original is untouched
    assert sum(isinstance(m, torch.nn.BatchNorm2d) for m in port.modules()) == n_bn


# --------------------------------------------------------------------------
# Export


class _Affine(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(
            torch.from_numpy(np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)),
            requires_grad=False)

    def forward(self, x, y):
        return torch.tanh(x @ self.weight) + y


class _Cumsum(torch.nn.Module):
    def forward(self, x):
        return torch.cumsum(x, dim=1) * 2.0


def test_roundtrip_matches_direct_call(tmp_path):
    fn = _Affine()
    x = np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32)
    y = np.random.default_rng(2).normal(size=(4, 8)).astype(np.float32)
    manifest = export_serving_artifact(fn, (x, y), str(tmp_path), device="cpu")
    assert manifest["bytes"] > 0 and not manifest["symbolic_batch"]
    loaded, m2 = load_serving_artifact(str(tmp_path))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    torch.testing.assert_close(loaded(xt, yt), fn(xt, yt), rtol=1e-6, atol=0)
    assert m2["inputs"][0]["shape"] == [4, 16] and m2["device"] == "cpu"
    with pytest.raises(TypeError, match="tensors on cpu"):
        loaded(x, y)


def test_symbolic_batch_serves_any_batch(tmp_path):
    export_serving_artifact(_Cumsum(), np.ones((2, 5), np.float32), str(tmp_path),
                            device="cpu", symbolic_batch=True)
    loaded, manifest = load_serving_artifact(str(tmp_path))
    assert manifest["symbolic_batch"] and manifest["inputs"][0]["shape"][0] == "b"
    for b in (1, 3, 7):
        x = torch.from_numpy(np.random.default_rng(b).normal(size=(b, 5)).astype(np.float32))
        torch.testing.assert_close(loaded(x), _Cumsum()(x), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="at least 2"):
        export_serving_artifact(_Cumsum(), np.ones((1, 5), np.float32), str(tmp_path / "b1"),
                                device="cpu", symbolic_batch=True)


@pytest.fixture(scope="module")
def detector(models, tmp_path_factory):
    """`ssd300_ssd_custom`'s serving module (folded forward + decode,
    top_k=20) exported at batch 1 on the CPU, loaded back and called."""
    _, _, port, inputs = models["ssd300_ssd_custom"]
    decode = make_inference_fn(n_classes=20, spec=AnchorSpec(), top_k=20, device="cpu")
    serving = build_serving_fn(port, decode_fn=decode)
    out_dir = str(tmp_path_factory.mktemp("detector"))
    manifest = export_serving_artifact(
        serving, inputs, out_dir, device="cpu",
        manifest_extra={"model": "ssd300_ssd_custom", "task": "detection"})
    loaded, _ = load_serving_artifact(out_dir)
    args = tuple(torch.from_numpy(x) for x in inputs)
    with torch.no_grad():
        want = serving(*args)
    yield dict(got=loaded(*args), want=want, manifest=manifest,
               program=torch.export.load(f"{out_dir}/{manifest['artifact']}"))
    shutil.rmtree(out_dir)  # ~210 MB of float32 weights


def test_detector_artifact_equals_the_in_process_call(detector):
    got, want = detector["got"], detector["want"]
    assert got.shape == (1, 20, 6) and bool(torch.isfinite(got).all())
    assert int((got[..., 1] > 0).sum()) > 0
    assert torch.equal(got, want)
    assert detector["manifest"]["requires"]["import"] == "jpeg_detection_resnet_ssd_torch.ops"


def test_detector_artifact_matches_jax_folded_decode(models, detector):
    module, variables, _, inputs = models["ssd300_ssd_custom"]
    folded = jax_fold_batch_norm(variables)
    decode = jax_inference_fn(n_classes=20, spec=JaxAnchorSpec(), top_k=20, nms_impl="xla")
    want = np.asarray(jax.jit(lambda v, i: decode(module.apply(v, i, train=False)))(
        folded, _jax_in(inputs)))
    got = detector["got"].numpy()
    assert (want[..., 1] > 0).sum() > 0
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0, atol=1e-3)


def test_exported_graph_holds_the_nms_op_once(detector):
    """B1 is one node of the exported decode (the plain NMS's 400-step loop
    would be unrolled into thousands), and no filter-gradient Function."""
    graph = detector["program"].graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    assert targets.count("jpeg_detection_resnet_ssd_torch.batched_nms_mask.default") == 1
    assert len(graph.nodes) < 3000


def test_nms_op_dispatches_to_the_plain_version_on_the_cpu():
    """The custom operator's CPU implementation is the plain version and
    counts no launch; its fake implementation gives traces the mask's shape."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 200, (6, 30, 2)).astype(np.float32)
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 60, (6, 30, 2))], -1).astype(np.float32))
    scores = torch.from_numpy(np.sort(rng.uniform(0, 1, (6, 30)).astype(np.float32))[:, ::-1].copy())
    before = batched_nms.LAUNCHES
    got = torch.ops.jpeg_detection_resnet_ssd_torch.batched_nms_mask(boxes, scores, 0.45, 0.0)
    assert batched_nms.LAUNCHES == before
    assert torch.equal(got, batched_nms.batched_nms_mask_reference(boxes, scores, 0.45, 0.0))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = batched_nms.batched_nms_mask(mode.from_tensor(boxes), mode.from_tensor(scores))
    assert fake.shape == (6, 30) and fake.dtype == torch.bool


# --------------------------------------------------------------------------
# Quantize


class _OneConv(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.Conv(32, (3, 3), name="c")(x)


class _PortOneConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c = Conv(16, 32, 3)

    def forward(self, x):
        return self.c(x)


def test_single_conv_accumulators_equal_jax():
    m = _OneConv()
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 16, 16, 16)).astype(np.float32)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, a.shape).astype(np.float32), v)
    jax_scales = jax_calibrate(m, v, [jnp.asarray(x)])
    jax_qw = jax_quantize_conv_weights(v, jax_scales, skip=())
    want = np.asarray(jax.jit(jax_make_quantized_apply(m, v, jax_scales, jax_qw))(jnp.asarray(x)))
    w_q, s_w = jax_qw["c"]
    s_x = jax_scales["c"]
    x_q = jnp.clip(jnp.round(jnp.asarray(x) / s_x), -127, 127).astype(jnp.int8)
    acc_want = np.asarray(jax.lax.conv_general_dilated(
        x_q, w_q, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))

    port = _PortOneConv()
    with torch.no_grad():
        port.c.weight.copy_(torch.from_numpy(np.asarray(v["params"]["c"]["kernel"]).transpose(3, 2, 0, 1)))
        port.c.bias.copy_(torch.from_numpy(np.asarray(v["params"]["c"]["bias"])))
    scales = calibrate_activation_scales(port, [torch.from_numpy(x)])
    assert scales == jax_scales
    qw = quantize_conv_weights(port, scales, skip=())
    np.testing.assert_array_equal(qw["c"][0].numpy().transpose(2, 3, 1, 0), np.asarray(w_q))
    np.testing.assert_array_equal(qw["c"][1].numpy(), np.asarray(s_w))
    qmodel = make_quantized_apply(port, scales, qw)
    qconv = qmodel.c
    assert isinstance(qconv, QuantizedConv)
    assert {n for n, _ in qconv.named_buffers()} == {"weight_q", "s_x", "rescale", "bias"}
    acc = qconv.accumulate(torch.from_numpy(x))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), acc_want)
    with torch.no_grad():
        got = qmodel(torch.from_numpy(x)).numpy()
    term = np.abs(acc_want.astype(np.float32) * qconv.rescale.numpy())
    assert np.all(np.abs(got - want) <= np.spacing(np.maximum(term, np.abs(want))))
    assert np.max(np.abs(got - port(torch.from_numpy(x)).detach().numpy())) > 0  # int8 ran


def test_default_skip_patterns_on_paths():
    """DEFAULT_SKIP keeps the raw-DCT stem convs and the head float by path."""
    paths = ["conv1_1_dct", "conv1_1_dct_256", "deconv_cb", "deconv_cr", "fc6", "fc7", "conv4_1",
             "head.fc7_mbox_loc"]
    root = torch.nn.Module()
    root.head = torch.nn.Module()
    for p in paths:
        owner, _, name = ("root." + p).rpartition(".")
        (root.head if owner == "root.head" else root).add_module(name, Conv(4, 8, 3))
    q = quantize_conv_weights(root, paths, skip=DEFAULT_SKIP)
    assert sorted(q) == ["conv4_1", "fc6", "fc7"]


@pytest.fixture(scope="module")
def quantized(models):
    """The JAX package's `quantize_for_serving` steps (fold, calibrate,
    quantize: its `info` lists and its activation scales) and the port's
    `quantize_for_serving` on two SSDs, calibrated on the batch-1 inputs."""
    out = {}
    for name in ("ssd300_ssd_custom", "ssd300_vgg_dct"):
        module, variables, port, inputs = models[name]
        folded = jax_fold_batch_norm(variables)
        jax_scales = jax_calibrate(module, folded, [_jax_in(inputs)])
        # one compile for every conv (op by op, each new shape compiles)
        jax_qw = jax.jit(lambda v: jax_quantize_conv_weights(v, list(jax_scales)))(folded)
        qmodel, info = quantize_for_serving(port, [_port_in(inputs)])
        out[name] = dict(jax_scales=jax_scales, jax_qw=jax_qw, folded=folded, info=info,
                         qmodel=qmodel)
    return out


@pytest.mark.parametrize("name", ["ssd300_ssd_custom", "ssd300_vgg_dct"])
def test_quantize_for_serving_lists_match_jax(quantized, name):
    q = quantized[name]
    info, qmodel = q["info"], q["qmodel"]
    assert info["quantized"] == sorted(_dotted(p) for p in q["jax_qw"])
    assert info["kept_float"] == sorted(_dotted(p) for p in set(q["jax_scales"]) - set(q["jax_qw"]))
    assert info["n_calibration_batches"] == 1
    assert not any(p.startswith("head.") for p in info["quantized"] + info["kept_float"])
    assert "fc6" in info["quantized"]
    if name == "ssd300_ssd_custom":
        assert len(info["quantized"]) >= 50 and info["kept_float"] == []
    else:
        assert info["kept_float"] == ["conv1_1_dct_256"]
    assert all(isinstance(qmodel.get_submodule(p), QuantizedConv) for p in info["quantized"])


def test_quantized_outputs_with_jax_scales_agree(models, quantized):
    """JAX's activation scales fed to the port: the quantized raw outputs
    (conf and loc) agree to a relative RMS under 0.05 (see the module
    docstring); anchors and variances exactly."""
    module, _, port, inputs = models["ssd300_ssd_custom"]
    q = quantized["ssd300_ssd_custom"]
    jax_scales = q["jax_scales"]
    want = np.asarray(jax.jit(jax_make_quantized_apply(module, q["folded"], jax_scales, q["jax_qw"]))(
        _jax_in(inputs)), np.float64)
    folded = fold_batch_norm(port)
    scales = {_dotted(p): s for p, s in jax_scales.items()}
    qmodel = make_quantized_apply(folded, scales, quantize_conv_weights(folded, scales))
    with torch.no_grad():
        got = qmodel(_port_in(inputs)).double().numpy()
    np.testing.assert_array_equal(got[..., 25:], want[..., 25:])
    for cols in (slice(0, 21), slice(21, 25)):
        rel_rms = np.sqrt(np.mean((got[..., cols] - want[..., cols]) ** 2)) / np.sqrt(
            np.mean(want[..., cols] ** 2))
        assert rel_rms < 0.05, (cols, rel_rms)


def test_quantized_artifact_smaller_and_loadable(quantized, tmp_path):
    qmodel = quantized["ssd300_ssd_custom"]["qmodel"]
    rng = np.random.default_rng(3)
    inputs = (torch.from_numpy(rng.normal(0, 100, (1, 38, 38, 64)).astype(np.float32)),
              torch.from_numpy(rng.normal(0, 30, (1, 19, 19, 128)).astype(np.float32)))
    serving = build_serving_fn(qmodel, fold_bn=False)
    manifest = export_serving_artifact(serving, inputs, str(tmp_path), device="cpu")
    # int8 trunk weights: about a quarter of the float artifact's ~210 MB
    assert manifest["bytes"] < 100_000_000
    loaded, _ = load_serving_artifact(str(tmp_path))
    with torch.no_grad():
        want = serving(*inputs)
    got = loaded(*inputs)
    assert got.shape == (1, 8732, 33) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    shutil.rmtree(tmp_path)
