"""`ops.batch_norm` on the CPU: which version runs, the inputs the models
hand it, and the closed-form backward that the CUDA kernels compute.

The kernels themselves run only on the card (`tests/test_torch_cuda.py`);
here their arithmetic is checked in float64 against autograd through the
plain version, where the two can agree to 1e-12.
"""

import pytest
import torch

from jpeg_detection_resnet_ssd_torch.models import build_model, layers
from jpeg_detection_resnet_ssd_torch.ops import batch_norm

import torch_dp_worker as worker

torch.set_num_threads(1)


def _state(c, gen, dtype=torch.float32):
    return {"weight": (1 + 0.1 * torch.randn(c, generator=gen)).to(dtype),
            "bias": (0.1 * torch.randn(c, generator=gen)).to(dtype),
            "running_mean": 0.1 * torch.randn(c, generator=gen),
            "running_var": 1 + torch.rand(c, generator=gen),
            "num_batches_tracked": torch.tensor(3)}


def _call(x, s, impl, **kw):
    return batch_norm.batch_norm_train(x, s["weight"], s["bias"], s["running_mean"], s["running_var"],
                                       s["num_batches_tracked"], kw.pop("momentum", 0.01), 1e-3,
                                       impl=impl, **kw)


def test_auto_takes_the_plain_version_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 5, 8, generator=gen)
    a = _state(8, gen)
    b = {k: v.clone() for k, v in a.items()}
    before = batch_norm.LAUNCHES
    got = _call(x, a, "auto")
    ref = _call(x, b, "reference")
    assert batch_norm.LAUNCHES == before
    assert torch.equal(got, ref)
    assert all(torch.equal(a[k], b[k]) for k in a) and int(a["num_batches_tracked"]) == 4


def test_kernel_raises_on_the_cpu_and_bad_arguments_raise():
    gen = torch.Generator().manual_seed(1)
    x, s = torch.randn(2, 3, 3, 8, generator=gen), _state(8, gen)
    with pytest.raises(ValueError, match="cuda"):
        _call(x, s, "kernel")
    with pytest.raises(ValueError, match="impl"):
        _call(x, s, "pallas")
    with pytest.raises(ValueError, match=r"\(B, H, W, C\)"):
        _call(x[0], s, "auto")
    assert int(s["num_batches_tracked"]) == 3  # nothing moved


@pytest.mark.parametrize("name,kwargs,y_blocks", [
    ("ssd300_ssd_custom", {"n_classes": 20}, 38),
    ("resnet50_dct_late_concat_rfa_thinner", {"num_classes": 10}, 28),
])
def test_every_train_mode_batch_norm_gets_a_contiguous_nhwc_input(name, kwargs, y_blocks):
    """The kernels take a contiguous (B, H, W, C) tensor (the op copies any
    other first): all 71 BatchNorms of both configurations get one as it is,
    since cuDNN's channels_last output viewed as NHWC is contiguous."""
    model, _ = build_model(name, device="cpu", **kwargs)
    model.train()
    seen = []

    def hook(mod, args):
        x = args[0]
        seen.append((x.dim() == 4 and x.shape[-1] == mod.num_features, x.is_contiguous()))

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules() if isinstance(m, layers.BatchNorm)]
    gen = torch.Generator().manual_seed(2)
    cb = (y_blocks + 1) // 2
    with torch.no_grad():
        model((torch.randn(2, y_blocks, y_blocks, 64, generator=gen),
               torch.randn(2, cb, cb, 128, generator=gen)))
    for h in hooks:
        h.remove()
    assert len(seen) == 71
    assert all(nhwc and contiguous for nhwc, contiguous in seen)


def _raw_var(x):
    """E[x^2] - E[x]^2 a channel, as the plain version computes it."""
    return x.square().mean(dim=(0, 1, 2)) - x.mean(dim=(0, 1, 2)).square()


def _kernel_backward(x, dy, weight, eps):
    """The backward of `csrc/batch_norm.cu`, in closed form: with
    r = rsqrt(var + eps), s = r * weight, keep = 0 where E[x^2] - E[x]^2 < 0,
    dbias = sum dy, dweight = r * sum dy (x - mean),
    dx = s ((dy - sum dy / M) - (x - mean) keep r^2 sum dy (x - mean) / M)."""
    m = x.numel() // x.shape[-1]
    xm = x.reshape(m, -1)
    g = dy.reshape(m, -1)
    mean = xm.mean(0)
    raw = _raw_var(x).reshape(-1)
    r = torch.rsqrt(torch.clamp_min(raw, 0.0) + eps)
    keep = (raw >= 0).to(x.dtype)
    xc = xm - mean
    sg, sgx = g.sum(0), (g * xc).sum(0)
    dx = (r * weight) * ((g - sg / m) - xc * (keep * r * r * sgx / m))
    return dx.reshape(x.shape), r * sgx, sg


@pytest.mark.parametrize("shape", [(2, 5, 5, 6), (4, 3, 3, 8), (5, 1, 1, 3)])
def test_the_kernels_closed_form_backward_is_the_plain_versions_gradient(shape):
    """Float64, with a channel of spread 1e3 about a mean of 1e3, and a
    constant channel whose E[x^2] - E[x]^2 comes out below 0 and is clipped
    (no variance term), as clamp_min's gradient has it."""
    gen = torch.Generator().manual_seed(len(shape))
    c = shape[-1]
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    x[..., 0] = 1e3 + 1e3 * x[..., 0]
    for v in 0.1 * torch.arange(1, 200, dtype=torch.float64):  # a constant whose variance clips
        x[..., 1] = v
        if float(_raw_var(x)[1]) < 0:
            break
    assert float(_raw_var(x)[1]) < 0
    dy = torch.randn(shape, generator=gen, dtype=torch.float64)
    s = _state(c, gen, torch.float64)
    xr = x.clone().requires_grad_(True)
    w, b = s["weight"].clone().requires_grad_(True), s["bias"].clone().requires_grad_(True)
    y = batch_norm.batch_norm_train_reference(xr, w, b, s["running_mean"].double(),
                                              s["running_var"].double(), s["num_batches_tracked"],
                                              0.01, 1e-3)
    y.backward(dy)
    dx, dw, db = _kernel_backward(x, dy, s["weight"], 1e-3)
    for got, ref in ((dx, xr.grad), (dw, w.grad), (db, b.grad)):
        torch.testing.assert_close(got, ref, rtol=1e-10, atol=1e-10 * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_on_two_data_ranks_equals_one_process(tmp_path, dtype):
    """Under a mesh of two data ranks the plain version normalises by the
    global batch's statistics: the ranks' y and dx rows, their summed
    dweight and dbias and their (bit-identical) running statistics agree
    with one process on the global batch to float32 summation order."""
    gaps, outs, (rank_launches, one_launches) = worker.batch_norm_ranks_against_one_process(
        str(tmp_path), shape=[4, 5, 5, 16], dtype=dtype, device="cpu")
    assert max(gaps.values()) <= 1.0, gaps
    assert all(torch.equal(outs[0][k], outs[1][k])
               for k in ("running_mean", "running_var", "num_batches_tracked"))
    assert rank_launches == [0, 0] and one_launches == 0
