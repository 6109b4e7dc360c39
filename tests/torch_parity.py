"""Helpers for the PyTorch-port parity tests: seeded flax variables.

`random_flax_variables` fills a flax module's variable tree (shapes from
`jax.eval_shape`, so nothing is initialised op by op) with NumPy draws from
a seed.  Unlike the init values (BatchNorm mean 0, var 1, scale 1, bias 0),
every leaf gets distinct values, so a swapped or mis-transposed leaf in the
weight bridge shows in the forward pass.  Scales are chosen to keep
activations of a deep random ResNet in a moderate range: the input
BatchNorms see the DCT planes' variance (Y ~ N(0, 100), CbCr ~ N(0, 30);
`bn_in` the up-sampling stems' concat of both, `bn_conv1` the RGB model's
first conv on 0-255 pixels; the VGG models' `b_norm_64` / `b_norm_128`
the planes, `b_norm` / `b_norm_input` a 0-255 image),
and the last BatchNorm of each residual branch (`*_branch2c`) has a small
scale, so residual sums do not blow up over ~20 blocks.
"""

import contextlib

import jax
import numpy as np

_INPUT_SCALE = {"bn_y_in": 100.0, "bn_cbcr_in": 30.0, "bn_in": 100.0, "bn_conv1": 150.0,
                "b_norm_64": 100.0, "b_norm_128": 30.0, "b_norm": 150.0, "b_norm_input": 150.0}


def random_flax_variables(module, *args, seed=0, **kwargs):
    """{"params", "batch_stats"} of `module` (initialised with `*args,
    **kwargs`) as NumPy arrays drawn from `seed`."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs)
    )

    def leaf(path, sd):
        names = [p.key for p in path]
        collection, owner, name = names[0], names[-2], names[-1]
        shape = sd.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            draw = rng.normal(0, np.sqrt(2.0 / fan_in), shape)
        elif name == "gamma":
            draw = rng.uniform(15, 25, shape)
        elif collection == "batch_stats":
            scale = _INPUT_SCALE.get(owner, 1.0)
            if name == "mean":
                draw = rng.normal(0, 0.1 * scale, shape)
            else:
                draw = rng.uniform(0.5, 1.5, shape) * scale**2
        elif name == "scale":
            lo, hi = (0.1, 0.3) if owner.endswith("2c") else (0.5, 1.5)
            draw = rng.uniform(lo, hi, shape)
        elif name == "bias":
            draw = rng.normal(0, 0.1, shape)
        else:
            raise KeyError("/".join(names))
        return draw.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def port_module(name, variables, **kwargs):
    """The port's registry model `name` holding flax `variables`, in eval
    mode on the CPU.  It is built on the meta device, so the port's own
    initialisation (seconds for a VGG classifier's 100M-weight fc1) is
    skipped; every tensor comes from `variables`."""
    import torch

    from jpeg_detection_resnet_ssd_torch.compat import load_flax_variables
    from jpeg_detection_resnet_ssd_torch.models.zoo import MODEL_REGISTRY

    with torch.device("meta"):
        module, _ = MODEL_REGISTRY[name](**kwargs)
    module = module.to_empty(device="cpu")
    for buf_name, buf in module.named_buffers():
        if buf_name.endswith("num_batches_tracked"):
            buf.zero_()
    return load_flax_variables(module, variables).eval()


def flax_dropout_masks(rng, batch, width=4096):
    """The two bool masks that the VGG head's `Dropout_0` and `Dropout_1`
    (scope `head`) draw from the dropout key `rng`: a probe module with the
    same scope path, applied to ones."""
    from flax import linen as nn
    import jax.numpy as jnp

    class Head(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dropout(0.5, deterministic=False)(x), nn.Dropout(0.5, deterministic=False)(x)

    class Probe(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Head(name="head")(x)

    outs = Probe().apply({}, jnp.ones((batch, width)), rngs={"dropout": rng})
    return [np.asarray(o) != 0 for o in outs]


@contextlib.contextmanager
def float64_convs_as_matmuls():
    """Inside, a float64 `lax.conv_general_dilated` (NHWC x HWIO, one group,
    no input dilation) runs as its taps gathered into columns and one
    matmul.  XLA's CPU backend has no library convolution for float64 and
    its own loop reaches ~1.4 GFLOP/s (a 38x38 512->512 conv takes 4.8 s;
    as a matmul 0.06 s), so a float64 train step of a VGG model would take
    half a minute.  The two agree to 2e-15 of the output's largest value
    there, far below the float64 tests' tolerances; anything else goes to
    the library convolution unchanged.  Flax's `Conv` looks the function
    up when it is called, so a step traced inside uses the matmul form."""
    from jax import lax
    import jax.numpy as jnp

    library_conv = lax.conv_general_dilated

    def conv(lhs, rhs, window_strides, padding, lhs_dilation=None, rhs_dilation=None,
             dimension_numbers=None, feature_group_count=1, **kwargs):
        nhwc = lax.conv_dimension_numbers(lhs.shape, rhs.shape, ("NHWC", "HWIO", "NHWC"))
        if (lhs.dtype != jnp.float64 or feature_group_count != 1
                or tuple(lhs_dilation or (1, 1)) != (1, 1)
                or lax.conv_dimension_numbers(lhs.shape, rhs.shape, dimension_numbers) != nhwc):
            return library_conv(lhs, rhs, window_strides, padding, lhs_dilation, rhs_dilation,
                                dimension_numbers, feature_group_count, **kwargs)
        kh, kw, c, k = rhs.shape
        (sh, sw), (dh, dw) = window_strides, tuple(rhs_dilation or (1, 1))
        span = ((kh - 1) * dh + 1, (kw - 1) * dw + 1)
        if isinstance(padding, str):
            padding = lax.padtype_to_pads(lhs.shape[1:3], span, window_strides, padding)
        x = jnp.pad(lhs, ((0, 0), tuple(padding[0]), tuple(padding[1]), (0, 0)))
        ho = (x.shape[1] - span[0]) // sh + 1
        wo = (x.shape[2] - span[1]) // sw + 1
        cols = jnp.concatenate(
            [x[:, i * dh:i * dh + (ho - 1) * sh + 1:sh, j * dw:j * dw + (wo - 1) * sw + 1:sw]
             for i in range(kh) for j in range(kw)], axis=-1)
        return jnp.dot(cols, rhs.reshape(kh * kw * c, k))

    lax.conv_general_dilated = conv
    try:
        yield
    finally:
        lax.conv_general_dilated = library_conv
