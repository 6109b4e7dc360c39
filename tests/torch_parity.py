"""Helpers for the PyTorch-port parity tests: seeded flax variables.

`random_flax_variables` fills a flax module's variable tree (shapes from
`jax.eval_shape`, so nothing is initialised op by op) with NumPy draws from
a seed.  Unlike the init values (BatchNorm mean 0, var 1, scale 1, bias 0),
every leaf gets distinct values, so a swapped or mis-transposed leaf in the
weight bridge shows in the forward pass.  Scales are chosen to keep
activations of a deep random ResNet in a moderate range: the input
BatchNorms see the DCT planes' variance (Y ~ N(0, 100), CbCr ~ N(0, 30)),
and the last BatchNorm of each residual branch (`*_branch2c`) has a small
scale, so residual sums do not blow up over ~20 blocks.
"""

import jax
import numpy as np

_INPUT_SCALE = {"bn_y_in": 100.0, "bn_cbcr_in": 30.0}


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
