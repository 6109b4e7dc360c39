"""Port module or flax-layout variables -> Keras-layout H5 weights.

Counterpart of the JAX package's `compat/h5_export.py`, the inverse of
`h5_import`: writes a weights file that the reference's Keras toolchain
(`load_weights(by_name=True)`) and both packages' `import_weights_by_name`
read.  Layer scopes become Keras layer groups
(`model_weights/<layer>/<layer>/<w>:0`, with the `weight_names` and
`layer_names` attributes); BatchNorm scale/bias/mean/var become
gamma/beta/moving_mean/moving_variance and an L2Normalization's gamma
`<name>_gamma`.  A port module goes through `compat.flax_variables`, so the
file is the one the JAX exporter writes for the same weights.

h5py is imported inside the function, so the package imports without it.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
from torch import nn

from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import flax_variables


def _walk_scopes(tree: Mapping, prefix=()):
    """Yield (path, subtree) for every mapping node, depth first."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield prefix + (k,), v
            yield from _walk_scopes(v, prefix + (k,))


def _is_leaf_scope(node: Mapping) -> bool:
    return not any(isinstance(v, Mapping) for v in node.values())


def export_keras_h5(module_or_variables, h5_path: str) -> list[str]:
    """Write a port module's weights, or `{'params', 'batch_stats'}`
    flax-layout NumPy variables, as a Keras weights H5.  Returns the
    exported layer names, in file order."""
    import h5py

    variables = (flax_variables(module_or_variables) if isinstance(module_or_variables, nn.Module)
                 else module_or_variables)
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    stats_by_name: dict[str, Mapping] = {}
    for path, node in _walk_scopes(stats):
        if _is_leaf_scope(node):
            stats_by_name[path[-1]] = node

    exported = []
    with h5py.File(h5_path, "w") as f:
        g = f.create_group("model_weights")
        for path, node in _walk_scopes(params):
            if not _is_leaf_scope(node):
                continue
            lname = path[-1]
            weights: dict[str, np.ndarray] = {}
            if "scale" in node:  # BatchNorm
                weights["gamma"] = node["scale"]
                weights["beta"] = node["bias"]
                bn_stats = stats_by_name.get(lname, {})
                if "mean" in bn_stats:
                    weights["moving_mean"] = bn_stats["mean"]
                    weights["moving_variance"] = bn_stats["var"]
            elif "gamma" in node:  # L2Normalization
                weights[f"{lname}_gamma"] = node["gamma"]
            else:
                if "kernel" in node:
                    weights["kernel"] = node["kernel"]
                if "bias" in node:
                    weights["bias"] = node["bias"]
            if not weights:
                continue
            grp = g.create_group(lname)
            wnames = [f"{lname}/{w}:0" for w in weights]
            grp.attrs["weight_names"] = np.array(
                [w.encode() for w in wnames], dtype=f"S{max(map(len, wnames)) + 1}"
            )
            for wn, arr in zip(wnames, weights.values()):
                grp.create_dataset(wn, data=np.asarray(arr))
            exported.append(lname)
        g.attrs["layer_names"] = np.array(
            [n.encode() for n in exported],
            dtype=f"S{max((len(n) for n in exported), default=1) + 1}",
        )
    return exported
