"""Keras H5 -> port module weight import, keyed by layer name.

Counterpart of the JAX package's `compat/h5_import.py`, whose
`import_weights_by_name` fills a flax variable tree: here the weights go into
a port `nn.Module`, whose layers carry the same Keras names.  For every H5
layer whose name matches a layer of the module, its weights are copied;
every other layer is skipped, and the report says what happened.

A Keras weight name maps to its flax leaf (`_KERAS_TO_FLAX`), and the flax
leaf to the module's tensor through `compat.flax_bridge`'s leaf table, so
the two importers share one naming:

  Conv2D     kernel (kh, kw, cin, cout), bias      -> weight (OIHW), bias
  Dense      kernel (cin, cout), bias              -> weight (cout, cin), bias
  BatchNorm  gamma, beta, moving_mean, moving_var  -> weight, bias,
             running_mean, running_var
  L2Normalization  <name>_gamma (c,)               -> gamma
  Conv2DTranspose  kernel (kh, kw, cout, cin)      -> (kh, kw, cin, cout) as
             the JAX importer takes it (`transpose_conv_layers`), then the
             port's ConvTranspose layout (`flax_bridge.kernel_to_torch`)

A kernel whose rank the layer does not take does not fit, and its layer is
reported mismatched.

h5py is imported inside the functions, so the package imports without it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import _LEAF_NAMES, kernel_to_torch


def _h5_weight_group(f):
    """Handle both `model.save()` (weights under 'model_weights') and
    `model.save_weights()` (top-level) H5 layouts."""
    return f["model_weights"] if "model_weights" in f else f


def list_h5_layers(h5_path: str) -> dict[str, list[tuple[str, tuple]]]:
    """{layer_name: [(weight_name, shape), ...]} for layers with weights."""
    import h5py

    out = {}
    with h5py.File(h5_path, "r") as f:
        g = _h5_weight_group(f)
        for lname in g:
            grp = g[lname]
            names = grp.attrs.get("weight_names", [])
            weights = []
            for wn in names:
                wn = wn.decode() if isinstance(wn, bytes) else str(wn)
                weights.append((wn, tuple(grp[wn].shape)))
            if weights:
                out[lname] = weights
    return out


def load_keras_h5_weights(h5_path: str) -> dict[str, dict[str, np.ndarray]]:
    """{layer_name: {short_weight_name: array}} from a Keras H5 file."""
    import h5py

    out: dict[str, dict[str, np.ndarray]] = {}
    with h5py.File(h5_path, "r") as f:
        g = _h5_weight_group(f)
        for lname in g:
            grp = g[lname]
            names = grp.attrs.get("weight_names", [])
            weights = {}
            for wn in names:
                wn = wn.decode() if isinstance(wn, bytes) else str(wn)
                short = wn.split("/")[-1].split(":")[0]
                weights[short] = np.asarray(grp[wn])
            if weights:
                out[lname] = weights
    return out


# Keras weight name -> (flax collection, flax leaf); `<layer>_gamma`
# (L2Normalization) is ("params", "gamma").
_KERAS_TO_FLAX = {
    "kernel": ("params", "kernel"),
    "bias": ("params", "bias"),
    "gamma": ("params", "scale"),  # BatchNorm
    "beta": ("params", "bias"),  # BatchNorm
    "moving_mean": ("batch_stats", "mean"),
    "moving_variance": ("batch_stats", "var"),
}


def _leaf_scopes(state: dict) -> dict[str, list[str]]:
    """Keras layer name -> the module paths ending in it that hold tensors
    directly and have no sub-layer holding any (flax's leaf scopes), in
    state_dict order."""
    scopes = list(dict.fromkeys(k.rsplit(".", 1)[0] for k in state if "." in k))
    index: dict[str, list[str]] = {}
    for scope in scopes:
        if any(other.startswith(scope + ".") for other in scopes):
            continue
        index.setdefault(scope.rsplit(".", 1)[-1], []).append(scope)
    return index


def import_weights_by_name(
    module: nn.Module,
    h5_path: str,
    rename: dict[str, str] | None = None,
    transpose_conv_layers: tuple = (),
    verbose: bool = False,
):
    """Load the matching H5 layers' weights into `module`, in place.

    Args:
      module: a port module whose layers carry Keras names.
      rename: optional {h5_layer_name: module_layer_name} overrides.
      transpose_conv_layers: layer names whose kernels are Conv2DTranspose
        (Keras stores (kh, kw, cout, cin)).

    Returns (module, report) where report lists loaded / skipped /
    shape-mismatched H5 layer names, as the JAX package's importer does.  A
    layer is loaded whole or not at all.
    """
    h5 = load_keras_h5_weights(h5_path)
    rename = rename or {}
    state = module.state_dict()
    scope_index = _leaf_scopes(state)
    report = {"loaded": [], "skipped": [], "mismatched": []}

    for lname, weights in h5.items():
        target = rename.get(lname, lname)
        scopes = scope_index.get(target)
        if not scopes:
            report["skipped"].append(lname)
            continue
        scope = scopes[0]
        staged = []
        for wname, arr in weights.items():
            if wname in _KERAS_TO_FLAX:
                collection, leaf = _KERAS_TO_FLAX[wname]
            elif wname.endswith("_gamma"):  # L2Normalization
                collection, leaf = "params", "gamma"
            else:
                break
            key = f"{scope}.{_LEAF_NAMES[collection][leaf]}"
            if leaf == "kernel":
                if lname in transpose_conv_layers:
                    arr = np.transpose(arr, (0, 1, 3, 2))
                arr = kernel_to_torch(module.get_submodule(scope), arr)
                if arr is None:
                    break
            if key not in state or tuple(state[key].shape) != tuple(arr.shape):
                break
            staged.append((state[key], arr))
        else:
            with torch.no_grad():
                for tensor, arr in staged:
                    tensor.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
            report["loaded"].append(lname)
            continue
        report["mismatched"].append(lname)

    if verbose:
        print(
            f"h5 import: {len(report['loaded'])} loaded, "
            f"{len(report['skipped'])} skipped, "
            f"{len(report['mismatched'])} mismatched"
        )
    return module, report
