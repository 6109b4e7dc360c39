"""Serving-artifact export and load via `torch.export`.

Counterpart of the JAX package's `serve/export.py`.  The artifact is one
`torch.export` program, `model.pt2`: the serving module -- the eval forward
(BatchNorm folded by default) and, for SSD models, the detection decode --
with its weights saved beside the graph.  Loading needs no model-building
code.  Unlike the JAX artifact, which needed jax alone, it needs
`jpeg_detection_resnet_ssd_torch.ops` imported: the decode's greedy NMS is
that module's custom operator `jpeg_detection_resnet_ssd_torch::
batched_nms_mask` (the CUDA kernel B1 on the card, its plain version on the
CPU).  `manifest.json` beside it records the input contract, the device the
program was exported for (the JAX `platforms`), and that requirement.

With `symbolic_batch=True` every input's leading dimension is one
`torch.export.Dim`, so one artifact serves any batch size.  Export at an
example batch of at least 2: torch specializes a dimension of size 1.
"""

from __future__ import annotations

import copy
import importlib
import json
import os
from typing import Any, Callable

import torch
from torch import nn

from jpeg_detection_resnet_ssd_torch.models import layers
from jpeg_detection_resnet_ssd_torch.serve.folding import fold_batch_norm
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device
from jpeg_detection_resnet_ssd_torch.utils.profiling import span

ARTIFACT_NAME = "model.pt2"
MANIFEST_NAME = "manifest.json"
OPS_MODULE = "jpeg_detection_resnet_ssd_torch.ops"
REQUIRES = {
    "import": OPS_MODULE,
    "why": "the decode's NMS is the custom operator jpeg_detection_resnet_ssd_torch::"
           "batched_nms_mask (the CUDA kernel on the card); the JAX package's artifact "
           "needed jax alone",
}


class ServingModule(nn.Module):
    """`forward(*inputs)`: the eval forward of `model` on the inputs (one
    tensor, or the planes of a tuple input), then `decode_fn` if given."""

    def __init__(self, model: nn.Module, decode_fn: Callable | None = None):
        super().__init__()
        self.model = model
        self.decode_fn = decode_fn

    def forward(self, *inputs: torch.Tensor) -> torch.Tensor:
        args = inputs[0] if len(inputs) == 1 else inputs
        with span("serve"):
            # Serving has no backward; the filter-gradient kernel's autograd
            # Function cannot be exported.
            with span("forward"), layers.pallas_wgrad(False):
                out = self.model(args)
            if self.decode_fn is None:
                return out
            with span("decode"):
                return self.decode_fn(out)


def build_serving_fn(
    module: nn.Module,
    decode_fn: Callable | None = None,
    fold_bn: bool = True,
) -> ServingModule:
    """A `ServingModule` over an eval-mode copy of `module` (BatchNorm folded
    with `fold_bn`, see `serve.folding`); `module` is left as it is."""
    if fold_bn:
        model = fold_batch_norm(module)
    else:
        model = copy.deepcopy(module).eval().requires_grad_(False)
    return ServingModule(model, decode_fn).eval()


def _as_input_tuple(example_inputs, device: torch.device) -> tuple[torch.Tensor, ...]:
    if not isinstance(example_inputs, (tuple, list)):
        example_inputs = (example_inputs,)
    return tuple(torch.as_tensor(x, device=device) for x in example_inputs)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def export_serving_artifact(
    serving_fn: nn.Module,
    example_inputs,
    out_dir: str,
    device: str | torch.device | None = None,
    symbolic_batch: bool = False,
    manifest_extra: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """Export `serving_fn` and write `model.pt2` + `manifest.json`.

    `example_inputs` (a tensor or array, or a tuple of them) fixes shapes and
    dtypes; they are moved to `device` (CUDA unless the caller asks for the
    CPU), where `serving_fn`'s parameters must be.  With `symbolic_batch`
    the leading dimension of every input is one shared `torch.export.Dim`.
    Returns the manifest.
    """
    dev = resolve_device(device)
    inputs = _as_input_tuple(example_inputs, dev)
    dynamic_shapes = None
    if symbolic_batch:
        if inputs[0].shape[0] < 2:
            raise ValueError("export a symbolic batch at an example batch of at least 2: "
                             "torch specializes a dimension of size 1")
        b = torch.export.Dim("b")
        dynamic_shapes = torch.export.ShapesCollection()
        for x in inputs:
            dynamic_shapes[x] = {0: b}
    program = torch.export.export(serving_fn, inputs, dynamic_shapes=dynamic_shapes, strict=False)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ARTIFACT_NAME)
    torch.export.save(program, path)
    manifest = {
        "format": "torch.export",
        "torch_version": torch.__version__,
        "device": str(inputs[0].device),
        "requires": REQUIRES,
        "inputs": [
            {
                "shape": ["b" if symbolic_batch else int(x.shape[0])] + [int(d) for d in x.shape[1:]],
                "dtype": _dtype_name(x.dtype),
            }
            for x in inputs
        ],
        "symbolic_batch": bool(symbolic_batch),
        "artifact": ARTIFACT_NAME,
        "bytes": os.path.getsize(path),
        **(manifest_extra or {}),
    }
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_serving_artifact(path: str) -> tuple[Callable, dict[str, Any]]:
    """Load an exported artifact directory -> (callable, manifest).

    Imports `jpeg_detection_resnet_ssd_torch.ops` (the decode's custom
    operator) first.  The callable takes the input tensors positionally (see
    `manifest['inputs']`), on the manifest's device, and raises naming both
    devices for tensors on another one.
    """
    importlib.import_module(OPS_MODULE)
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    program = torch.export.load(os.path.join(path, manifest["artifact"])).module()
    device = torch.device(manifest["device"])

    def fn(*inputs: torch.Tensor) -> torch.Tensor:
        for x in inputs:
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"the artifact takes tensors on {device}, got {type(x).__name__}")
            if x.device != device:
                raise ValueError(f"the artifact was exported for {device}; "
                                 f"it was called with a tensor on {x.device}")
        with torch.no_grad():
            return program(*inputs)

    return fn, manifest
