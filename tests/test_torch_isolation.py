"""The PyTorch port stands alone: no jax, no flax, nothing of the JAX
package, and entry points that default to CUDA and raise without it."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jpeg_detection_resnet_ssd_torch as port
from jpeg_detection_resnet_ssd_torch.models import build_model, make_inference_fn
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, Trainer, build_trainer, fit
from jpeg_detection_resnet_ssd_torch.utils import cuda_times_ms, resolve_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "jpeg_detection_resnet_ssd_tpu")


def port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT_DIR)], prefix=port.__name__ + ".")
    )


def test_every_module_imports_without_jax_or_flax():
    mods = [port.__name__, *port_modules()]
    assert len(mods) >= 15
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.startswith('jpeg_detection_resnet_ssd_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_names(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT_DIR.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_nothing_of_jax(path):
    bad = [
        name for name in _imported_names(REPO / path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("ssd300_ssd_custom", n_classes=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_inference_fn(n_classes=20, spec=AnchorSpec())
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cuda_times_ms(lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TargetEncoder(AnchorSpec(), ((1, 1),) * 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer(ExperimentConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(ExperimentConfig(), [])
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, None, torch.optim.SGD(model.parameters(), lr=0.1))


def test_unported_models_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model("ssd300_vgg", device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        build_model("no_such_model", device="cpu")


def test_cpu_path_builds_nothing(monkeypatch):
    """On the CPU the kernels' wrappers never reach nvcc or a library."""
    from jpeg_detection_resnet_ssd_torch.ops import _build, batched_nms, bipartite_match, conv_grad

    def fail(name):
        raise AssertionError(f"tried to load {name}")

    monkeypatch.setattr(_build, "load", fail)
    keep = batched_nms.batched_nms_mask(torch.zeros(1, 2, 4), torch.ones(1, 2))
    assert keep.shape == (1, 2)
    assert bipartite_match.bipartite_match(torch.ones(1, 2, 3)).shape == (1, 2)
    assert conv_grad.conv3x3_filter_grad(torch.ones(1, 2, 2, 3), torch.ones(1, 2, 2, 4)).shape == (3, 3, 3, 4)
    assert (batched_nms.LAUNCHES, bipartite_match.LAUNCHES, conv_grad.LAUNCHES) == (0, 0, 0)
