"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Names are compared whole, by
their top-level part: the program's package name begins with the JAX
package's."""

import ast

from port_bench import core

FORBIDDEN = {"jax", "jaxlib", "flax", "jpeg_detection_resnet_ssd_tpu"}
PROGRAM = "jpeg_detection_resnet_ssd_torch"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax():
    for path in core.BENCH_DIR.rglob("*.py"):
        assert not FORBIDDEN & set(_top_level_imports(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (core.BENCH_DIR / "reference").rglob("*.py"):
        names = set(_top_level_imports(path))
        assert PROGRAM not in names and not FORBIDDEN & names, path
        assert names <= {"__future__", "dataclasses", "math", "torch", "port_bench"}, (path, names)


def test_loaded_modules_are_compared_by_whole_top_level_name():
    assert core.forbidden_loaded([f"{PROGRAM}.ops", "torch", "jaxtyping"]) == []
    assert core.forbidden_loaded(["jax.numpy", "flax.linen", "jaxlib"]) == ["flax", "jax", "jaxlib"]
    assert core.forbidden_loaded(["jpeg_detection_resnet_ssd_tpu.models"]) == [
        "jpeg_detection_resnet_ssd_tpu"]


def test_a_run_without_a_card_prints_no_result(capsys):
    assert core.main(["--workload", "ssd300_ssd_custom.serve_b256", "--seed", "1",
                      "--seconds", "1", "--trace", "0"], 0.0) != 0
    assert capsys.readouterr().out.strip() == ""
