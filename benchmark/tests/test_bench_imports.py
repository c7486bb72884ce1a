"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program.  Names are compared by their
top-level part, the part before the first dot, whole."""

import ast
import os

import pytest

from harness import guard, spec

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(spec.BENCH_DIR) for f in fs
               if f.endswith(".py") and ".cache" not in d)


def imported_top_levels(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_no_jax(path):
    assert not imported_top_levels(path) & guard.FORBIDDEN


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "reference" + os.sep in f],
                         ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_reference_imports_no_program(path):
    assert "cudaparticlesfoam_tpu_torch" not in imported_top_levels(path)
    assert not imported_top_levels(path) & {"harness", "drivers", "builders", "metrics"}


def test_guard_compares_top_level_names_whole():
    assert guard.forbidden_loaded(["cudaparticlesfoam_tpu_torch", "cudaparticlesfoam_tpu_torch.ops",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["cudaparticlesfoam_tpu.mesh", "jax.numpy", "flax"]) == [
        "cudaparticlesfoam_tpu", "flax", "jax"]
