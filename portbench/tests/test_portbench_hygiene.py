"""What the benchmark imports: never JAX, Flax, Orbax or the JAX package
(compared on the whole top-level name, so the port's package, whose name
begins with the JAX package's, never matches); the reference, nothing of
the program either."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import registry
from portbench.harness import FORBIDDEN

PORT = "wavedm_tpu_torch"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(registry.ROOT, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, registry.ROOT))
def test_no_module_imports_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, registry.ROOT))
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert PORT not in tops
    assert tops <= {"__future__", "math", "typing", "numpy", "torch",
                    "portbench"}
    assert all(name.startswith("portbench.reference")
               for name in _imports(path) if name.startswith("portbench"))


def test_the_whole_top_level_name_is_compared():
    assert "wavedm_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "wavedm_tpu.ops".split(".")[0] in FORBIDDEN


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness, registry\n"
            "registry.runner('restore'); registry.runner('train')\n"
            "import portbench.calibrate\n"
            "print(harness.forbidden_modules())" % registry.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
