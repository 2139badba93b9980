"""Import guard: no module the harness can load imports JAX or the JAX
package, and the plain reference imports nothing of the port."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "model_matching_tpu"}


def _modules():
    for dirpath, _dirs, files in os.walk(BENCH):
        if os.path.relpath(dirpath, BENCH).split(os.sep)[0] == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(_modules())


def test_the_harness_has_modules():
    names = {os.path.relpath(m, BENCH) for m in MODULES}
    assert {"run.py", "loops.py", "check.py", "reference/scene.py"} <= names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    bad = set(_top_level_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", [m for m in MODULES if os.sep + "reference" + os.sep in m],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_port(path):
    names = set(_top_level_imports(path))
    assert "model_matching_tpu_torch" not in names and not names & FORBIDDEN, names


def test_names_compared_whole():
    # the port's name begins with the JAX package's; a prefix test would
    # confuse them
    assert "model_matching_tpu_torch".split(".")[0] not in FORBIDDEN
