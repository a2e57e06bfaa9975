"""Nothing of the benchmark imports the JAX stack or the JAX package, and
the reference imports nothing of the program under test."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "hybrid_rendering_tpu"}
PROGRAM = "hybrid_rendering_torch"


def modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    """The top-level name (before the first dot) of every module that
    `path` imports, at any depth of its code."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_imports_no_jax(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{os.path.relpath(path, BENCH)} imports {sorted(found)}"


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    bad = {}
    for path in modules():
        if path.startswith(ref + os.sep):
            with open(path) as f:
                src = f.read()
            if PROGRAM in top_level_imports(path) or PROGRAM in src:
                bad[os.path.relpath(path, BENCH)] = True
    assert not bad, f"the reference names the program: {sorted(bad)}"


def test_the_check_sees_whole_top_level_names():
    # the port's name begins with the JAX package's stem; whole names differ
    assert PROGRAM.split(".", 1)[0] not in FORBIDDEN
    assert "hybrid_rendering_tpu.ops".split(".", 1)[0] in FORBIDDEN
