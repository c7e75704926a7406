"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: seqlib_tpu_torch is not seqlib_tpu), and the
reference imports nothing of the port."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "seqlib_tpu"}
MODULES = sorted(os.path.relpath(os.path.join(d, f), HERE)
                 for d, _, fs in os.walk(HERE) for f in fs
                 if f.endswith(".py"))


def top_levels(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("rel", MODULES)
def test_no_jax(rel):
    assert not top_levels(os.path.join(HERE, rel)) & FORBIDDEN


@pytest.mark.parametrize("rel", [m for m in MODULES
                                 if m.startswith("reference" + os.sep)])
def test_reference_imports_nothing_of_the_port(rel):
    assert "seqlib_tpu_torch" not in top_levels(os.path.join(HERE, rel))


def test_check_is_whole_name():
    assert "seqlib_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "seqlib_tpu.ops".split(".")[0] in FORBIDDEN


def test_seen_by_walk():
    assert any(m.startswith("reference") for m in MODULES)
    assert "harness.py" in MODULES
