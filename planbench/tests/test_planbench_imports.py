"""Nothing of the benchmark imports the JAX stack, the JAX package or the
old benchmarks, compared by whole top-level name (``repro_torch``, the
program, begins with ``repro``, the JAX package, and is allowed)."""
import ast
import sys

import pytest

from _planbench_util import PLANBENCH
from pbench import cli

FILES = sorted(PLANBENCH.rglob("*.py"))


def _top_names(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(PLANBENCH)))
def test_no_forbidden_import(path):
    bad = set(_top_names(path)) & set(cli.FORBIDDEN)
    assert not bad, f"{path} imports {bad}"
    if path.parent.name == "tests":
        return
    # no string the code uses (docstrings aside) names the old benchmarks
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs \
                and node.value not in cli.FORBIDDEN:
            assert "benchmarks" not in node.value.replace("planbench", ""), \
                (path, node.value)


def test_only_the_adapter_and_the_tests_touch_the_program():
    """The yardstick (generator, reference, judge, arithmetic) imports
    nothing of the program: only ``pbench/program.py`` and the tests do."""
    for path in FILES:
        rel = path.relative_to(PLANBENCH)
        if rel.parts[0] == "tests" or rel == PLANBENCH.joinpath(
                "pbench", "program.py").relative_to(PLANBENCH):
            continue
        assert "repro_torch" not in set(_top_names(path)), rel


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "jaxtyping",
                 "reproduce", "benchmarks_extra"):
        monkeypatch.setitem(sys.modules, name, object())
    assert cli.forbidden_modules() == [
        m for m in cli.forbidden_modules() if m in sys.modules]
    assert not set(cli.forbidden_modules()) & {
        "repro_torch", "jaxtyping", "reproduce", "benchmarks_extra"}
    for name in ("repro.core", "jax.numpy", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert {"repro", "jax", "flax"} <= set(cli.forbidden_modules())
