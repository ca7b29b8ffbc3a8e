"""Nothing under perfbench/ imports JAX, Flax, Optax or the JAX package,
comparing each module's top-level name whole (the port's name begins with
the JAX package's); the reference imports nothing of the program."""

import ast

import pytest

from perfbench.harness.spec import BENCH

BANNED = {"jax", "jaxlib", "flax", "optax", "mcncrossmodalemotions_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_imports(path):
    assert not set(_imports(path)) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "mcncrossmodalemotions_torch" not in set(_imports(path))
    assert not {m for m in _imports(path) if m == "perfbench"} - {"perfbench"}


def test_reference_uses_only_the_benchmarks_own_modules():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("perfbench"):
                assert node.module.split(".")[1] in ("reference", "traffic"), path
