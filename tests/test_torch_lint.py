"""``tests/test_lint.py``'s gate over the port: every type annotation in
``mcncrossmodalemotions_torch/**/*.py`` (its integration entry
``graft_entry.py`` among them) and ``chip_smoke.py`` resolves to a name
the module binds, and every source compiles. The helpers are
``test_lint.py``'s own, imported from it."""

from __future__ import annotations

import ast
import pathlib

from test_lint import _annotation_exprs, _bound_names

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCES = (sorted((REPO / "mcncrossmodalemotions_torch").rglob("*.py"))
           + [REPO / "chip_smoke.py"])


def test_all_annotations_resolve():
    assert REPO / "mcncrossmodalemotions_torch" / "graft_entry.py" in SOURCES
    problems = []
    for path in SOURCES:
        tree = ast.parse(path.read_text(), filename=str(path))
        bound = _bound_names(tree)
        for lineno, expr in _annotation_exprs(tree):
            for n in ast.walk(expr):
                if isinstance(n, ast.Name) and n.id not in bound:
                    problems.append(
                        f"{path.relative_to(REPO)}:{lineno}: annotation "
                        f"uses unbound name {n.id!r}")
    assert not problems, "\n".join(problems)


def test_sources_compile():
    for path in SOURCES:
        compile(path.read_text(), str(path), "exec")
