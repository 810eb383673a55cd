"""What the benchmark may not load: JAX, its libraries and the JAX package.
Names are compared by their top-level part (before the first dot) as a
whole, because the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "followyourclick_tpu"})
PORT = "followyourclick_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """The forbidden modules in ``sys.modules`` (or ``modules``)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)


def imports_of(path: Path) -> list:
    """Every module a Python file imports, absolute names."""
    tree = ast.parse(path.read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.append(str(node.args[0].value))
    return out


def static_violations(folder: Path) -> list:
    """``(file, module)`` for every import of a forbidden module under
    ``folder``, and for every import of the port under its ``reference``
    folder."""
    bad = []
    for path in sorted(folder.rglob("*.py")):
        in_reference = "reference" in path.relative_to(folder).parts
        for name in imports_of(path):
            if top(name) in FORBIDDEN or (in_reference and top(name) == PORT):
                bad.append((str(path.relative_to(folder)), name))
    return bad
