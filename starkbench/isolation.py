"""What a run may not load, and what the reference may not import.

The measured package's name begins with the JAX package's, so names are
compared by their top-level part (before the first dot), whole.
"""

from __future__ import annotations

import ast
import pathlib
import sys

#: top-level modules no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "zk_stark_tpu")
#: top-level modules the plain reference may not import
REFERENCE_FORBIDDEN = FORBIDDEN + ("zk_stark_tpu_torch", "torch")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules (of ``sys.modules`` unless given) whose top-level
    name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def imports_of(path: pathlib.Path) -> set[str]:
    """Top-level names a Python source imports (relative imports excluded)."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top_level(node.module))
    return out


def reference_violations(folder: pathlib.Path | None = None) -> dict[str, list[str]]:
    """Each file of the reference that imports a forbidden name, with them."""
    folder = folder or pathlib.Path(__file__).resolve().parent / "reference"
    out = {}
    for path in sorted(folder.rglob("*.py")):
        bad = sorted(imports_of(path) & set(REFERENCE_FORBIDDEN))
        if bad:
            out[str(path.relative_to(folder))] = bad
    return out
