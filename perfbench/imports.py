"""What a run may not load: JAX, its libraries and the JAX package the port
was made from, compared by whole top-level module names (the port's own
name begins with the JAX package's, so a prefix test would be wrong); and
the reference may not import the program either."""
from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mapdn_tpu"})
REFERENCE_FORBIDDEN = FORBIDDEN | {"mapdn_torch"}
REFERENCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference")


def loaded_forbidden(modules=None):
    """Sorted top-level names of loaded modules that are forbidden."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)


def reference_imports(directory=REFERENCE_DIR):
    """{file: [forbidden top-level names it imports]} over the reference's
    sources."""
    found = {}
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(directory, fname)) as fh:
            tree = ast.parse(fh.read(), fname)
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names.add(node.module.split(".")[0])
        bad = sorted(names & REFERENCE_FORBIDDEN)
        if bad:
            found[fname] = bad
    return found
