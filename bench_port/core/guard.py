"""The check that nothing of JAX or of the JAX package is loaded: module
names compared by their whole top-level name (the part before the first
dot), so `paella_tpu_torch` is not `paella_tpu`."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "paella_tpu"})


def loaded_forbidden(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names if m.split(".")[0] in FORBIDDEN})
