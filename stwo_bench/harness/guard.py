"""The modules a run may not load: JAX and the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "recursive_stwo_tpu")


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.partition(".")[0] for m in names} & set(FORBIDDEN))
