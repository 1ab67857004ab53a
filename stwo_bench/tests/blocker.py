"""An import hook that refuses JAX and the JAX package, by the whole
top-level name of the module."""

from __future__ import annotations

import sys

BLOCKED = ("jax", "jaxlib", "flax", "recursive_stwo_tpu")


class _Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in BLOCKED:
            raise ImportError(f"{name} is refused in this process")
        return None


def install() -> None:
    sys.meta_path.insert(0, _Refuse())
