"""Batched circle-group point ops over M31 on int64 tensors.

Twin of the array half of recursive_stwo_tpu/core/circle.py (a point is a
pair (x, y) of same-shape tensors).  The integer host helpers (point_at_index,
Coset, ...) are in the host copy, circle_host.py.
"""

from __future__ import annotations

import torch

from . import m31
from .circle_host import M31_CIRCLE_LOG_ORDER, _gen_power_of_two


def apoint_add(p, q):
    x1, y1 = p
    x2, y2 = q
    return (
        m31.sub(m31.mul(x1, x2), m31.mul(y1, y2)),
        m31.add(m31.mul(x1, y2), m31.mul(y1, x2)),
    )


def apoint_add_const(p, c):
    """Add a constant point c = (int, int) to a batched point."""
    x1, y1 = p
    cx, cy = int(c[0]), int(c[1])
    return (
        m31.sub(m31.mul(x1, cx), m31.mul(y1, cy)),
        m31.add(m31.mul(x1, cy), m31.mul(y1, cx)),
    )


def apoint_double_x(x):
    """pi(x) = 2x**2 - 1, the x-projection of point doubling."""
    sq = m31.mul(x, x)
    return m31.sub(m31.add(sq, sq), 1)


def apoints_at_indices(indices: torch.Tensor):
    """M31_CIRCLE_GEN * index for every entry of an int64 index tensor."""
    idx = indices % (1 << M31_CIRCLE_LOG_ORDER)
    x = torch.ones_like(idx)
    y = torch.zeros_like(idx)
    for k in range(M31_CIRCLE_LOG_ORDER):
        bit = ((idx >> k) & 1) != 0
        nx, ny = apoint_add_const((x, y), _gen_power_of_two(k))
        x = torch.where(bit, nx, x)
        y = torch.where(bit, ny, y)
    return x, y
