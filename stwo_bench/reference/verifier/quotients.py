"""Modular sums of stacked QM31 tensors, in plain torch, for the AIR's
evaluation at the OODS point (composition.py)."""

from __future__ import annotations

import torch

from ..core import m31
from ..core.qm31 import QM31


def m31_modsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Modular sum along a dimension (exact: the int64 sum of fewer than
    2**32 residues cannot overflow)."""
    return x.sum(dim=dim) % m31.P


def q_modsum(x: QM31, dim: int) -> QM31:
    return QM31(*(m31_modsum(comp, dim) for comp in x))
