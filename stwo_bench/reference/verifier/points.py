"""The canonic coset's vanishing polynomial at the OODS point, in plain
torch, for the AIR's evaluation there (composition.py)."""

from __future__ import annotations

from ..core import qm31 as q
from ..core.qm31 import QM31


def repeated_double_x(x: QM31, n: int) -> QM31:
    for _ in range(n):
        sq = q.q_mul(x, x)
        x = q.q_sub(q.q_add(sq, sq), q.q_one(x.a))
    return x


def coset_vanishing_canonic(oods_x: QM31, log_size: int) -> QM31:
    """Vanishing polynomial of CanonicCoset(log_size) at a point with
    x-coordinate oods_x: pi applied (log_size - 1) times."""
    return repeated_double_x(oods_x, log_size - 1)
