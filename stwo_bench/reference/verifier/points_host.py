"""The OODS point moved by a row shift, on the host (numpy), for the FRI
answers of the columns sampled at the previous row (quotients_host.py).
OODS and mask math mirror recursive-stwo hints/fiat_shamir.rs:138-155 and
recursive/answer/src/lib.rs:62-101.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core import circle_host as circle
from ..core import qm31_host as q
from ..core.qm31_host import QM31


def add_constant_point(p: Tuple[QM31, QM31], c: Tuple[int, int]) -> Tuple[QM31, QM31]:
    """(x, y) + constant M31 point, QM31 coordinates."""
    x, y = p
    cx, cy = np.uint32(c[0]), np.uint32(c[1])
    nx = q.q_sub(q.q_mul_m31(x, cx), q.q_mul_m31(y, cy))
    ny = q.q_add(q.q_mul_m31(x, cy), q.q_mul_m31(y, cx))
    return nx, ny


def shifted_oods_point(
    oods: Tuple[QM31, QM31], shift: int, trace_log_size: int
) -> Tuple[QM31, QM31]:
    """oods + shift * CanonicCoset(trace_log_size).step()  (shift in {-1,0,..})."""
    if shift == 0:
        return oods
    step_index = circle.subgroup_gen_index(trace_log_size)
    cpt = circle.point_at_index((shift * step_index) % (1 << 31))
    return add_constant_point(oods, cpt)
