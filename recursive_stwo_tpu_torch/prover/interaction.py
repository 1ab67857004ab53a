"""Interaction (logup) columns on the base trace domain.

Twin of device_prove.py:277-350 (`_InteractionEval`, `_interaction_traced`):
the port's verifier AIR evaluators run in generation mode over the row-order
trace columns, collect the relation fractions, and synthesise the 8
interaction limb rows plus the total sum (column layout of
air.InteractionBuilder.finalize_logup).  The inclusive prefix sum of the last
column, `associative_scan(m31.add, .)` in the JAX package (:329; also
air.py:241-249), is one int64 `cumsum` and one `% p`: 2**32 terms below 2**31
sum to less than 2**63.  Constraints are not needed here, so
`add_constraint*` discard them (the JAX package's `_DiscardList`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import m31
from ..core import qm31 as q
from ..core.qm31 import QM31
from ..cs import scalar
from ..verifier.quotients import m31_modsum
from .composition import _ProverEval


class _InteractionEval(_ProverEval):
    def __init__(self, pre, tr):
        self.pre = pre
        self.tr = tr
        self.inter = None
        self.perm = None
        self.cursor = [0, 0, 0]
        self.n = pre.shape[1]
        self.fracs = []
        self.columns = None
        self.total_sum = None

    def add_constraint(self, v):
        pass

    def add_constraint_block(self, v):
        pass

    def finalize_logup(self, batch_size: int) -> None:
        batched = []
        for k in range(0, len(self.fracs), batch_size):
            chunk = self.fracs[k : k + batch_size]
            p_, q_ = chunk[0]
            for mlt, d in chunk[1:]:
                p_ = q.q_add(q.q_mul(p_, d), q.q_mul(mlt, q_))
                q_ = q.q_mul(q_, d)
            batched.append((p_, q_))
        fracs = [q.q_mul(p_, q.q_inv(q_)) for p_, q_ in batched]

        cols = []
        acc = q.q_zero(fracs[0].a)
        for f in fracs[:-1]:
            acc = q.q_add(acc, f)
            cols.append(acc)
        S = q.q_add(acc, fracs[-1])
        self.total_sum = QM31(*(m31_modsum(limb, 0) for limb in S))
        shift = q.q_mul_m31(self.total_sum, scalar.m_inv(self.n))
        adj = q.q_sub(S, shift)
        cols.append(QM31(*(torch.cumsum(limb, 0) % m31.P for limb in adj)))
        self.columns = [limb for col in cols for limb in col]


def interaction_columns(pre: torch.Tensor, tr: torch.Tensor, lookup, evaluate_fn) -> Tuple[torch.Tensor, np.ndarray]:
    """(8, N) interaction limb rows (row order) and the (4,) uint32 total sum."""
    ev = _InteractionEval(pre, tr)
    evaluate_fn(ev, lookup)
    total = torch.stack(list(ev.total_sum)).cpu().numpy().astype(np.uint32)
    return torch.stack(ev.columns), total
