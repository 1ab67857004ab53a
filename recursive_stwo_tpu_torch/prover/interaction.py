"""Interaction (logup) columns on the base trace domain.

Twin of device_prove.py:277-350 (`_InteractionEval`, `_interaction_traced`):
the port's verifier AIR evaluators run in generation mode over the row-order
trace columns, collect the relation fractions, and synthesise the 8
interaction limb rows plus the total sum (column layout of
air.InteractionBuilder.finalize_logup).  Constraints are not needed here, so
`add_constraint*` discard them (the JAX package's `_DiscardList`).

Two steps.  The batch rows: each logup batch's fraction p / q becomes
p q^-1, and rows 0 .. 4k - 5 are the running sums of the batches before the
last, the last four S, the sum of all of them; on CUDA one launch of the
interaction kernel a table (ops/interaction_cuda.py, csrc/interaction.cu),
on the CPU the plain version, `_InteractionEval` (`interaction_rows_plain`).
Then `_close`, on either device: the total sum of S over the rows, the
shift total / N, and the last column, the inclusive prefix sum of S - shift
(`associative_scan(m31.add, .)` in the JAX package, :329; also
air.py:241-249), which is one int64 `cumsum` and one `% p`: 2**32 terms
below 2**31 sum to less than 2**63.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import m31
from ..core import qm31 as q
from ..cs import scalar
from ..ops import interaction_cuda
from ..ops.composition_cuda import air_id
from ..utils.spans import span
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
        self.rows = None

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
        acc = q.q_zero(batched[0][0].a)
        cols = []
        for p_, q_ in batched:
            acc = q.q_add(acc, q.q_mul(p_, q.q_inv(q_)))
            cols.append(acc)
        self.rows = torch.stack([limb for col in cols for limb in col])


def interaction_rows_plain(pre: torch.Tensor, tr: torch.Tensor, lookup, evaluate_fn) -> torch.Tensor:
    """The (4k, N) batch rows of one table by the eager evaluators: the
    running sums of the batches, the last four S."""
    ev = _InteractionEval(pre, tr)
    evaluate_fn(ev, lookup)
    return ev.rows


def _close(rows: torch.Tensor) -> np.ndarray:
    """Replace the last four rows, S, by the last interaction column in
    place, and return the (4,) uint32 total sum: the total of S over the N
    rows, shift = total / N, then the inclusive prefix sum of S - shift."""
    n = rows.shape[1]
    S = rows[-4:]
    with span("to_host"):
        total = tuple(int(v) for v in (S.sum(dim=1) % m31.P).tolist())
    shift = scalar.q_mul_m31(total, scalar.m_inv(n))
    S.sub_(torch.tensor(shift, dtype=torch.int64, device=rows.device)[:, None]).remainder_(m31.P)
    S.copy_(torch.cumsum(S, dim=1).remainder_(m31.P))
    return np.array(total, np.uint32)


def interaction_columns(pre: torch.Tensor, tr: torch.Tensor, lookup, evaluate_fn) -> Tuple[torch.Tensor, np.ndarray]:
    """(8, N) interaction limb rows (row order) and the (4,) uint32 total
    sum: on CUDA the interaction kernel (evaluate_fn names its AIR), on the
    CPU the plain version."""
    if pre.device.type == "cpu":
        rows = interaction_rows_plain(pre, tr, lookup, evaluate_fn)
    else:
        rows = interaction_cuda.interaction_rows(air_id(evaluate_fn), pre, tr, lookup)
    total = _close(rows)
    return rows, total
