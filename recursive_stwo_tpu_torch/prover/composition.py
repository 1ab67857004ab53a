"""The composition polynomial over the 2**bound evaluation domain.

Twin of device_prove.py:202-274 (`_ProverEval`, `_t_last`, `_qm31_scalar`)
and of the composition stage `_stage_composition_jit` (:417-474).
`_ProverEval` is the port's verifier `_Eval` with the evaluation domain as
its batch axis: masks come from LDE columns, an interaction column is its
four limb rows, and the previous-row mask is a gather by `perm`.

The JAX stage concatenates all 86 constraint columns before the Horner fold;
at 2**21 points that list alone is about 5.8 GB of int64.  Here constraints
go to the verifier's `HornerSink`, whose `append` folds each column in
emission order: the same sum, with one (N,) QM31 accumulator live.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..core import circle_host as ccircle
from ..core import m31
from ..core import qm31 as q
from ..core.qm31 import QM31
from ..cs import scalar
from ..verifier import composition as vcomp
from ..verifier.spec import VerifierSpec
from . import circle_fft
from .arrays import to_device


def q_of_m31(limb: torch.Tensor) -> QM31:
    z = torch.zeros_like(limb)
    return QM31(limb, z, z, z)


def qm31_scalar(v4) -> QM31:
    """(4,) limbs -> QM31 of python ints (broadcasts against any tensor)."""
    return QM31(*(int(x) for x in v4))


def _t_last(block: torch.Tensor) -> torch.Tensor:
    """(n, N) -> (N, n)."""
    return block.movedim(0, -1)


class _ProverEval(vcomp._Eval):
    """pre/tr: (n_cols, N) M31 rows; inter: (4k, N) interaction limb rows;
    perm: (N,) index of the previous-row point; denom_inv: (N,) M31."""

    def __init__(self, pre, tr, inter, perm, total_sum: QM31, denom_inv, log_size: int, constraints):
        self.pre = pre
        self.tr = tr
        self.inter = inter
        self.perm = perm
        self.cursor = [0, 0, 0]
        self.denom_inverse = q_of_m31(denom_inv)
        self.constraints = constraints
        self.fracs = []
        self.cumsum_shift = q.q_mul_m31(total_sum, scalar.m_inv(1 << log_size))

    # -- mask access over committed columns ---------------------------------

    def preprocessed(self) -> QM31:
        col = self.pre[self.cursor[0]]
        self.cursor[0] += 1
        return q_of_m31(col)

    def trace(self) -> QM31:
        col = self.tr[self.cursor[1]]
        self.cursor[1] += 1
        return q_of_m31(col)

    def preprocessed_block(self, n: int) -> QM31:
        c = self.cursor[0]
        self.cursor[0] += n
        return q_of_m31(_t_last(self.pre[c : c + n]))

    def trace_block(self, n: int) -> QM31:
        c = self.cursor[1]
        self.cursor[1] += n
        return q_of_m31(_t_last(self.tr[c : c + n]))

    def next_extension_mask(self, n: int):
        c = self.cursor[2]
        self.cursor[2] += 4
        limbs = self.inter[c : c + 4]
        cur = QM31(*limbs)
        if n == 1:
            return [cur]
        if n != 2:
            raise ValueError(f"mask of {n} rows")
        return [QM31(*(limb[self.perm] for limb in limbs)), cur]

    # -- constraints: the denominator is an M31, so scale limb-wise ----------

    def add_constraint(self, v: QM31):
        d = self.denom_inverse.a
        self.constraints.append(QM31(*(c[:, None] for c in q.q_mul_m31(v, d))))

    def add_constraint_block(self, v: QM31):
        self.constraints.append(q.q_mul_m31(v, self.denom_inverse.a[:, None]))


@lru_cache(maxsize=None)
def point_sub_step_perm(dom_log: int, step_index: int) -> np.ndarray:
    """perm with point(perm[j]) = point(j) - step in bit-reversed domain
    order: the vectorised twin of prove._point_sub_step_perm."""
    n = 1 << dom_log
    order = 1 << ccircle.M31_CIRCLE_LOG_ORDER
    half = ccircle.CanonicCoset(dom_log).circle_domain().half_coset
    br = ccircle.bit_reverse_indices(dom_log)
    k = np.where(br < n // 2, br, br - n // 2)
    idx = (half.initial_index + k * half.step_index) % order
    idx = np.where(br < n // 2, idx, (order - idx) % order)
    by_index = np.argsort(idx)
    target = (idx - step_index) % order
    pos = np.searchsorted(idx[by_index], target)
    perm = by_index[np.minimum(pos, n - 1)]
    if not np.array_equal(idx[perm], target):
        raise ValueError("the shifted point is not in the domain")
    return perm


def _vanishing_inv(x: torch.Tensor, log_size: int) -> torch.Tensor:
    """1 / pi^(log_size-1)(x): the canonic coset's vanishing polynomial."""
    v = x
    for _ in range(log_size - 1):
        sq = m31.mul(v, v)
        v = m31.sub(m31.add(sq, sq), 1)
    return m31.inv(v)


def composition_stage(
    spec: VerifierSpec,
    tables,
    lookup: Tuple[QM31, QM31],
    random_coeff: QM31,
):
    """tables: ((pre, tr, inter) coefficient blocks, total_sum, log, evaluate_fn)
    per AIR, in emission order (plonk then poseidon; the one without-Poseidon
    table).  Returns the (8, 2**(bound-1)) split coefficient block (left
    limbs then right limbs); the resident provers commit its LDE, the
    streamed ones evaluate it chunk by chunk."""
    bound = spec.composition_log_degree_bound
    device = tables[0][0][0].device
    x_dom, _ = circle_fft.domain_points(bound, device)
    sink = vcomp.HornerSink(random_coeff, 1 << bound)
    for (c_pre, c_tr, c_int), total, log, evaluate_fn in tables:
        perm = to_device(point_sub_step_perm(bound, ccircle.Coset.odds(log).step_index), device)
        ev = _ProverEval(
            circle_fft.lde(c_pre, bound), circle_fft.lde(c_tr, bound), circle_fft.lde(c_int, bound),
            perm, total, _vanishing_inv(x_dom, log), log, sink,
        )
        evaluate_fn(ev, lookup)
        del ev
    comp_coeffs = circle_fft.interpolate(torch.stack(list(sink.acc)))  # (4, 2**bound)
    half = 1 << (bound - 1)
    return torch.cat([comp_coeffs[:, :half], comp_coeffs[:, half:]])

