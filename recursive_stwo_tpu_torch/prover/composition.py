"""The composition polynomial over the 2**bound evaluation domain.

Twin of device_prove.py:202-274 (`_ProverEval`, `_t_last`, `_qm31_scalar`)
and of the composition stage `_stage_composition_jit` (:417-474).
`_ProverEval` is the port's verifier `_Eval` with the evaluation domain as
its batch axis: masks come from LDE columns, an interaction column is its
four limb rows, and the previous-row mask is a gather by `perm`.

The JAX stage concatenates all 86 constraint columns before the Horner fold;
at 2**21 points that list alone is about 5.8 GB of int64.  Here constraints
go to the verifier's `HornerSink`, whose `append` folds each column in
emission order: the same sum, with one (N,) QM31 accumulator live.  That
eager evaluation is the plain version (`composition_evals_plain`); on CUDA
each table is one launch of the domain kernel (csrc/composition.cu), which
folds the same constraints in the same order into a (4, N) accumulator.
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


def each_table(spec: VerifierSpec, tables, evaluate_table) -> None:
    """Call evaluate_table(i, evaluate_fn, pre, tr, inter, perm, total,
    denom_inv, log) for each table, with its LDE blocks over the 2**bound
    domain (made here, so they are freed as each call returns), the
    previous-row permutation and the M31 1/vanishing of every point."""
    bound = spec.composition_log_degree_bound
    device = tables[0][0][0].device
    x_dom, _ = circle_fft.domain_points(bound, device)
    for i, ((c_pre, c_tr, c_int), total, log, evaluate_fn) in enumerate(tables):
        perm = to_device(point_sub_step_perm(bound, ccircle.Coset.odds(log).step_index), device)
        evaluate_table(
            i, evaluate_fn, circle_fft.lde(c_pre, bound), circle_fft.lde(c_tr, bound),
            circle_fft.lde(c_int, bound), perm, total, _vanishing_inv(x_dom, log), log,
        )


def composition_evals_plain(spec: VerifierSpec, tables, lookup: Tuple[QM31, QM31], random_coeff: QM31):
    """The plain version of `composition_evals`: each table's evaluator on a
    `_ProverEval`, its constraints folded by a `HornerSink`."""
    sink = vcomp.HornerSink(random_coeff, 1 << spec.composition_log_degree_bound)

    def evaluate(i, evaluate_fn, pre, tr, inter, perm, total, denom_inv, log):
        evaluate_fn(_ProverEval(pre, tr, inter, perm, total, denom_inv, log, sink), lookup)

    each_table(spec, tables, evaluate)
    return torch.stack(list(sink.acc))


def composition_evals(spec: VerifierSpec, tables, lookup: Tuple[QM31, QM31], random_coeff: QM31):
    """The (4, 2**bound) composition evaluations, Horner-folded over every
    table's constraints in emission order.  On the CPU the plain version;
    on CUDA one launch of the domain kernel a table (ops/composition_cuda.py),
    each folding its AIR into the same accumulator."""
    device = tables[0][0][0].device
    if device.type == "cpu":
        return composition_evals_plain(spec, tables, lookup, random_coeff)
    from ..ops import composition_cuda

    acc = torch.empty((4, 1 << spec.composition_log_degree_bound), dtype=torch.int64, device=device)

    def evaluate(i, evaluate_fn, pre, tr, inter, perm, total, denom_inv, log):
        composition_cuda.domain(
            evaluate_fn, pre, tr, inter, perm, denom_inv, acc, i == 0, total, lookup, random_coeff, log
        )

    each_table(spec, tables, evaluate)
    return acc


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
    comp_coeffs = circle_fft.interpolate(composition_evals(spec, tables, lookup, random_coeff))  # (4, 2**bound)
    half = 1 << (spec.composition_log_degree_bound - 1)
    return torch.cat([comp_coeffs[:, :half], comp_coeffs[:, half:]])
