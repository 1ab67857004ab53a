"""Array-valued stand-ins for the gadget QM31Var, letting the prover reuse
the in-circuit AIR definitions (`recursion.composition.evaluate_plonk` /
`evaluate_poseidon`) verbatim for pointwise constraint evaluation over a
whole domain — prover and verifier share one constraint-emission order by
construction.
"""

from __future__ import annotations

import numpy as np

from ..core import qm31_host as q
from ..core.qm31_host import QM31


def _coerce(x):
    """uint32 coercion."""
    return np.asarray(x, np.uint32)


class EvalArray:
    """A QM31-valued column over the evaluation domain (SoA limbs).

    Limbs are numpy arrays (host prover).  Constants are stored as uint32 scalars
    and rely on broadcasting, so no full-domain constant columns are ever
    materialized in a traced program."""

    __slots__ = ("v",)

    def __init__(self, v: QM31):
        self.v = v

    @classmethod
    def from_limbs(cls, a, b=None, c=None, d=None) -> "EvalArray":
        a = _coerce(a)
        z = a * np.uint32(0)
        return cls(
            QM31(
                a,
                z if b is None else _coerce(b),
                z if c is None else _coerce(c),
                z if d is None else _coerce(d),
            )
        )

    @classmethod
    def const(cls, value4, n: int = 0) -> "EvalArray":
        """Broadcastable constant; `n` kept for API compat, unused."""
        del n
        return cls(QM31(*(np.uint32(int(v) % 2147483647) for v in value4)))

    def __add__(self, rhs: "EvalArray") -> "EvalArray":
        return EvalArray(q.q_add(self.v, rhs.v))

    def __sub__(self, rhs: "EvalArray") -> "EvalArray":
        return EvalArray(q.q_sub(self.v, rhs.v))

    def __neg__(self) -> "EvalArray":
        return EvalArray(q.q_neg(self.v))

    def __mul__(self, rhs: "EvalArray") -> "EvalArray":
        return EvalArray(q.q_mul(self.v, rhs.v))

    def mul_constant_m31(self, c: int) -> "EvalArray":
        return EvalArray(q.q_mul_m31(self.v, np.uint32(c % ((1 << 31) - 1))))

    def shift_by_i(self) -> "EvalArray":
        return EvalArray(q.q_shift_by_i(self.v))

    def shift_by_j(self) -> "EvalArray":
        return EvalArray(q.q_shift_by_j(self.v))

    def shift_by_ij(self) -> "EvalArray":
        return EvalArray(q.q_shift_by_ij(self.v))

    def inv(self) -> "EvalArray":
        return EvalArray(q.q_inv(self.v))


def _qm31_of(v4) -> QM31:
    """QM31 / 4-tuple of ints / (4,)-shaped numpy array -> QM31 scalars."""
    if isinstance(v4, QM31):
        return v4
    if isinstance(v4, (tuple, list)):
        return QM31(
            *(np.uint32(int(x)) for x in v4)
        )
    return QM31(v4[0], v4[1], v4[2], v4[3])


class LookupElementsArray:
    """z / alpha as broadcast EvalArrays with the gadget's combine()."""

    def __init__(self, z4, alpha4, n: int = 0):
        del n
        self.z = EvalArray(_qm31_of(z4))
        self.alpha = EvalArray(_qm31_of(alpha4))
        self.alpha_powers = [
            EvalArray(q.q_one(self.alpha.v.a)),
            self.alpha,
            self.alpha * self.alpha,
        ]

    def combine(self, values) -> EvalArray:
        denom = self.alpha_powers[0] * values[0]
        for ap, v in zip(self.alpha_powers[1:], values[1:]):
            denom = denom + (ap * v)
        return denom - self.z


class ArrayAccumulator:
    """Horner accumulation over random_coeff, pointwise."""

    def __init__(self, random_coeff4, n: int = 0):
        del n
        self.random_coeff = EvalArray(_qm31_of(random_coeff4))
        self.accumulation = EvalArray.const((0, 0, 0, 0))

    def accumulate(self, evaluation: EvalArray) -> None:
        self.accumulation = (self.accumulation * self.random_coeff) + evaluation


class ArrayEvalAtRow:
    """Mask cursor over array-valued columns; same protocol as the gadget
    EvalAtRowVar so evaluate_plonk/evaluate_poseidon run unchanged."""

    def __init__(self, mask, total_sum4, denom_inverse: EvalArray,
                 log_size: int, accumulator: ArrayAccumulator, n: int):
        from ..cs import scalar

        self.col_index = [0, 0, 0, 0]
        self.mask = mask  # [tree][col] -> [EvalArray per sample]
        self.denom_inverse = denom_inverse
        self.accumulator = accumulator
        # cumsum_shift = total_sum / 2^log_size; total_sum4 may be a tuple of
        # ints or a (4,) array
        self.cumsum_shift = EvalArray(
            q.q_mul_m31(
                _qm31_of(total_sum4),
                np.uint32(scalar.m_inv(1 << log_size)),
            )
        )
        self.n = n
        self.fracs = []

    def one(self) -> EvalArray:
        return EvalArray.const((1, 0, 0, 0), self.n)

    def zero(self) -> EvalArray:
        return EvalArray.const((0, 0, 0, 0), self.n)

    def next_interaction_mask(self, interaction: int, n: int):
        ci = self.col_index[interaction]
        self.col_index[interaction] += 1
        mask = self.mask[interaction][ci]
        assert len(mask) == n
        return list(mask)

    def get_preprocessed_column(self) -> EvalArray:
        return self.next_interaction_mask(0, 1)[0]

    def next_trace_mask(self) -> EvalArray:
        return self.next_interaction_mask(1, 1)[0]

    def next_extension_interaction_mask(self, interaction: int, n: int):
        from ..recursion.composition import combine_ef

        cols = [self.next_interaction_mask(interaction, n) for _ in range(4)]
        return [
            combine_ef([cols[0][k], cols[1][k], cols[2][k], cols[3][k]])
            for k in range(n)
        ]

    def add_to_relation(self, relation, multiplicity, values) -> None:
        denom = relation.combine(values)
        self.fracs.append((multiplicity, denom))

    def add_constraint(self, value: EvalArray) -> None:
        self.accumulator.accumulate(value * self.denom_inverse)

    def finalize_logup(self, batch_size: int) -> None:
        from ..recursion.composition import EvalAtRowVar

        EvalAtRowVar.finalize_logup(self, batch_size)
