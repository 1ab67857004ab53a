"""In-circuit composition-polynomial check: evaluate both AIRs at the OODS
point and match against the sampled composition columns.

Reference: /root/reference/components/recursive/composition/src/
{lib,data_structures,plonk,poseidon}.rs.  The constraint emission order is
significant — it fixes the Horner accumulation over random_coeff.
"""

from __future__ import annotations

from typing import List

from ..core.poseidon2 import (
    FIRST_FOUR_ROUND_RC,
    LAST_FOUR_ROUNDS_RC,
    PARTIAL_ROUNDS_RC,
)
from ..cs.scalar import m_inv
from ..gadgets.circle import CirclePointQM31
from ..gadgets.fields import M31Var, QM31Var
from ..verifier.spec import (
    N_PREPROCESSED_PLONK,
    N_TRACE_PLONK,
    N_INTERACTION_PLONK,
    VerifierSpec,
)
from .data_structures import LookupElementsVar, ProofVar

N_STATE = 16


def coset_vanishing(p: CirclePointQM31, coset_log_size: int) -> QM31Var:
    """Vanishing polynomial of CanonicCoset(log_size) at p
    (composition lib.rs:18-29)."""
    from ..core import circle_host as ccircle

    cs = p.cs
    coset = ccircle.Coset.odds(coset_log_size)
    # shift = -initial + step/2
    shift_index = (-coset.initial_index + (coset.step_index // 2)) % (1 << 31)
    shift = ccircle.point_at_index(shift_index)
    x = p.add_constant_point(shift).x
    one = M31Var.one(cs)
    for _ in range(1, coset_log_size):
        sq = x * x
        x = (sq + sq) - one
    return x


class PointEvaluationAccumulatorVar:
    def __init__(self, random_coeff: QM31Var):
        self.random_coeff = random_coeff
        self.accumulation = QM31Var.zero(random_coeff.cs)

    def accumulate(self, evaluation: QM31Var) -> None:
        self.accumulation = (self.accumulation * self.random_coeff) + evaluation

    def finalize(self) -> QM31Var:
        return self.accumulation


class EvalAtRowVar:
    """Mask cursor + logup state (composition data_structures.rs:84-215)."""

    def __init__(self, mask, total_sum: QM31Var, denom_inverse: QM31Var,
                 log_size: int, accumulator: PointEvaluationAccumulatorVar):
        self.col_index = [0, 0, 0, 0]
        self.mask = mask  # [tree][col] -> list[QM31Var]
        self.denom_inverse = denom_inverse
        self.accumulator = accumulator
        self.cumsum_shift = total_sum.mul_constant_m31(m_inv(1 << log_size))
        self.fracs: List[tuple] = []

    def next_interaction_mask(self, interaction: int, n: int):
        ci = self.col_index[interaction]
        self.col_index[interaction] += 1
        mask = self.mask[interaction][ci]
        assert len(mask) == n
        return list(mask)

    def one(self) -> QM31Var:
        return QM31Var.one(self.cumsum_shift.cs)

    def zero(self) -> QM31Var:
        return QM31Var.zero(self.cumsum_shift.cs)

    def get_preprocessed_column(self) -> QM31Var:
        return self.next_interaction_mask(0, 1)[0]

    def next_trace_mask(self) -> QM31Var:
        return self.next_interaction_mask(1, 1)[0]

    def next_extension_interaction_mask(self, interaction: int, n: int):
        cols = [self.next_interaction_mask(interaction, n) for _ in range(4)]
        return [
            combine_ef([cols[0][k], cols[1][k], cols[2][k], cols[3][k]])
            for k in range(n)
        ]

    def add_to_relation(self, relation: LookupElementsVar,
                        multiplicity: QM31Var, values) -> None:
        denom = relation.combine(values)
        self.fracs.append((multiplicity, denom))

    def add_constraint(self, value: QM31Var) -> None:
        self.accumulator.accumulate(value * self.denom_inverse)

    def finalize_logup(self, batch_size: int) -> None:
        num_batches = -(-len(self.fracs) // batch_size)
        batched = []
        for k in range(0, len(self.fracs), batch_size):
            chunk = self.fracs[k : k + batch_size]
            p_, q_ = chunk[0]
            for m, d in chunk[1:]:
                p_ = (p_ * d) + (m * q_)
                q_ = q_ * d
            batched.append((p_, q_))

        prev_col_cumsum = self.zero()
        for num, denom in batched[: num_batches - 1]:
            cur_cumsum = self.next_extension_interaction_mask(2, 1)[0]
            diff = cur_cumsum - prev_col_cumsum
            prev_col_cumsum = cur_cumsum
            self.add_constraint((diff * denom) - num)

        for num, denom in batched[num_batches - 1 :]:
            prev_row_cumsum, cur_cumsum = self.next_extension_interaction_mask(
                2, 2
            )
            diff = (cur_cumsum - prev_row_cumsum) - prev_col_cumsum
            fixed_diff = diff + self.cumsum_shift
            self.add_constraint((fixed_diff * denom) - num)
        self.fracs = []


def combine_ef(values) -> QM31Var:
    return (
        (values[0] + values[1].shift_by_i()) + values[2].shift_by_j()
    ) + values[3].shift_by_ij()


# ---------------------------------------------------------------------------
# Plonk AIR (composition plonk.rs:8-82)
# ---------------------------------------------------------------------------

def evaluate_plonk(lookup_elements: LookupElementsVar, ev: EvalAtRowVar):
    a_wire = ev.get_preprocessed_column()
    b_wire = ev.get_preprocessed_column()
    c_wire = ev.get_preprocessed_column()
    op = ev.get_preprocessed_column()
    mult_a = ev.get_preprocessed_column()
    mult_b = ev.get_preprocessed_column()
    mult_c = ev.get_preprocessed_column()
    poseidon_wire = ev.get_preprocessed_column()
    mult_poseidon = ev.get_preprocessed_column()
    enforce_c_m31 = ev.get_preprocessed_column()

    vals = [ev.next_trace_mask() for _ in range(12)]
    a4, b4, c4 = vals[0:4], vals[4:8], vals[8:12]

    ev.add_constraint(enforce_c_m31 * c4[1])
    ev.add_constraint(enforce_c_m31 * c4[2])
    ev.add_constraint(enforce_c_m31 * c4[3])

    a_val = combine_ef(a4)
    b_val = combine_ef(b4)
    c_val = combine_ef(c4)

    one = ev.one()
    ev.add_constraint(
        (c_val - (op * (a_val + b_val))) - (((one - op) * a_val) * b_val)
    )

    ev.add_to_relation(lookup_elements, mult_a, [a_val, a_wire])
    ev.add_to_relation(lookup_elements, mult_b, [b_val, b_wire])
    ev.add_to_relation(lookup_elements, mult_c, [c_val, c_wire])
    ev.add_to_relation(
        lookup_elements, -mult_poseidon, [poseidon_wire, a_val, b_val]
    )
    ev.finalize_logup(2)
    return ev


# ---------------------------------------------------------------------------
# PlonkWithoutPoseidon AIR (single table; gate semantics per
# constraint_system/src/plonk_without_poseidon.rs:410-598, logup :600-631)
# ---------------------------------------------------------------------------

def evaluate_plonk_np(lookup_elements: LookupElementsVar, ev: EvalAtRowVar):
    """Unified without-poseidon row constraint:

      is_pow5 * (a_k^4 - b_k) = 0                              (4 constraints)
      c = is_arith*op1*(a+b) + (1-op1)*a*b + is_m4*M4(a.b)
          + is_hadamard*(a.b) + is_grandsum*gs*(1,1,1,1)       (1 constraint)
      logup: 1/(a) + 1/(b) + mult_c/(c), batched by 2.
    """
    a_wire = ev.get_preprocessed_column()
    b_wire = ev.get_preprocessed_column()
    c_wire = ev.get_preprocessed_column()
    op1 = ev.get_preprocessed_column()
    op2 = ev.get_preprocessed_column()
    op3 = ev.get_preprocessed_column()
    op4 = ev.get_preprocessed_column()
    mult_c = ev.get_preprocessed_column()

    vals = [ev.next_trace_mask() for _ in range(12)]
    a4, b4, c4 = vals[0:4], vals[4:8], vals[8:12]

    one = ev.one()
    for k in range(4):
        a2 = a4[k] * a4[k]
        ev.add_constraint(op2 * ((a2 * a2) - b4[k]))

    h = [a4[k] * b4[k] for k in range(4)]
    m4 = _apply_m4(h)
    gs = ((a4[0] + a4[1]) + (a4[2] + a4[3])) + (
        (b4[0] + b4[1]) + (b4[2] + b4[3])
    )

    a_val = combine_ef(a4)
    b_val = combine_ef(b4)
    c_val = combine_ef(c4)

    one_m_op3 = one - op3
    one_m_op4 = one - op4
    is_arith = one_m_op3 * one_m_op4
    is_m4 = op3 * one_m_op4
    is_hadamard = one_m_op3 * op4
    is_grandsum = op3 * op4

    expected = (
        (is_arith * (op1 * (a_val + b_val)))
        + (((one - op1) * a_val) * b_val)
        + (is_m4 * combine_ef(m4))
        + (is_hadamard * combine_ef(h))
        + (is_grandsum * combine_ef([gs, gs, gs, gs]))
    )
    ev.add_constraint(c_val - expected)

    ev.add_to_relation(lookup_elements, one, [a_val, a_wire])
    ev.add_to_relation(lookup_elements, one, [b_val, b_wire])
    ev.add_to_relation(lookup_elements, mult_c, [c_val, c_wire])
    ev.finalize_logup(2)
    return ev


# ---------------------------------------------------------------------------
# Poseidon AIR (composition poseidon.rs:73-241)
# ---------------------------------------------------------------------------

def _apply_m4(x):
    t0 = x[0] + x[1]
    t02 = t0 + t0
    t1 = x[2] + x[3]
    t12 = t1 + t1
    t2 = (x[1] + x[1]) + t1
    t3 = (x[3] + x[3]) + t0
    t4 = (t12 + t12) + t3
    t5 = (t02 + t02) + t2
    return [t3 + t5, t5, t2 + t4, t4]


def _apply_external_round_matrix(state):
    for i in range(4):
        state[4 * i : 4 * i + 4] = _apply_m4(state[4 * i : 4 * i + 4])
    for j in range(4):
        s = ((state[j] + state[j + 4]) + state[j + 8]) + state[j + 12]
        for i in range(4):
            state[4 * i + j] = state[4 * i + j] + s


def _apply_internal_round_matrix(state):
    total = state[0]
    for s in state[1:]:
        total = total + s
    state[0] = state[0] + ((state[0] + state[0]) + total)
    for i in range(1, N_STATE):
        state[i] = state[i].mul_constant_m31(1 << (i + 1)) + total


def _pow5(x: QM31Var) -> QM31Var:
    x2 = x * x
    x4 = x2 * x2
    return x4 * x


def evaluate_poseidon(lookup_elements: LookupElementsVar, ev: EvalAtRowVar):
    is_first_round = ev.get_preprocessed_column()
    is_last_round = ev.get_preprocessed_column()
    is_full_round = ev.get_preprocessed_column()

    one = ev.one()
    is_not_first_round = one - is_first_round
    is_not_last_round = one - is_last_round
    is_partial_round = is_not_first_round - is_full_round

    round_id = ev.get_preprocessed_column()
    rc0 = [ev.get_preprocessed_column() for _ in range(16)]
    rc1 = [ev.get_preprocessed_column() for _ in range(16)]
    external_idx_1 = ev.get_preprocessed_column()
    external_idx_2 = ev.get_preprocessed_column()
    is_external_idx_1_nonzero = ev.get_preprocessed_column()
    is_external_idx_2_nonzero = ev.get_preprocessed_column()

    swap_bit_addr = rc0[0]

    in_state = [ev.next_trace_mask() for _ in range(N_STATE)]
    intermediate_state = [ev.next_trace_mask() for _ in range(N_STATE)]
    out_state = [ev.next_trace_mask() for _ in range(N_STATE)]
    swap_bit_value = intermediate_state[0]

    # first round: swap + external matrix
    one_minus_swap = one - swap_bit_value
    permuted = [
        (in_state[i] * one_minus_swap) + (in_state[i + 8] * swap_bit_value)
        if i < 8
        else (in_state[i - 8] * swap_bit_value) + (in_state[i] * one_minus_swap)
        for i in range(N_STATE)
    ]
    _apply_external_round_matrix(permuted)
    for i in range(N_STATE):
        ev.add_constraint(is_first_round * (permuted[i] - out_state[i]))

    # full round
    frs = [in_state[i] + rc0[i] for i in range(N_STATE)]
    frs = [_pow5(x) for x in frs]
    for i in range(N_STATE):
        ev.add_constraint(is_full_round * (intermediate_state[i] - frs[i]))
        frs[i] = intermediate_state[i]
    _apply_external_round_matrix(frs)
    frs = [frs[i] + rc1[i] for i in range(N_STATE)]
    frs = [_pow5(x) for x in frs]
    _apply_external_round_matrix(frs)
    for i in range(N_STATE):
        ev.add_constraint(is_full_round * (out_state[i] - frs[i]))

    # partial rounds
    prs = list(in_state)
    for r in range(14):
        prs[0] = prs[0] + rc0[r]
        prs[0] = _pow5(prs[0])
        ev.add_constraint(is_partial_round * (intermediate_state[r] - prs[0]))
        prs[0] = intermediate_state[r]
        _apply_internal_round_matrix(prs)
    for i in range(N_STATE):
        ev.add_constraint(is_partial_round * (out_state[i] - prs[i]))

    # logup relations (5)
    in_left_id = round_id + round_id
    in_right_id = in_left_id + one
    out_left_id = in_right_id + one
    out_right_id = out_left_id + one

    sel = is_external_idx_1_nonzero * is_first_round
    idv = (is_first_round * external_idx_1) + (is_not_first_round * in_left_id)
    a = combine_ef(in_state[0:4])
    b = combine_ef(in_state[4:8])
    ev.add_to_relation(lookup_elements, sel - is_not_first_round, [idv, a, b])

    sel = is_external_idx_2_nonzero * is_first_round
    idv = (is_first_round * external_idx_2) + (is_not_first_round * in_right_id)
    a = combine_ef(in_state[8:12])
    b = combine_ef(in_state[12:16])
    ev.add_to_relation(lookup_elements, sel - is_not_first_round, [idv, a, b])

    sel = is_external_idx_1_nonzero * is_last_round
    idv = (is_last_round * external_idx_1) + (is_not_last_round * out_left_id)
    a = combine_ef(out_state[0:4])
    b = combine_ef(out_state[4:8])
    ev.add_to_relation(lookup_elements, sel + is_not_last_round, [idv, a, b])

    sel = is_external_idx_2_nonzero * is_last_round
    idv = (is_last_round * external_idx_2) + (is_not_last_round * out_right_id)
    a = combine_ef(out_state[8:12])
    b = combine_ef(out_state[12:16])
    ev.add_to_relation(lookup_elements, sel + is_not_last_round, [idv, a, b])

    ev.add_to_relation(
        lookup_elements,
        is_first_round * is_not_last_round,
        [swap_bit_value, swap_bit_addr],
    )

    ev.finalize_logup(3)
    return ev


# ---------------------------------------------------------------------------
# The composition check (composition lib.rs:33-121)
# ---------------------------------------------------------------------------

class CompositionCheck:
    @staticmethod
    def compute(
        spec: VerifierSpec,
        lookup_elements: LookupElementsVar,
        random_coeff: QM31Var,
        oods_point: CirclePointQM31,
        proof: ProofVar,
    ) -> None:
        sv = proof.stark_proof.sampled_values
        accumulator = PointEvaluationAccumulatorVar(random_coeff)

        # plonk columns are the first N of each tree; poseidon the rest
        plonk_mask = [
            sv[0][:N_PREPROCESSED_PLONK],
            sv[1][:N_TRACE_PLONK],
            sv[2][:N_INTERACTION_PLONK],
        ]
        poseidon_mask = [
            sv[0][N_PREPROCESSED_PLONK:],
            sv[1][N_TRACE_PLONK:],
            sv[2][N_INTERACTION_PLONK:],
        ]

        ev = EvalAtRowVar(
            plonk_mask,
            proof.stmt1.plonk_total_sum,
            coset_vanishing(oods_point, spec.log_size_plonk).inv(),
            spec.log_size_plonk,
            accumulator,
        )
        evaluate_plonk(lookup_elements, ev)

        ev = EvalAtRowVar(
            poseidon_mask,
            proof.stmt1.poseidon_total_sum,
            coset_vanishing(oods_point, spec.log_size_poseidon).inv(),
            spec.log_size_poseidon,
            accumulator,
        )
        evaluate_poseidon(lookup_elements, ev)

        computed = accumulator.finalize()
        left = combine_ef([sv[3][k][0] for k in range(4)])
        right = combine_ef([sv[3][k][0] for k in range(4, 8)])
        expected = left + (
            right
            * oods_point.repeated_double_x_only(
                spec.composition_log_degree_bound - 2
            )
        )
        computed.equalverify(expected)
