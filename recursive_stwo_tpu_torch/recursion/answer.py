"""In-circuit FRI answers: Merkle decommitment of the 4 commitment trees at
the query positions + OODS quotient accumulation per query row.

Reference: /root/reference/components/recursive/answer/src/{lib,
data_structures}.rs.  The batch/alpha-chaining order mirrors the native
`verifier.quotients` kernels (bit-exact against the fixtures).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core import circle_host as ccircle
from ..gadgets.circle import CirclePointM31, CirclePointQM31
from ..gadgets.fields import QM31Var
from ..gadgets.query import QueryPositionsPerLogSizeVar
from ..verifier.spec import VerifierSpec
from .data_structures import (
    LookupElementsVar,
    ProofVar,
    SinglePathMerkleProofVar,
)
from .fiat_shamir import FiatShamirResults


# ---------------------------------------------------------------------------
# Quotient helpers (answer data_structures.rs)
# ---------------------------------------------------------------------------

class ColumnSampleBatchVar:
    """Samples grouped by shift, first-occurrence order (ds.rs:42-64)."""

    def __init__(self, point: CirclePointQM31, columns_and_values):
        self.point = point
        self.columns_and_values = columns_and_values  # [(col_idx, QM31Var)]

    @staticmethod
    def new_vec(samples: List[List[tuple]]) -> List["ColumnSampleBatchVar"]:
        """samples[col] = [(shift_key, point, value), ...]."""
        grouped: Dict[object, list] = {}
        order = []
        for column_index, column_samples in enumerate(samples):
            for shift_key, point, value in column_samples:
                if shift_key not in grouped:
                    grouped[shift_key] = []
                    order.append(shift_key)
                grouped[shift_key].append((point, column_index, value))
        return [
            ColumnSampleBatchVar(
                grouped[k][0][0], [(c, v) for _, c, v in grouped[k]]
            )
            for k in order
        ]


def complex_conjugate_line_coeffs_var(point, value, alpha):
    value0, value1 = value.decompose_cm31()
    y0, y1 = point.y.decompose_cm31()
    a = value1
    c = y1
    b = (value0 * y1) - (value1 * y0)
    return (alpha * a, alpha * b, alpha * c)


def column_line_coeffs_var(sample_batches, random_coeff):
    cs = random_coeff.cs
    alpha = QM31Var.new_constant(cs, (0, 0, (-2) % ((1 << 31) - 1), 0))
    out = []
    for batch in sample_batches:
        coeffs = []
        for _, sampled_value in batch.columns_and_values:
            coeffs.append(
                complex_conjugate_line_coeffs_var(batch.point, sampled_value, alpha)
            )
            alpha = alpha * random_coeff
        out.append(coeffs)
    return out


def denominator_inverses_var(sample_batches, domain_point):
    out = []
    for batch in sample_batches:
        prx, pix = batch.point.x.decompose_cm31()
        pry, piy = batch.point.y.decompose_cm31()
        a = (prx - domain_point.x) * piy
        b = (pry - domain_point.y) * pix
        out.append((a - b).inv())
    return out


def accumulate_row_quotients_var(
    sample_batches, queried_values_at_row, line_coeffs, domain_point
):
    cs = domain_point.cs
    denominator_inverses = denominator_inverses_var(sample_batches, domain_point)
    row_accumulator = QM31Var.zero(cs)
    for batch, coeffs, denom_inv in zip(
        sample_batches, line_coeffs, denominator_inverses
    ):
        numerator = QM31Var.zero(cs)
        for (column_index, _), (a, b, c) in zip(batch.columns_and_values, coeffs):
            value = queried_values_at_row[column_index] * c
            linear_term = (a * domain_point.y) + b
            numerator = numerator + (value - linear_term)
        row_accumulator = row_accumulator + (numerator * denom_inv)
    return row_accumulator


# ---------------------------------------------------------------------------
# The answer stage (answer lib.rs:33-382)
# ---------------------------------------------------------------------------

class AnswerResults:
    def __init__(self, cs):
        self.cs = cs
        self.query_positions_per_log_size = None
        self.fri_answers: List[List[QM31Var]] = []  # per log-size group
        self.domain_points: List[List[CirclePointM31]] = []

    @classmethod
    def compute(
        cls,
        spec: VerifierSpec,
        oods_point: CirclePointQM31,
        fs_results: FiatShamirResults,
        proof: ProofVar,
        tree_paths,  # 4x TreePaths (batched hints), batch index 0
        native_answers=None,  # optional per-group (B, Q) QM31 cross-check
    ) -> "AnswerResults":
        cs = oods_point.cs
        res = cls(cs)

        # shifted mask points: shift 0 -> oods; shift -1 -> oods - step
        step_plonk = ccircle.CanonicCoset(spec.log_size_plonk).step()
        step_poseidon = ccircle.CanonicCoset(spec.log_size_poseidon).step()
        shifted = {
            ("plonk", 0): oods_point,
            ("poseidon", 0): oods_point,
            ("plonk", -1): oods_point.add_constant_point(
                ccircle.point_neg(step_plonk)
            ),
            ("poseidon", -1): oods_point.add_constant_point(
                ccircle.point_neg(step_poseidon)
            ),
        }

        # per flattened column: [(shift_key, point, value_var)]
        from ..verifier.spec import (
            N_INTERACTION_PLONK,
            N_PREPROCESSED_PLONK,
            N_TRACE_PLONK,
        )

        n_plonk_per_tree = (N_PREPROCESSED_PLONK, N_TRACE_PLONK,
                            N_INTERACTION_PLONK, 8)
        samples_per_col = []  # aligned with flattened (tree, col)
        for tree_idx, tree in enumerate(proof.stark_proof.sampled_values):
            for col_idx, col_samples in enumerate(tree):
                shifts = spec.sample_shifts_per_column[tree_idx][col_idx]
                assert len(shifts) == len(col_samples)
                which = (
                    "plonk"
                    if col_idx < n_plonk_per_tree[tree_idx] or tree_idx == 3
                    else "poseidon"
                )
                entries = []
                for shift, value in zip(shifts, col_samples):
                    if shift == 0:
                        key = "zero"
                        point = oods_point
                    else:
                        key = (which, shift)
                        point = shifted[(which, shift)]
                    entries.append((key, point, value))
                samples_per_col.append(entries)

        # query vars per log size
        res.query_positions_per_log_size = QueryPositionsPerLogSizeVar(
            spec.log_last_layer_degree_bound + spec.log_blowup_factor + 1,
            spec.max_first_layer_log,
            fs_results.raw_queries,
        )

        # verify the 4 commitment trees
        commitments = [
            fs_results.preprocessed_commitment,
            fs_results.trace_commitment,
            fs_results.interaction_trace_commitment,
            fs_results.composition_commitment,
        ]
        proof_vars = []  # [tree][query] -> SinglePathMerkleProofVar
        for t in range(4):
            depth = spec.tree_max_domain_log[t]
            queries = res.query_positions_per_log_size[depth]
            tp = tree_paths[t]
            tree_proof_vars = []
            for qi, query in enumerate(queries):
                columns = {
                    lvl: np.asarray(vals)[0, qi]
                    for lvl, vals in tp.columns.items()
                }
                pv = SinglePathMerkleProofVar(
                    cs,
                    depth,
                    np.asarray(tp.sibling_hashes)[0, qi],
                    columns,
                )
                pv.verify(commitments[t], query.bits)
                tree_proof_vars.append(pv)
            proof_vars.append(tree_proof_vars)

        # queried values per row per log size (tree-major column order)
        queried_values = {}
        for L in spec.all_log_sizes:
            rows = []
            for qi in range(spec.n_queries):
                row = []
                for t in range(4):
                    cols = proof_vars[t][qi].columns.get(L)
                    if cols is not None:
                        row.extend(cols)
                rows.append(row)
            queried_values[L] = rows

        # flattened column log sizes, stable-grouped descending
        flat_logs = [
            L for tree in spec.tree_col_domain_logs for L in tree
        ]
        for g, L in enumerate(spec.all_log_sizes):
            group_samples = [
                samples_per_col[i]
                for i, cl in enumerate(flat_logs)
                if cl == L
            ]
            assert len(group_samples) == len(spec.group_columns[g])
            domain_pts, answers = cls.fri_answers_for_log_size(
                group_samples,
                fs_results.after_sampled_values_random_coeff,
                res.query_positions_per_log_size[L],
                queried_values[L],
            )
            res.domain_points.append(domain_pts)
            res.fri_answers.append(answers)
            if native_answers is not None:
                na = native_answers[g]
                for qi, var in enumerate(answers):
                    expect = tuple(
                        int(np.asarray(c)[0, qi]) for c in na
                    )
                    assert var.value == expect, (L, qi)

        return res

    @staticmethod
    def fri_answers_for_log_size(
        samples, random_coeff, query_positions, queried_values
    ):
        sample_batches = ColumnSampleBatchVar.new_vec(samples)
        line_coeffs = column_line_coeffs_var(sample_batches, random_coeff)

        domain_points = []
        quotient_evals = []
        for query_position, row in zip(query_positions, queried_values):
            domain_point = query_position.get_next_point()
            quotient_evals.append(
                accumulate_row_quotients_var(
                    sample_batches, row, line_coeffs, domain_point
                )
            )
            domain_points.append(domain_point)
        return domain_points, quotient_evals
