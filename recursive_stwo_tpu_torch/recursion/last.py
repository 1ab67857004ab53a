"""Last-layer verifier components: verify a PlonkWithPoseidon proof inside a
PlonkWithoutPoseidon circuit with all Fiat-Shamir / decommitment data as
packed PUBLIC INPUTS (the Bitcoin-facing layer).

Reference: the reference repository's components/last/{fiat_shamir,data_structures,
composition,answer,folding}.  In-circuit Poseidon hashing runs through the
emulated (SIMD-gate) permutation; there is no in-circuit transcript — the
outer SHA-256 verifier is responsible for binding the public inputs.

`LastFiatShamirResults.compute` generalizes the reference's hardcoded
(1,1),(2,i),(3,j) total-sum inputs to any inner-input list
(last fiat_shamir lib.rs:186-203).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..cs import scalar
from ..gadgets import merkle as gmerkle
from ..gadgets.circle import CirclePointQM31
from ..gadgets.fields import M31Var, QM31Var
from ..gadgets.line import LinePolyVar
from ..verifier.spec import VerifierSpec
from .answer import AnswerResults
from .composition import CompositionCheck
from .data_structures import LookupElementsVar, Statement0Var, Statement1Var
from .fiat_shamir import _fs_scalar


def _q_tuple(arr4) -> tuple:
    a = np.asarray(arr4).reshape(-1)
    return (int(a[0]), int(a[1]), int(a[2]), int(a[3]))


# ---------------------------------------------------------------------------
# Host-side public-input assembly
# ---------------------------------------------------------------------------

class LastFiatShamirInput:
    """Native FS outputs destined to become public inputs
    (last fiat_shamir lib.rs:22-79)."""

    def __init__(self, spec: VerifierSpec, proof, fs):
        from ..verifier import hints as hints_mod

        self.t = _fs_scalar(fs.oods_t)
        flat = [
            _q_tuple(s)
            for tree in proof.stark_proof.sampled_values
            for col in tree
            for s in col
        ]
        elems = np.array(
            [limb for v in flat for limb in v], dtype=np.uint32
        )
        self.sampled_values_hash = tuple(
            int(x) for x in hints_mod.hash_node(None, elems)
        )
        self.plonk_total_sum = _q_tuple(proof.plonk_total_sum)
        self.poseidon_total_sum = _q_tuple(proof.poseidon_total_sum)
        self.z = _fs_scalar(fs.z)
        self.alpha = _fs_scalar(fs.alpha)
        self.random_coeff = _fs_scalar(fs.random_coeff)
        self.after_sampled_values_random_coeff = _fs_scalar(
            fs.after_sampled_values_random_coeff
        )
        M = spec.max_first_layer_log
        self.queries = [
            int(v) & ((1 << M) - 1) for v in np.asarray(fs.raw_queries)[0]
        ]
        self.fri_alphas = [_fs_scalar(a) for a in fs.fri_alphas]


class LastFiatShamirInputVar:
    """Packs the input as public QM31 wires (lib.rs:82-160)."""

    def __init__(self, cs, value: LastFiatShamirInput):
        self.cs = cs
        self.t = QM31Var.new_public_input(cs, value.t)
        h = value.sampled_values_hash
        self.sampled_values_hash = [
            QM31Var.new_public_input(cs, tuple(h[0:4])),
            QM31Var.new_public_input(cs, tuple(h[4:8])),
        ]
        self.plonk_total_sum = QM31Var.new_public_input(cs, value.plonk_total_sum)
        self.poseidon_total_sum = QM31Var.new_public_input(
            cs, value.poseidon_total_sum
        )
        self.lookup_element_z = QM31Var.new_public_input(cs, value.z)
        self.lookup_element_alpha = QM31Var.new_public_input(cs, value.alpha)
        self.random_coeff = QM31Var.new_public_input(cs, value.random_coeff)
        self.after_sampled_values_random_coeff = QM31Var.new_public_input(
            cs, value.after_sampled_values_random_coeff
        )
        self.queries_len = len(value.queries)
        self.packed_queries = []
        qs = list(value.queries)
        while len(qs) % 4:
            qs.append(0)
        for k in range(0, len(qs), 4):
            self.packed_queries.append(
                QM31Var.new_public_input(cs, tuple(qs[k : k + 4]))
            )
        self.fri_alphas = [
            QM31Var.new_public_input(cs, a) for a in value.fri_alphas
        ]


class LastProofVar:
    """Only statements + sampled values + last poly are allocated
    (last data_structures lib.rs:46-83)."""

    def __init__(self, cs, proof):
        self.cs = cs
        self.stmt0 = Statement0Var(
            cs, proof.log_size_plonk, proof.log_size_poseidon
        )
        self.stmt1 = Statement1Var(
            cs, proof.plonk_total_sum, proof.poseidon_total_sum
        )
        self.sampled_values = [
            [[QM31Var.new_witness(cs, _q_tuple(s)) for s in col] for col in tree]
            for tree in proof.stark_proof.sampled_values
        ]
        self.last_poly = LinePolyVar.new_witness(
            cs,
            [_q_tuple(c) for c in proof.stark_proof.fri_proof.last_layer_poly],
        )

    def sampled_values_flattened(self) -> List[QM31Var]:
        return [s for tree in self.sampled_values for col in tree for s in col]


class LastFiatShamirResults:
    def __init__(self):
        self.oods_point = None
        self.plonk_total_sum = None
        self.poseidon_total_sum = None
        self.lookup_elements = None
        self.random_coeff = None
        self.after_sampled_values_random_coeff = None
        self.queries: List[M31Var] = []
        self.fri_alphas: List[QM31Var] = []

    @classmethod
    def compute(cls, proof_var: LastProofVar, input_var: LastFiatShamirInputVar,
                inner_inputs=None) -> "LastFiatShamirResults":
        cs = input_var.cs
        res = cls()
        res.oods_point = CirclePointQM31.from_t(input_var.t)

        flat = proof_var.sampled_values_flattened()
        svh = gmerkle.hash_qm31_columns_get_rate(flat)
        expected = input_var.sampled_values_hash
        got = svh.to_qm31()
        got[0].equalverify(expected[0])
        got[1].equalverify(expected[1])

        res.lookup_elements = LookupElementsVar(
            cs, input_var.lookup_element_z, input_var.lookup_element_alpha
        )

        for packed in input_var.packed_queries:
            res.queries.extend(packed.decompose_m31())
        res.queries = res.queries[: input_var.queries_len]

        # total-sum constraint over the inner proof's public inputs
        if inner_inputs is None:
            inner_inputs = [
                (1, scalar.QONE), (2, scalar.QI), (3, scalar.QJ)
            ]
        input_sum = QM31Var.zero(cs)
        for idx, v in inner_inputs:
            term = (
                QM31Var.new_constant(cs, tuple(v))
                + res.lookup_elements.alpha.mul_constant_m31(idx)
            ) - res.lookup_elements.z
            input_sum = input_sum + term.inv()

        res.plonk_total_sum = input_var.plonk_total_sum
        res.poseidon_total_sum = input_var.poseidon_total_sum
        (
            (input_sum + res.poseidon_total_sum) + res.plonk_total_sum
        ).equalverify(QM31Var.zero(cs))

        res.random_coeff = input_var.random_coeff
        res.after_sampled_values_random_coeff = (
            input_var.after_sampled_values_random_coeff
        )
        res.fri_alphas = list(input_var.fri_alphas)
        return res


# ---------------------------------------------------------------------------
# Decommitment as packed public inputs
# ---------------------------------------------------------------------------

def pack_columns(values: List[int]) -> List[tuple]:
    """<=4 M31 -> 1 QM31; <=8 -> 2; else poseidon-hash -> 2
    (last answer merkle_proofs.rs:170-207)."""
    from ..verifier import hints as hints_mod

    n = len(values)
    if n <= 4:
        v = list(values) + [0] * (4 - n)
        return [tuple(v)]
    if n <= 8:
        v = list(values) + [0] * (8 - n)
        return [tuple(v[0:4]), tuple(v[4:8])]
    h = hints_mod.hash_node(None, np.array(values, dtype=np.uint32))
    return [tuple(int(x) for x in h[0:4]), tuple(int(x) for x in h[4:8])]


class LastDecommitInputVar:
    """Packed column openings for the 4 trees as public inputs."""

    def __init__(self, cs, tree_columns: List[Dict[int, np.ndarray]], n_queries):
        # tree_columns[t][log_size] -> (Q, n) raw column values per query
        self.cs = cs
        self.packed = []  # [tree][query][log_size] -> [QM31Var]
        for t, columns in enumerate(tree_columns):
            per_query = []
            for qi in range(n_queries):
                d = {}
                for lvl in sorted(columns.keys()):
                    vals = [int(v) for v in np.asarray(columns[lvl])[qi]]
                    d[lvl] = [
                        QM31Var.new_public_input(cs, p)
                        for p in pack_columns(vals)
                    ]
                per_query.append(d)
            self.packed.append(per_query)


class LastSinglePathMerkleProofVar:
    """Witness columns equalverified against the packed public input
    (merkle_proofs.rs:120-163)."""

    def __init__(self, cs, packed: Dict[int, List[QM31Var]],
                 columns: Dict[int, List[int]]):
        self.cs = cs
        self.columns: Dict[int, List[M31Var]] = {}
        for lvl in sorted(columns.keys()):
            vals = columns[lvl]
            vars_ = [M31Var.new_witness(cs, v) for v in vals]
            packed_lvl = packed[lvl]
            if len(vals) <= 4:
                assert len(packed_lvl) == 1
                decomposed = packed_lvl[0].decompose_m31()
                for left, right in zip(vars_, decomposed):
                    left.equalverify(right)
            elif len(vals) <= 8:
                assert len(packed_lvl) == 2
                decomposed = packed_lvl[0].decompose_m31()
                for left, right in zip(vars_[0:4], decomposed):
                    left.equalverify(right)
                decomposed = packed_lvl[1].decompose_m31()
                for left, right in zip(vars_[4:8], decomposed):
                    left.equalverify(right)
            else:
                assert len(packed_lvl) == 2
                h = gmerkle.hash_m31_columns_get_rate(vars_).to_qm31()
                h[0].equalverify(packed_lvl[0])
                h[1].equalverify(packed_lvl[1])
            self.columns[lvl] = vars_


# ---------------------------------------------------------------------------
# Last answer + folding stages
# ---------------------------------------------------------------------------

class LastAnswerResults:
    @classmethod
    def compute(
        cls,
        spec: VerifierSpec,
        fs_results: LastFiatShamirResults,
        decommit_input_var: LastDecommitInputVar,
        tree_columns,  # [tree][log_size] -> (Q, n) raw values
        proof_var: LastProofVar,
        native_answers=None,
    ) -> "AnswerResults":
        from ..core import circle_host as ccircle
        from ..gadgets.query import QueryPositionsPerLogSizeVar
        from ..verifier.spec import (
            N_INTERACTION_PLONK,
            N_PREPROCESSED_PLONK,
            N_TRACE_PLONK,
        )

        cs = fs_results.oods_point.cs
        oods_point = fs_results.oods_point
        res = AnswerResults(cs)

        step_plonk = ccircle.CanonicCoset(spec.log_size_plonk).step()
        step_poseidon = ccircle.CanonicCoset(spec.log_size_poseidon).step()
        shifted = {
            ("plonk", -1): oods_point.add_constant_point(
                ccircle.point_neg(step_plonk)
            ),
            ("poseidon", -1): oods_point.add_constant_point(
                ccircle.point_neg(step_poseidon)
            ),
        }
        n_plonk_per_tree = (N_PREPROCESSED_PLONK, N_TRACE_PLONK,
                            N_INTERACTION_PLONK, 8)
        samples_per_col = []
        for tree_idx, tree in enumerate(proof_var.sampled_values):
            for col_idx, col_samples in enumerate(tree):
                shifts = spec.sample_shifts_per_column[tree_idx][col_idx]
                which = (
                    "plonk"
                    if col_idx < n_plonk_per_tree[tree_idx] or tree_idx == 3
                    else "poseidon"
                )
                entries = []
                for shift, value in zip(shifts, col_samples):
                    if shift == 0:
                        entries.append(("zero", oods_point, value))
                    else:
                        entries.append(
                            ((which, shift), shifted[(which, shift)], value)
                        )
                samples_per_col.append(entries)

        res.query_positions_per_log_size = QueryPositionsPerLogSizeVar(
            spec.log_blowup_factor + 1,
            spec.max_first_layer_log,
            fs_results.queries,
        )

        # witness columns tied to packed public inputs (no hash walks)
        proof_vars = []
        for t in range(4):
            per_query = []
            for qi in range(spec.n_queries):
                columns = {
                    lvl: [int(v) for v in np.asarray(vals)[qi]]
                    for lvl, vals in tree_columns[t].items()
                }
                per_query.append(
                    LastSinglePathMerkleProofVar(
                        cs, decommit_input_var.packed[t][qi], columns
                    )
                )
            proof_vars.append(per_query)

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

        flat_logs = [L for tree in spec.tree_col_domain_logs for L in tree]
        for g, L in enumerate(spec.all_log_sizes):
            group_samples = [
                samples_per_col[i] for i, cl in enumerate(flat_logs) if cl == L
            ]
            domain_pts, answers = AnswerResults.fri_answers_for_log_size(
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
                    expect = tuple(int(np.asarray(c)[0, qi]) for c in na)
                    assert var.value == expect, (L, qi)
        return res


class LastPairProofVar:
    """Self/sibling values as public inputs, no hashes
    (folding merkle_proofs.rs:123-156)."""

    def __init__(self, cs, self_columns: Dict[int, tuple],
                 siblings_columns: Dict[int, tuple]):
        self.cs = cs
        self.self_columns = {
            lvl: QM31Var.new_public_input(cs, _q_tuple(v))
            for lvl, v in sorted(self_columns.items())
        }
        self.siblings_columns = {
            lvl: QM31Var.new_public_input(cs, _q_tuple(v))
            for lvl, v in sorted(siblings_columns.items())
        }


def alloc_pair_inputs(cs, pair_paths, n_queries: int) -> List[LastPairProofVar]:
    out = []
    for qi in range(n_queries):
        self_cols = {
            lvl: np.asarray(v)[0, qi]
            for lvl, v in pair_paths.self_columns.items()
        }
        sib_cols = {
            lvl: np.asarray(v)[0, qi]
            for lvl, v in pair_paths.sibling_columns.items()
        }
        out.append(LastPairProofVar(cs, self_cols, sib_cols))
    return out


class LastFoldingResults:
    @staticmethod
    def compute(
        spec: VerifierSpec,
        proof_var: LastProofVar,
        fs_results: LastFiatShamirResults,
        answer_results: "AnswerResults",
        first_layer_vars: List[LastPairProofVar],
        inner_layer_vars: List[List[LastPairProofVar]],
    ) -> None:
        cs = answer_results.cs
        M = spec.max_first_layer_log
        Q = spec.n_queries

        for g, log_size in enumerate(spec.all_log_sizes):
            for qi, fri_answer in enumerate(answer_results.fri_answers[g]):
                first_layer_vars[qi].self_columns[log_size].equalverify(
                    fri_answer
                )

        folded_results = {}
        for log_size in spec.all_log_sizes:
            per_query = []
            for qi in range(Q):
                query = answer_results.query_positions_per_log_size[log_size][qi]
                self_val = first_layer_vars[qi].self_columns[log_size]
                sibling_val = first_layer_vars[qi].siblings_columns[log_size]
                point = query.get_absolute_point().double()
                y_inv = point.y.inv()
                left_val, right_val = QM31Var.swap(
                    self_val, sibling_val,
                    query.bits.value[0], query.bits.variables[0],
                )
                new_left = left_val + right_val
                new_right = (left_val - right_val) * y_inv
                per_query.append(
                    new_left + (new_right * fs_results.fri_alphas[M - log_size])
                )
            folded_results[log_size] = per_query

        log_size = M
        folded = [QM31Var.zero(cs) for _ in range(Q)]
        for i in range(len(inner_layer_vars)):
            if log_size in folded_results:
                fri_alpha = fs_results.fri_alphas[i]
                fri_alpha = fri_alpha * fri_alpha
                folded = [
                    (fri_alpha * v) + b
                    for v, b in zip(folded, folded_results[log_size])
                ]
            log_size -= 1

            queries = answer_results.query_positions_per_log_size[log_size]
            new_folded = []
            for qi in range(Q):
                pair = inner_layer_vars[i][qi]
                self_val = pair.self_columns[log_size]
                sibling_val = pair.siblings_columns[log_size]
                folded[qi].equalverify(self_val)

                query = queries[qi]
                x_inv = query.get_absolute_point().x.inv()
                left_val, right_val = QM31Var.swap(
                    self_val, sibling_val,
                    query.bits.value[0], query.bits.variables[0],
                )
                new_left = left_val + right_val
                new_right = (left_val - right_val) * x_inv
                new_folded.append(
                    new_left + (new_right * fs_results.fri_alphas[i + 1])
                )
            folded = new_folded

        queries = answer_results.query_positions_per_log_size[log_size]
        for qi in range(Q):
            if len(proof_var.last_poly.coeffs) == 1:
                folded[qi].equalverify(proof_var.last_poly.coeffs[0])
            else:
                x = queries[qi].get_next_point_x()
                folded[qi].equalverify(proof_var.last_poly.eval_at_point(x))


class LastCompositionCheck:
    """Same flow as the recursive composition but over LastProofVar
    (last composition lib.rs:16-105)."""

    @staticmethod
    def compute(spec, lookup_elements, random_coeff, oods_point, proof_var):
        class _Shim:
            pass

        shim = _Shim()
        shim.stark_proof = _Shim()
        shim.stark_proof.sampled_values = proof_var.sampled_values
        shim.stmt1 = proof_var.stmt1
        CompositionCheck.compute(
            spec, lookup_elements, random_coeff, oods_point, shim
        )
