"""In-circuit FRI folding: first-layer circle folds, inner line folds, last
layer polynomial check.

Reference: /root/reference/components/recursive/folding/src/lib.rs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..gadgets.fields import QM31Var
from ..verifier.spec import VerifierSpec
from .answer import AnswerResults
from .data_structures import ProofVar, SinglePairMerkleProofVar
from .fiat_shamir import FiatShamirResults


def _pair_proof_var(cs, pair_paths, qi: int, depth: int):
    """Slice batched PairPaths hints to one query's SinglePairMerkleProofVar."""
    sib = np.asarray(pair_paths.sibling_hashes)[0, qi]
    self_cols = {
        lvl: np.asarray(v)[0, qi] for lvl, v in pair_paths.self_columns.items()
    }
    sib_cols = {
        lvl: np.asarray(v)[0, qi]
        for lvl, v in pair_paths.sibling_columns.items()
    }
    return SinglePairMerkleProofVar(cs, depth, sib, self_cols, sib_cols)


class FoldingResults:
    @staticmethod
    def compute(
        spec: VerifierSpec,
        proof: ProofVar,
        fs_results: FiatShamirResults,
        answer_results: AnswerResults,
        first_layer_paths,
        inner_layer_paths,
    ) -> None:
        cs = answer_results.cs
        M = spec.max_first_layer_log
        Q = spec.n_queries

        # first-layer pair proofs, verified against the first-layer root
        proofs: List[SinglePairMerkleProofVar] = []
        for qi in range(Q):
            p = _pair_proof_var(cs, first_layer_paths, qi, M)
            p.verify(
                proof.stark_proof.fri_proof.first_layer_commitment,
                answer_results.query_positions_per_log_size[M][qi].bits,
            )
            proofs.append(p)

        # fri answers == self_columns (lib.rs:36-54)
        for g, log_size in enumerate(spec.all_log_sizes):
            for qi, fri_answer in enumerate(answer_results.fri_answers[g]):
                proofs[qi].self_columns[log_size].equalverify(fri_answer)

        # first-layer circle folds (lib.rs:57-90)
        folded_results = {}
        for log_size in spec.all_log_sizes:
            per_query = []
            for qi in range(Q):
                query = answer_results.query_positions_per_log_size[log_size][qi]
                self_val = proofs[qi].self_columns[log_size]
                sibling_val = proofs[qi].siblings_columns[log_size]

                point = query.get_absolute_point().double()
                y_inv = point.y.inv()

                left_val, right_val = QM31Var.swap(
                    self_val, sibling_val,
                    query.bits.value[0], query.bits.variables[0],
                )
                new_left = left_val + right_val
                new_right = (left_val - right_val) * y_inv
                per_query.append(
                    new_left
                    + (new_right * fs_results.fri_alphas[M - log_size])
                )
            folded_results[log_size] = per_query

        # inner layers (lib.rs:122-192)
        log_size = M
        folded = [QM31Var.zero(cs) for _ in range(Q)]
        n_inner = len(proof.stark_proof.fri_proof.inner_layer_commitments)
        for i in range(n_inner):
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
                merkle_proof = _pair_proof_var(
                    cs, inner_layer_paths[i], qi, log_size
                )
                self_val = merkle_proof.self_columns[log_size]
                sibling_val = merkle_proof.siblings_columns[log_size]
                folded[qi].equalverify(self_val)

                query = queries[qi]
                point = query.get_absolute_point()
                x_inv = point.x.inv()

                left_val, right_val = QM31Var.swap(
                    self_val, sibling_val,
                    query.bits.value[0], query.bits.variables[0],
                )
                new_left = left_val + right_val
                new_right = (left_val - right_val) * x_inv
                new_folded.append(
                    new_left + (new_right * fs_results.fri_alphas[i + 1])
                )

                merkle_proof.verify(
                    proof.stark_proof.fri_proof.inner_layer_commitments[i],
                    query.bits,
                )
            folded = new_folded

        # last layer (lib.rs:194-204)
        queries = answer_results.query_positions_per_log_size[log_size]
        last_poly = proof.stark_proof.fri_proof.last_poly
        for qi in range(Q):
            if len(last_poly.coeffs) == 1:
                folded[qi].equalverify(last_poly.coeffs[0])
            else:
                x = queries[qi].get_next_point_x()
                folded[qi].equalverify(last_poly.eval_at_point(x))
