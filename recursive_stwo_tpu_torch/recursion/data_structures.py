"""In-circuit proof data structures for the recursive verifier.

Mirrors /root/reference/components/recursive/data_structures/src/lib.rs:
proof allocation (statements, commitments, sampled values, FRI proof, PoW
nonce split 22/21/21), lookup elements, and the two Merkle-proof walkers
(single-path for commitment trees, dual-track pair walk for FRI layers).

Hint data comes from the framework's own host pipeline
(`verifier.hints.prepare` / `verifier.transcript.run_transcript`), sliced
to one proof.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..gadgets import merkle as gmerkle
from ..gadgets.bits import BitsVar
from ..gadgets.fields import M31Var, QM31Var
from ..gadgets.line import LinePolyVar
from ..gadgets.poseidon import Poseidon2Half


def _q_tuple(arr4) -> tuple:
    a = np.asarray(arr4).reshape(-1)
    return (int(a[0]), int(a[1]), int(a[2]), int(a[3]))


def _h_tuple(arr8) -> tuple:
    a = np.asarray(arr8).reshape(-1)
    return tuple(int(v) for v in a)


class Statement0Var:
    """log sizes (< 2^22), data_structures lib.rs:36-57."""

    def __init__(self, cs, log_size_plonk: int, log_size_poseidon: int):
        assert log_size_plonk < (1 << 22) and log_size_poseidon < (1 << 22)
        self.log_size_plonk = M31Var.new_witness(cs, log_size_plonk)
        self.log_size_poseidon = M31Var.new_witness(cs, log_size_poseidon)

    def mix_into(self, channel) -> None:
        channel.mix_one_felt(QM31Var.from_m31var(self.log_size_plonk))
        channel.mix_one_felt(QM31Var.from_m31var(self.log_size_poseidon))


class Statement1Var:
    def __init__(self, cs, plonk_total_sum, poseidon_total_sum):
        self.plonk_total_sum = QM31Var.new_witness(cs, _q_tuple(plonk_total_sum))
        self.poseidon_total_sum = QM31Var.new_witness(
            cs, _q_tuple(poseidon_total_sum)
        )

    def mix_into(self, channel) -> None:
        channel.mix_two_felts(self.plonk_total_sum, self.poseidon_total_sum)


class FriProofVar:
    def __init__(self, cs, fri_proof):
        self.first_layer_commitment = Poseidon2Half.new_witness(
            cs, _h_tuple(fri_proof.first_layer.commitment)
        )
        self.inner_layer_commitments = [
            Poseidon2Half.new_witness(cs, _h_tuple(layer.commitment))
            for layer in fri_proof.inner_layers
        ]
        self.last_poly = LinePolyVar.new_witness(
            cs, [_q_tuple(c) for c in fri_proof.last_layer_poly]
        )


class StarkProofVar:
    def __init__(self, cs, stark_proof):
        self.commitments = [
            Poseidon2Half.new_witness(cs, _h_tuple(c))
            for c in stark_proof.commitments
        ]
        self.sampled_values = [
            [[QM31Var.new_witness(cs, _q_tuple(s)) for s in col] for col in tree]
            for tree in stark_proof.sampled_values
        ]
        self.fri_proof = FriProofVar(cs, stark_proof.fri_proof)
        nonce = stark_proof.proof_of_work
        self.proof_of_work = [
            M31Var.new_witness(cs, nonce & ((1 << 22) - 1)),
            M31Var.new_witness(cs, (nonce >> 22) & ((1 << 21) - 1)),
            M31Var.new_witness(cs, (nonce >> 43) & ((1 << 21) - 1)),
        ]


class ProofVar:
    """PlonkWithPoseidonProofVar (lib.rs:92-122)."""

    def __init__(self, cs, proof):
        self.cs = cs
        self.stmt0 = Statement0Var(
            cs, proof.log_size_plonk, proof.log_size_poseidon
        )
        self.stmt1 = Statement1Var(
            cs, proof.plonk_total_sum, proof.poseidon_total_sum
        )
        self.stark_proof = StarkProofVar(cs, proof.stark_proof)

    def sampled_values_flattened(self) -> List[QM31Var]:
        return [
            s
            for tree in self.stark_proof.sampled_values
            for col in tree
            for s in col
        ]


class LookupElementsVar:
    """z, alpha, alpha^0..2 (lib.rs:226-268)."""

    def __init__(self, cs, z: QM31Var, alpha: QM31Var):
        self.cs = cs
        self.z = z
        self.alpha = alpha
        self.alpha_powers = [QM31Var.one(cs), alpha, alpha * alpha]

    @classmethod
    def draw(cls, channel) -> "LookupElementsVar":
        z, alpha = channel.draw_felts()
        return cls(z.cs, z, alpha)

    def combine(self, values: List[QM31Var]) -> QM31Var:
        """sum alpha^i * values[i] - z (the logup denominator)."""
        denom = self.alpha_powers[0] * values[0]
        for ap, v in zip(self.alpha_powers[1:], values[1:]):
            denom = denom + (ap * v)
        return denom - self.z


class SinglePathMerkleProofVar:
    """Commitment-tree Merkle path for one query (lib.rs:271-356).

    hint: dict with 'sibling_hashes' (depth, 8) and 'columns'
    {log_size -> (n,) uint32} for this query; depth = tree max domain log.
    """

    def __init__(self, cs, depth: int, sibling_hashes, columns: Dict[int, np.ndarray]):
        self.cs = cs
        self.depth = depth
        self.sibling_hashes = [
            Poseidon2Half.new_single_use_witness_only(cs, _h_tuple(h))
            for h in sibling_hashes
        ]
        self.columns = {
            lvl: [M31Var.new_witness(cs, int(v)) for v in vals]
            for lvl, vals in columns.items()
        }

    def verify(self, root: Poseidon2Half, query: BitsVar) -> None:
        # the top level of every commitment tree carries columns
        cur = gmerkle.hash_m31_columns_get_rate(self.columns[self.depth])
        for i in range(self.depth):
            h = self.depth - i - 1
            if h in self.columns:
                column_hash = gmerkle.hash_m31_columns_get_capacity(
                    self.columns[h]
                )
                cur = gmerkle.hash_tree_with_column_hash_with_swap(
                    cur,
                    self.sibling_hashes[i],
                    query.value[i],
                    query.variables[i],
                    column_hash,
                )
            else:
                cur = gmerkle.hash_tree_with_swap(
                    cur, self.sibling_hashes[i], query.value[i], query.variables[i]
                )
        assert cur.value == root.value, "single-path walk does not reach root"
        cur.equalverify(root)


class SinglePairMerkleProofVar:
    """FRI-layer dual-track (self, sibling) walk (lib.rs:358-464)."""

    def __init__(
        self,
        cs,
        depth: int,
        sibling_hashes,
        self_columns: Dict[int, tuple],
        siblings_columns: Dict[int, tuple],
    ):
        self.cs = cs
        self.depth = depth
        self.sibling_hashes = [
            Poseidon2Half.new_single_use_witness_only(cs, _h_tuple(h))
            for h in sibling_hashes
        ]
        self.self_columns = {
            lvl: QM31Var.new_witness(cs, _q_tuple(v))
            for lvl, v in self_columns.items()
        }
        self.siblings_columns = {
            lvl: QM31Var.new_witness(cs, _q_tuple(v))
            for lvl, v in siblings_columns.items()
        }

    def verify(self, root: Poseidon2Half, query: BitsVar) -> None:
        cs = self.cs
        zero = QM31Var.zero(cs)
        self_hash = gmerkle.hash_qm31_columns_get_rate(
            [self.self_columns[self.depth], zero]
        )
        sibling_hash = gmerkle.hash_qm31_columns_get_rate(
            [self.siblings_columns[self.depth], zero]
        )
        for i in range(self.depth):
            h = self.depth - i - 1
            if h not in self.self_columns:
                self_hash = gmerkle.hash_tree_with_swap(
                    self_hash, sibling_hash, query.value[i], query.variables[i]
                )
                if i != self.depth - 1:
                    sibling_hash = self.sibling_hashes[i]
            else:
                self_column_hash = gmerkle.hash_qm31_columns_get_capacity(
                    [self.self_columns[h], zero]
                )
                sibling_column_hash = gmerkle.hash_qm31_columns_get_capacity(
                    [self.siblings_columns[h], zero]
                )
                self_hash = gmerkle.hash_tree_with_column_hash_with_swap(
                    self_hash,
                    sibling_hash,
                    query.value[i],
                    query.variables[i],
                    self_column_hash,
                )
                sibling_hash = gmerkle.combine_hash_tree_with_column(
                    self.sibling_hashes[i], sibling_column_hash
                )
        assert self_hash.value == root.value, "pair walk does not reach root"
        self_hash.equalverify(root)
