"""In-circuit Fiat-Shamir transcript replay
(reference: /root/reference/components/recursive/fiat_shamir/src/lib.rs).

Every mix/draw goes through the Poseidon accelerator; drawn values are
cross-checked against the native transcript replay
(`verifier.transcript.run_transcript`) exactly as the reference asserts
against its FiatShamirHints (lib.rs:143-160).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..cs import scalar
from ..gadgets.bits import BitsVar
from ..gadgets.channel import ChannelVar
from ..gadgets.circle import CirclePointQM31
from ..gadgets.fields import M31Var, QM31Var
from ..verifier.spec import VerifierSpec
from .data_structures import LookupElementsVar, ProofVar


def _fs_scalar(x, bi=0) -> tuple:
    return tuple(int(np.asarray(c).reshape(-1)[bi]) for c in x)


class FiatShamirResults:
    def __init__(self):
        self.preprocessed_commitment = None
        self.trace_commitment = None
        self.interaction_trace_commitment = None
        self.composition_commitment = None
        self.plonk_total_sum = None
        self.poseidon_total_sum = None
        self.lookup_elements = None
        self.random_coeff = None
        self.after_sampled_values_random_coeff = None
        self.oods_point = None
        self.raw_queries: List[M31Var] = []
        self.fri_alphas: List[QM31Var] = []

    @classmethod
    def compute(
        cls,
        spec: VerifierSpec,
        fs,  # native FSOutput (cross-check hints)
        proof: ProofVar,
        inputs,  # [(idx, QM31Var)]
    ) -> "FiatShamirResults":
        cs = proof.cs
        res = cls()

        res.preprocessed_commitment = proof.stark_proof.commitments[0]
        res.trace_commitment = proof.stark_proof.commitments[1]
        res.interaction_trace_commitment = proof.stark_proof.commitments[2]
        res.composition_commitment = proof.stark_proof.commitments[3]

        channel = ChannelVar(cs)

        channel.mix_root(res.preprocessed_commitment)
        proof.stmt0.mix_into(channel)
        channel.mix_root(res.trace_commitment)

        res.lookup_elements = LookupElementsVar.draw(channel)

        proof.stmt1.mix_into(channel)
        channel.mix_root(res.interaction_trace_commitment)

        res.random_coeff = channel.draw_felts()[0]

        channel.mix_root(res.composition_commitment)

        res.oods_point = CirclePointQM31.from_channel(channel)

        flat = proof.sampled_values_flattened()
        for k in range(0, len(flat), 2):
            chunk = flat[k : k + 2]
            if len(chunk) == 1:
                channel.mix_one_felt(chunk[0])
            else:
                channel.mix_two_felts(chunk[0], chunk[1])

        res.after_sampled_values_random_coeff = channel.draw_felts()[0]

        channel.mix_root(proof.stark_proof.fri_proof.first_layer_commitment)
        res.fri_alphas.append(channel.draw_felts()[0])
        for commitment in proof.stark_proof.fri_proof.inner_layer_commitments:
            channel.mix_root(commitment)
            res.fri_alphas.append(channel.draw_felts()[0])

        coeffs = proof.stark_proof.fri_proof.last_poly.coeffs
        for k in range(0, len(coeffs), 2):
            chunk = coeffs[k : k + 2]
            if len(chunk) == 1:
                channel.mix_one_felt(chunk[0])
            else:
                channel.mix_two_felts(chunk[0], chunk[1])

        pow_limbs = proof.stark_proof.proof_of_work
        nonce_felt = QM31Var.from_m31(
            pow_limbs[0], pow_limbs[1], pow_limbs[2], M31Var.zero(cs)
        )
        BitsVar.from_m31(pow_limbs[0], 22)
        BitsVar.from_m31(pow_limbs[1], 21)
        BitsVar.from_m31(pow_limbs[2], 21)

        channel.mix_one_felt(nonce_felt)

        lower_bits = BitsVar.from_m31(
            channel.digest.to_qm31()[0].decompose_m31()[0], 31
        ).compose_range(0, spec.pow_bits)
        lower_bits.equalverify(M31Var.zero(cs))

        n_draws = -(-spec.n_queries // 4)  # ceil over felts, 2 per draw
        felts = []
        for _ in range(-(-spec.n_queries // 8)):
            a, b = channel.draw_felts()
            felts.extend([a, b])
        raw_queries: List[M31Var] = []
        for felt in felts:
            raw_queries.extend(felt.decompose_m31())
        del n_draws
        res.raw_queries = raw_queries[: spec.n_queries]

        # total-sum constraint (lib.rs:133-141)
        input_sum = QM31Var.zero(cs)
        for idx, v in inputs:
            term = (
                v
                + (
                    QM31Var.new_constant(cs, (idx, 0, 0, 0))
                    * res.lookup_elements.alpha
                )
            ) - res.lookup_elements.z
            input_sum = input_sum + term.inv()
        (
            (input_sum + proof.stmt1.poseidon_total_sum)
            + proof.stmt1.plonk_total_sum
        ).equalverify(QM31Var.zero(cs))

        # cross-check against the native transcript (lib.rs:143-160)
        assert res.lookup_elements.z.value == _fs_scalar(fs.z)
        assert res.lookup_elements.alpha.value == _fs_scalar(fs.alpha)
        assert res.random_coeff.value == _fs_scalar(fs.random_coeff)
        assert res.after_sampled_values_random_coeff.value == _fs_scalar(
            fs.after_sampled_values_random_coeff
        )
        oods_t = _fs_scalar(fs.oods_t)
        t2 = scalar.q_mul(oods_t, oods_t)
        t2p1_inv = scalar.q_inv(scalar.q_add(t2, scalar.QONE))
        expect_x = scalar.q_mul(scalar.q_sub(scalar.QONE, t2), t2p1_inv)
        expect_y = scalar.q_mul(scalar.q_add(oods_t, oods_t), t2p1_inv)
        assert res.oods_point.x.value == expect_x
        assert res.oods_point.y.value == expect_y
        for var, native in zip(res.fri_alphas, fs.fri_alphas):
            assert var.value == _fs_scalar(native)
        for var, native in zip(
            res.raw_queries, np.asarray(fs.raw_queries)[0]
        ):
            assert var.value == int(native)

        return res
