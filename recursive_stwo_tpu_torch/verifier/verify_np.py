"""Batched verifier for PlonkWithoutPoseidon circle-STARK proofs on the
Poseidon31 channel (the last-layer output system; native mirror of the stwo
fork's `verify_plonk_without_poseidon` consumed at
examples/last-layer/src/main.rs:188-202).

Twin of recursive_stwo_tpu/verifier/verify_np.py.  It runs on pa's device
and reuses verify.structural_checks (quotients, FRI folding, the hash
phase's scans); only the transcript layout, the total-sum statement and the
composition AIR differ from verify_batch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from . import composition as composition_mod
from . import transcript
from .arrays import ProofArrays
from .transcript import _q_cols
from .verify import structural_checks, with_ok


def verify_batch_np(
    spec,
    pa: ProofArrays,
    inputs: Sequence[Tuple[int, Tuple[int, int, int, int]]] = (),
):
    fs, oods, _, pow_ok, total_sum_ok = transcript.replay(spec, pa, inputs)
    checks = {"pow": pow_ok, "total_sum": total_sum_ok}

    total_sum = _q_cols(pa.plonk_total_sum)
    checks["composition"] = composition_mod.composition_check_np(
        spec, pa.samples_flat, total_sum,
        (fs.z, fs.alpha), fs.random_coeff, oods,
    )

    checks.update(structural_checks(spec, pa, fs, oods))
    return with_ok(checks)
