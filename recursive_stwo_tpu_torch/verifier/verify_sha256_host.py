"""Native verifier for Sha256Poseidon31-flavor PlonkWithPoseidon proofs
(framework-defined SHA-256 channel + SHA-256 Merkle trees; see
prover/prove_sha256.py), and for Sha256MerkleChannel-flavor
PlonkWithoutPoseidon proofs (the bitcoin-facing output proof).

The host half of recursive_stwo_tpu/verifier/verify_sha256.py: `_q1`, the
SHA-256 transcript replays, the full host verifiers and the numpy public-
input sum, copied.  The port keeps no numpy copy of the AIR evaluation, so
the host verifiers' composition check runs the port's torch composition on
the CPU (`composition_on`), which the fast paths of verify_sha256.py run on
a chosen device.

Checks: SHA-256 transcript replay, PoW, logup total-sum, composition
identity at the OODS point, and — via `hints.prepare` with the SHA-256
node hash, whose path expansion asserts root equality and replays every
FRI fold down to the last-layer polynomial — all four commitment-tree
decommitments and the FRI chain."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import m31_host as m31
from ..core import qm31_host as q
from ..core.qm31_host import QM31
from . import composition as composition_mod
from . import hints as hints_mod
from . import points, sha256_merkle
from .arrays import from_proofs_np
from .spec import NoPoseidonVerifierSpec, VerifierSpec
from .transcript_host import FSOutput


def _q1(felt4) -> QM31:
    return QM31(*(np.array([int(x)], np.uint32) for x in felt4))


def run_transcript_sha256p31(spec: VerifierSpec, proof) -> FSOutput:
    """Replay the prover's channel interactions (prover/prove.py host flow)
    over the SHA-256 channel; returns a batch-1 FSOutput."""
    from ..prover.prove_sha256 import Sha256ProverChannel

    ch = Sha256ProverChannel()
    sp = proof.stark_proof

    ch.mix_root(sp.commitments[0])
    ch.mix_one_felt([spec.log_size_plonk, 0, 0, 0])
    ch.mix_one_felt([spec.log_size_poseidon, 0, 0, 0])
    ch.mix_root(sp.commitments[1])
    z4, alpha4 = ch.draw_felts()
    ch.mix_two_felts(proof.plonk_total_sum, proof.poseidon_total_sum)
    ch.mix_root(sp.commitments[2])
    rc4 = ch.draw_felt()
    ch.mix_root(sp.commitments[3])
    oods_t4 = ch.draw_felt()

    flat = [s for tree in sp.sampled_values for col in tree for s in col]
    for k in range(0, len(flat), 2):
        chunk = flat[k : k + 2]
        if len(chunk) == 1:
            ch.mix_one_felt(chunk[0])
        else:
            ch.mix_two_felts(chunk[0], chunk[1])
    after4 = ch.draw_felt()

    alphas = []
    ch.mix_root(sp.fri_proof.first_layer.commitment)
    alphas.append(ch.draw_felt())
    for layer in sp.fri_proof.inner_layers:
        ch.mix_root(layer.commitment)
        alphas.append(ch.draw_felt())

    last_poly = sp.fri_proof.last_layer_poly
    for k in range(0, len(last_poly), 2):
        chunk = last_poly[k : k + 2]
        if len(chunk) == 1:
            ch.mix_one_felt(chunk[0])
        else:
            ch.mix_two_felts(chunk[0], chunk[1])

    ch.mix_u64(sp.proof_of_work)
    pow_digest0 = np.array(
        [int.from_bytes(ch.ch.digest[:4], "little")], np.uint32
    )

    raw = []
    while len(raw) < spec.n_queries:
        a, b = ch.draw_felts()
        raw.extend(int(x) for x in a)
        raw.extend(int(x) for x in b)
    raw_queries = np.array([raw[: spec.n_queries]], np.uint32)

    return FSOutput(
        z=_q1(z4),
        alpha=_q1(alpha4),
        random_coeff=_q1(rc4),
        oods_t=_q1(oods_t4),
        after_sampled_values_random_coeff=_q1(after4),
        fri_alphas=tuple(_q1(a) for a in alphas),
        raw_queries=raw_queries,
        pow_digest0=pow_digest0,
    )


def composition_on(spec, samples_flat, sums, fs: FSOutput, device) -> torch.Tensor:
    """The composition check of numpy proof data on `device`, through the
    port's torch composition: `sums` is (plonk, poseidon) total sums for the
    PlonkWithPoseidon AIR and (total,) for the PlonkWithoutPoseidon AIR
    (told apart by the spec).  Returns a (B,) bool tensor on `device`."""

    def t(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)

    def tq(x: QM31) -> QM31:
        return QM31(*(t(c) for c in x))

    lookup = (tq(fs.z), tq(fs.alpha))
    oods = points.oods_point_from_t(tq(fs.oods_t))
    sums = tuple(tq(s) for s in sums)
    if isinstance(spec, NoPoseidonVerifierSpec):
        return composition_mod.composition_check_np(
            spec, t(samples_flat), *sums, lookup, tq(fs.random_coeff), oods
        )
    return composition_mod.composition_check(
        spec, t(samples_flat), *sums, lookup, tq(fs.random_coeff), oods
    )


def _samples_flat(proof) -> np.ndarray:
    return np.array(
        [
            [tuple(int(x) for x in s) for tree in proof.stark_proof.sampled_values
             for col in tree for s in col]
        ],
        np.uint32,
    )


def verify_sha256p31_host(
    proof,
    inputs: Sequence[Tuple[int, Tuple[int, int, int, int]]] = (),
):
    """Full host verification of one Sha256Poseidon31-flavor proof.
    Returns the same named-checks dict shape as verify.verify_batch
    (all arrays are batch-1)."""
    spec = VerifierSpec.from_proof(proof)
    fs = run_transcript_sha256p31(spec, proof)

    # Merkle decommitments (all 4 trees + FRI layers) and the complete
    # FRI fold replay happen inside prepare(); every mismatch raises.
    try:
        pa = hints_mod.prepare(
            spec,
            [proof],
            transcript_fn=lambda s, p: fs,
            hash_node_fn=sha256_merkle.hash_node,
        )
        structural_ok = True
    except AssertionError:
        pa = None
        structural_ok = False

    checks = {}
    checks["pow"] = (
        fs.pow_digest0 & np.uint32((1 << spec.pow_bits) - 1)
    ) == 0

    total = q.q_add(
        q.q_add(_input_sum(fs, inputs), _q1(proof.plonk_total_sum)),
        _q1(proof.poseidon_total_sum),
    )
    checks["total_sum"] = (
        (total.a == 0) & (total.b == 0) & (total.c == 0) & (total.d == 0)
    )

    checks["composition"] = composition_on(
        spec, _samples_flat(proof),
        (_q1(proof.plonk_total_sum), _q1(proof.poseidon_total_sum)), fs, "cpu",
    ).numpy()

    checks["merkle_fri"] = np.array([structural_ok])

    ok = None
    for v in checks.values():
        v = np.asarray(v).reshape(1)
        ok = v if ok is None else (ok & v)
    checks["ok"] = ok
    return checks


# ---------------------------------------------------------------------------
# PlonkWithoutPoseidon flavor (the Sha256MerkleChannel output proof — the
# reference's bitcoin_proof.bin step, examples/last-layer/src/main.rs:194-202)
# ---------------------------------------------------------------------------


def run_transcript_sha256np(spec, proof) -> FSOutput:
    """Replay prove_np's channel interactions over the SHA-256 channel."""
    from ..prover.prove_sha256 import Sha256ProverChannel

    ch = Sha256ProverChannel()
    sp = proof.stark_proof

    ch.mix_root(sp.commitments[0])
    ch.mix_one_felt([spec.log_size, 0, 0, 0])
    ch.mix_root(sp.commitments[1])
    z4, alpha4 = ch.draw_felts()
    ch.mix_one_felt(proof.total_sum)
    ch.mix_root(sp.commitments[2])
    rc4 = ch.draw_felt()
    ch.mix_root(sp.commitments[3])
    oods_t4 = ch.draw_felt()

    flat = [s for tree in sp.sampled_values for col in tree for s in col]
    for k in range(0, len(flat), 2):
        chunk = flat[k : k + 2]
        if len(chunk) == 1:
            ch.mix_one_felt(chunk[0])
        else:
            ch.mix_two_felts(chunk[0], chunk[1])
    after4 = ch.draw_felt()

    alphas = []
    ch.mix_root(sp.fri_proof.first_layer.commitment)
    alphas.append(ch.draw_felt())
    for layer in sp.fri_proof.inner_layers:
        ch.mix_root(layer.commitment)
        alphas.append(ch.draw_felt())

    last_poly = sp.fri_proof.last_layer_poly
    for k in range(0, len(last_poly), 2):
        chunk = last_poly[k : k + 2]
        if len(chunk) == 1:
            ch.mix_one_felt(chunk[0])
        else:
            ch.mix_two_felts(chunk[0], chunk[1])

    ch.mix_u64(sp.proof_of_work)
    pow_digest0 = np.array(
        [int.from_bytes(ch.ch.digest[:4], "little")], np.uint32
    )

    raw = []
    while len(raw) < spec.n_queries:
        a, b = ch.draw_felts()
        raw.extend(int(x) for x in a)
        raw.extend(int(x) for x in b)
    raw_queries = np.array([raw[: spec.n_queries]], np.uint32)

    return FSOutput(
        z=_q1(z4),
        alpha=_q1(alpha4),
        random_coeff=_q1(rc4),
        oods_t=_q1(oods_t4),
        after_sampled_values_random_coeff=_q1(after4),
        fri_alphas=tuple(_q1(a) for a in alphas),
        raw_queries=raw_queries,
        pow_digest0=pow_digest0,
    )


def verify_sha256np_host(
    proof,
    inputs: Sequence[Tuple[int, Tuple[int, int, int, int]]] = (),
):
    """Full host verification of one Sha256MerkleChannel-flavor
    PlonkWithoutPoseidon proof (native mirror of the reference's
    verify_plonk_without_poseidon::<Sha256MerkleChannel>)."""
    spec = NoPoseidonVerifierSpec.for_rows(proof.log_size, proof.config)
    spec.validate(proof)
    fs = run_transcript_sha256np(spec, proof)

    try:
        hints_mod.prepare(
            spec,
            [proof],
            arrays_fn=from_proofs_np,
            transcript_fn=lambda s, p: fs,
            hash_node_fn=sha256_merkle.hash_node,
        )
        structural_ok = True
    except AssertionError:
        structural_ok = False

    checks = {}
    checks["pow"] = (
        fs.pow_digest0 & np.uint32((1 << spec.pow_bits) - 1)
    ) == 0

    total = q.q_add(_input_sum(fs, inputs), _q1(proof.total_sum))
    checks["total_sum"] = (
        (total.a == 0) & (total.b == 0) & (total.c == 0) & (total.d == 0)
    )

    checks["composition"] = composition_on(
        spec, _samples_flat(proof), (_q1(proof.total_sum),), fs, "cpu"
    ).numpy()

    checks["merkle_fri"] = np.array([structural_ok])

    ok = None
    for v in checks.values():
        v = np.asarray(v).reshape(1)
        ok = v if ok is None else (ok & v)
    checks["ok"] = ok
    return checks


def _input_sum(fs, inputs):
    """sum_i 1/((val_i + alpha*idx_i) - z), batched: one q_inv over the
    stacked (n_inputs, B) terms instead of one per input (the bitcoin
    proof has 264 public inputs)."""
    like = fs.z.a
    if not inputs:
        return q.q_zero(like)
    idxs = np.array([i for i, _ in inputs], np.uint32)[:, None]
    vals = np.array([v for _, v in inputs], np.uint32)
    term = QM31(
        *(
            m31.sub(
                m31.add(
                    vals[:, k : k + 1],
                    m31.mul(fs.alpha[k][None, :], idxs),
                ),
                fs.z[k][None, :],
            )
            for k in range(4)
        )
    )
    inv = q.q_inv(term)  # (n, B)
    comps = []
    for c in inv:
        acc = c
        while acc.shape[0] > 1:
            half = acc.shape[0] // 2
            lo = m31.add(acc[:half], acc[half : 2 * half])
            if acc.shape[0] % 2:
                lo = np.concatenate([lo, acc[-1:]], axis=0)
            acc = lo
        comps.append(acc[0])
    return QM31(*comps)
