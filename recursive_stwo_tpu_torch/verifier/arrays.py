"""The verifier's batched proof tensors, on the host and on a torch device.

`ProofArrays`, `TreePaths`, `PairPaths` and `from_proofs` are copied from
recursive_stwo_tpu/verifier/arrays.py: the host builds them in numpy
(`hints.prepare`), and `to_torch` moves every array to int64 on a device.
`carry_across` rebuilds these containers from any object with the same
fields (the JAX package's, in the parity tests).  The dicts of column
openings keep their insertion order, which the hash phase relies on.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..proof.containers import PlonkWithPoseidonProof
from .spec import VerifierSpec


class TreePaths(NamedTuple):
    """Per-commitment-tree decommitment, expanded to per-query paths."""

    sibling_hashes: object  # (B, Q, depth, 8)
    # column openings per domain log size present in this tree:
    # dict log_size -> (B, Q, n_cols) uint32
    columns: dict


class PairPaths(NamedTuple):
    """FRI-layer pair decommitment (self + sibling values, shared hashes)."""

    sibling_hashes: object  # (B, Q, depth-1, 8)
    self_columns: dict  # log_size -> (B, Q, 4)
    sibling_columns: dict  # log_size -> (B, Q, 4)


class ProofArrays(NamedTuple):
    commitments: object  # (B, 4, 8)
    plonk_total_sum: object  # (B, 4)
    poseidon_total_sum: object  # (B, 4)
    samples_flat: object  # (B, S, 4) flattened sampled values
    first_layer_commitment: object  # (B, 8)
    inner_commitments: object  # (B, n_inner, 8)
    last_poly: object  # (B, L, 4)
    nonce_limbs: object  # (B, 3) 22/21/21 split
    tree_paths: Optional[tuple] = None  # 4x TreePaths
    first_layer_paths: Optional[PairPaths] = None
    inner_layer_paths: Optional[tuple] = None  # n_inner x PairPaths


def split_nonce(nonce: int) -> np.ndarray:
    return np.array(
        [
            nonce & ((1 << 22) - 1),
            (nonce >> 22) & ((1 << 21) - 1),
            (nonce >> 43) & ((1 << 21) - 1),
        ],
        dtype=np.uint32,
    )


def flatten_samples(spec: VerifierSpec, proof: PlonkWithPoseidonProof) -> np.ndarray:
    out = np.empty((spec.total_samples, 4), np.uint32)
    pos = 0
    for tree in proof.stark_proof.sampled_values:
        for col in tree:
            n = len(col)
            out[pos : pos + n] = col
            pos += n
    assert pos == spec.total_samples
    return out


def from_proofs_np(spec, proofs) -> ProofArrays:
    """PlonkWithoutPoseidonProof batch -> ProofArrays (total_sum rides the
    plonk_total_sum slot; the poseidon slot is zero and unused)."""
    B = len(proofs)
    return ProofArrays(
        commitments=np.stack([p.stark_proof.commitments for p in proofs]),
        plonk_total_sum=np.stack([p.total_sum for p in proofs]),
        poseidon_total_sum=np.zeros((B, 4), np.uint32),
        samples_flat=np.stack([flatten_samples(spec, p) for p in proofs]),
        first_layer_commitment=np.stack(
            [p.stark_proof.fri_proof.first_layer.commitment for p in proofs]
        ),
        inner_commitments=np.stack(
            [
                np.stack([l.commitment for l in p.stark_proof.fri_proof.inner_layers])
                for p in proofs
            ]
        ),
        last_poly=np.stack([p.stark_proof.fri_proof.last_layer_poly for p in proofs]),
        nonce_limbs=np.stack(
            [split_nonce(p.stark_proof.proof_of_work) for p in proofs]
        ),
    )


def from_proofs(
    spec: VerifierSpec, proofs: List[PlonkWithPoseidonProof]
) -> ProofArrays:
    """Stack parsed proofs into batch tensors (without decommit paths)."""
    return ProofArrays(
        commitments=np.stack([p.stark_proof.commitments for p in proofs]),
        plonk_total_sum=np.stack([p.plonk_total_sum for p in proofs]),
        poseidon_total_sum=np.stack([p.poseidon_total_sum for p in proofs]),
        samples_flat=np.stack([flatten_samples(spec, p) for p in proofs]),
        first_layer_commitment=np.stack(
            [p.stark_proof.fri_proof.first_layer.commitment for p in proofs]
        ),
        inner_commitments=np.stack(
            [
                np.stack([l.commitment for l in p.stark_proof.fri_proof.inner_layers])
                for p in proofs
            ]
        ),
        last_poly=np.stack([p.stark_proof.fri_proof.last_layer_poly for p in proofs]),
        nonce_limbs=np.stack(
            [split_nonce(p.stark_proof.proof_of_work) for p in proofs]
        ),
    )


_PATH_FIELDS = ("tree_paths", "first_layer_paths", "inner_layer_paths")


def map_arrays(fn, pa: ProofArrays) -> ProofArrays:
    """Apply fn to every array of pa, keeping the structure and dict order."""

    def cols(d):
        return {k: fn(v) for k, v in d.items()}

    def pair(pp):
        return PairPaths(fn(pp.sibling_hashes), cols(pp.self_columns), cols(pp.sibling_columns))

    return ProofArrays(
        **{name: fn(getattr(pa, name)) for name in ProofArrays._fields if name not in _PATH_FIELDS},
        tree_paths=tuple(TreePaths(fn(tp.sibling_hashes), cols(tp.columns)) for tp in pa.tree_paths),
        first_layer_paths=pair(pa.first_layer_paths),
        inner_layer_paths=tuple(pair(p) for p in pa.inner_layer_paths),
    )


def require_device(device) -> torch.device:
    """`device` as a torch.device; 'cuda' without a CUDA device raises
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is false")
    return device


def to_torch(pa: ProofArrays, device) -> ProofArrays:
    """numpy uint32 ProofArrays -> the same structure of int64 tensors."""
    return map_arrays(
        lambda x: torch.from_numpy(np.asarray(x).astype(np.int64)).to(device), pa
    )


def carry_across(pa) -> ProofArrays:
    """These containers, with numpy arrays, from any object that has
    ProofArrays' fields (the JAX package's ProofArrays among them)."""
    return map_arrays(np.asarray, pa)
