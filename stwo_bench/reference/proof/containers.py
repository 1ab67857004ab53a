"""Proof containers mirroring the reference proof object graph.

Shapes per the gadget allocators in
recursive-stwo components/recursive/data_structures/src/lib.rs:122-223.
All field elements are numpy uint32; QM31 values are (..., 4) arrays in
(a, b, c, d) limb order where the value is (a + b*i) + (c + d*i)*u.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class MerkleDecommitment:
    hash_witness: np.ndarray  # (n, 8) uint32
    column_witness: np.ndarray  # (n,) uint32


@dataclass
class FriLayerProof:
    fri_witness: np.ndarray  # (n, 4) uint32 QM31s
    decommitment: MerkleDecommitment
    commitment: np.ndarray  # (8,) uint32


@dataclass
class FriProof:
    first_layer: FriLayerProof
    inner_layers: List[FriLayerProof]
    last_layer_poly: np.ndarray  # (2**k, 4) uint32 QM31 coeffs
    last_layer_log_size: int


@dataclass
class StarkProof:
    commitments: np.ndarray  # (4, 8) uint32
    sampled_values: List[List[np.ndarray]]  # [tree][column] -> (n_masks, 4)
    decommitments: List[MerkleDecommitment]  # per tree
    queried_values: List[np.ndarray]  # per tree, flat (n,) uint32
    proof_of_work: int  # u64 nonce
    fri_proof: FriProof


@dataclass
class PlonkWithPoseidonProof:
    log_size_plonk: int
    log_size_poseidon: int
    plonk_total_sum: np.ndarray  # (4,) uint32
    poseidon_total_sum: np.ndarray  # (4,) uint32
    config: "PcsConfig"
    stark_proof: StarkProof


@dataclass(frozen=True)
class FriConfig:
    log_last_layer_degree_bound: int
    log_blowup_factor: int
    n_queries: int


@dataclass(frozen=True)
class PcsConfig:
    pow_bits: int
    fri_config: FriConfig
