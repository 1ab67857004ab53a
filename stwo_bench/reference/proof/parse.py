"""bincode (v1, fixed-int, little-endian) reader for PlonkWithPoseidonProof.

The reference serializes proofs with `bincode::serialize` (e.g.
recursive-stwo examples/single-proof/src/main.rs:105).  bincode v1 default
config: little-endian, fixed-width ints, u64 length prefixes for Vec, arrays
written element-wise with no prefix.

Struct graph (field order = Rust declaration order):
  PlonkWithPoseidonProof { stmt0{u32,u32}, stmt1{QM31,QM31}, stark_proof }
  StarkProof = CommitmentSchemeProof {
      commitments: TreeVec<Hash>, sampled_values: TreeVec<Vec<Vec<QM31>>>,
      decommitments: TreeVec<MerkleDecommitment>,
      queried_values: TreeVec<Vec<M31>>, proof_of_work: u64,
      fri_proof: FriProof }
  FriProof { first_layer, inner_layers: Vec<FriLayerProof>, last_layer_poly }
  FriLayerProof { fri_witness: Vec<QM31>, decommitment, commitment: Hash }
  MerkleDecommitment { hash_witness: Vec<Hash>, column_witness: Vec<M31> }
  LinePoly { coeffs: Vec<QM31>, log_size: u32 }
  Hash = Poseidon31Hash([M31; 8]);  M31/QM31 = u32 / 4x u32.
"""

from __future__ import annotations

import struct

import numpy as np

from .containers import (
    FriConfig,
    FriLayerProof,
    FriProof,
    MerkleDecommitment,
    PcsConfig,
    PlonkWithPoseidonProof,
    StarkProof,
)

P = 2147483647


class Reader:
    """A cursor over the bytes; hashes are Poseidon31Hash = [M31; 8]."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.data, self.pos)
        self.pos += 4
        return v

    def u64(self) -> int:
        (v,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return v

    def vec_len(self) -> int:
        n = self.u64()
        assert n < 1 << 32, f"implausible vec len {n} at {self.pos - 8}"
        return n

    def u32_array(self, n: int) -> np.ndarray:
        arr = np.frombuffer(self.data, dtype="<u4", count=n, offset=self.pos).astype(
            np.uint32
        )
        self.pos += 4 * n
        return arr

    def m31_array(self, n: int) -> np.ndarray:
        arr = self.u32_array(n)
        assert (arr < P).all(), "non-canonical M31 in proof"
        return arr

    def hash8(self) -> np.ndarray:
        return self.m31_array(8)

    def hash_array(self, n: int) -> np.ndarray:
        return self.m31_array(8 * n).reshape(n, 8)

    def qm31_vec(self) -> np.ndarray:
        n = self.vec_len()
        return self.m31_array(4 * n).reshape(n, 4)

    def done(self) -> bool:
        return self.pos == len(self.data)


def _read_merkle_decommitment(r: Reader) -> MerkleDecommitment:
    n_hash = r.vec_len()
    hash_witness = r.hash_array(n_hash)
    n_col = r.vec_len()
    column_witness = r.m31_array(n_col)
    return MerkleDecommitment(hash_witness, column_witness)


def _read_fri_layer(r: Reader) -> FriLayerProof:
    fri_witness = r.qm31_vec()
    decommitment = _read_merkle_decommitment(r)
    commitment = r.hash8()
    return FriLayerProof(fri_witness, decommitment, commitment)


def parse_plonk_with_poseidon_proof(data: bytes) -> PlonkWithPoseidonProof:
    r = Reader(data)

    log_size_plonk = r.u32()
    log_size_poseidon = r.u32()
    assert 1 <= log_size_plonk < 32 and 1 <= log_size_poseidon < 32, (
        log_size_plonk,
        log_size_poseidon,
    )
    plonk_total_sum = r.m31_array(4)
    poseidon_total_sum = r.m31_array(4)

    config, stark_proof = _read_config_and_stark(r)
    assert r.done(), f"{len(data) - r.pos} trailing bytes"

    return PlonkWithPoseidonProof(
        log_size_plonk=log_size_plonk,
        log_size_poseidon=log_size_poseidon,
        plonk_total_sum=plonk_total_sum,
        poseidon_total_sum=poseidon_total_sum,
        config=config,
        stark_proof=stark_proof,
    )


def _read_config_and_stark(r: Reader):
    # CommitmentSchemeProof.config: PcsConfig { pow_bits, FriConfig {
    #   log_blowup_factor, log_last_layer_degree_bound, n_queries: u64 } }
    pow_bits = r.u32()
    log_blowup_factor = r.u32()
    log_last_layer_degree_bound = r.u32()
    n_queries = r.u64()
    config = PcsConfig(
        pow_bits=pow_bits,
        fri_config=FriConfig(
            log_last_layer_degree_bound=log_last_layer_degree_bound,
            log_blowup_factor=log_blowup_factor,
            n_queries=n_queries,
        ),
    )

    n_trees = r.vec_len()
    assert n_trees == 4, n_trees
    commitments = r.hash_array(n_trees)

    n_trees2 = r.vec_len()
    assert n_trees2 == 4
    sampled_values = []
    for _ in range(n_trees2):
        n_cols = r.vec_len()
        tree = [r.qm31_vec() for _ in range(n_cols)]
        sampled_values.append(tree)

    n_trees3 = r.vec_len()
    assert n_trees3 == 4
    decommitments = [_read_merkle_decommitment(r) for _ in range(n_trees3)]

    n_trees4 = r.vec_len()
    assert n_trees4 == 4
    queried_values = []
    for _ in range(n_trees4):
        n = r.vec_len()
        queried_values.append(r.m31_array(n))

    proof_of_work = r.u64()

    first_layer = _read_fri_layer(r)
    n_inner = r.vec_len()
    inner_layers = [_read_fri_layer(r) for _ in range(n_inner)]
    last_layer_poly = r.qm31_vec()
    last_layer_log_size = r.u32()
    assert 1 << last_layer_log_size == len(last_layer_poly), (
        last_layer_log_size,
        len(last_layer_poly),
    )

    return config, StarkProof(
        commitments=commitments,
        sampled_values=sampled_values,
        decommitments=decommitments,
        queried_values=queried_values,
        proof_of_work=proof_of_work,
        fri_proof=FriProof(
            first_layer=first_layer,
            inner_layers=inner_layers,
            last_layer_poly=last_layer_poly,
            last_layer_log_size=last_layer_log_size,
        ),
    )
