"""bincode (v1, fixed-int, little-endian) writer for PlonkWithPoseidonProof.

Exact inverse of proof/parse.py: parse(serialize(p)) == p and
serialize(parse(bytes)) == bytes for every fixture.  Mirrors the
reference's `bincode::serialize(&proof)` output
(/root/reference/examples/single-proof/src/main.rs:100-105), so chain
artifacts can be written as `.bin` files consumable by the reference
tooling alongside the framework's own `.pkl` memoization.
"""

from __future__ import annotations

import struct

import numpy as np

from .containers import (
    FriLayerProof,
    MerkleDecommitment,
    PlonkWithPoseidonProof,
)


class Writer:
    def __init__(self, hash_mode: str = "m31x8"):
        assert hash_mode in ("m31x8", "bytes32"), hash_mode
        self.hash_mode = hash_mode
        self.parts: list[bytes] = []

    def u32(self, v: int):
        self.parts.append(struct.pack("<I", int(v)))

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", int(v)))

    def u32_array(self, arr: np.ndarray):
        self.parts.append(
            np.ascontiguousarray(arr, dtype="<u4").tobytes()
        )

    def hash8(self, h: np.ndarray):
        h = np.asarray(h)
        if self.hash_mode == "bytes32":
            if h.dtype == np.uint8:
                assert h.size == 32
                self.parts.append(h.tobytes())
            else:
                # SHA-256 digests held as 8 uint32 words (the framework's
                # sha flavor, verifier/sha256_merkle.py) -> 32 big-endian
                # bytes, the reference's on-disk convention
                assert h.size == 8
                self.parts.append(
                    np.ascontiguousarray(h, dtype=">u4").tobytes()
                )
        else:
            assert h.size == 8
            self.u32_array(h)

    def hash_array(self, hs: np.ndarray):
        for h in np.asarray(hs):
            self.hash8(h)

    def qm31_vec(self, rows: np.ndarray):
        rows = np.asarray(rows, np.uint32).reshape(-1, 4)
        self.u64(rows.shape[0])
        self.u32_array(rows)

    def bytes_out(self) -> bytes:
        return b"".join(self.parts)


def _write_merkle_decommitment(w: Writer, d: MerkleDecommitment):
    w.u64(len(d.hash_witness))
    w.hash_array(d.hash_witness)
    w.u64(len(d.column_witness))
    w.u32_array(d.column_witness)


def _write_fri_layer(w: Writer, layer: FriLayerProof):
    w.qm31_vec(layer.fri_witness)
    _write_merkle_decommitment(w, layer.decommitment)
    w.hash8(layer.commitment)


def serialize_plonk_with_poseidon_proof(
    proof: PlonkWithPoseidonProof, hash_mode: str = "m31x8"
) -> bytes:
    w = Writer(hash_mode)
    w.u32(proof.log_size_plonk)
    w.u32(proof.log_size_poseidon)
    w.u32_array(np.asarray(proof.plonk_total_sum, np.uint32).reshape(4))
    w.u32_array(np.asarray(proof.poseidon_total_sum, np.uint32).reshape(4))
    _write_stark_proof(w, proof.config, proof.stark_proof)
    return w.bytes_out()


def serialize_plonk_without_poseidon_proof(
    proof, hash_mode: str = "m31x8"
) -> bytes:
    """Bincode writer for the single-table last-layer proof (the
    reference's bitcoin_proof.bin, last-layer/src/main.rs:196-200):
    stmt0 { log_size }, stmt1 { total_sum }, then the same
    CommitmentSchemeProof layout as the with-poseidon flavor."""
    w = Writer(hash_mode)
    w.u32(proof.log_size)
    w.u32_array(np.asarray(proof.total_sum, np.uint32).reshape(4))
    _write_stark_proof(w, proof.config, proof.stark_proof)
    return w.bytes_out()


def _write_stark_proof(w: Writer, config, sp):
    w.u32(config.pow_bits)
    w.u32(config.fri_config.log_blowup_factor)
    w.u32(config.fri_config.log_last_layer_degree_bound)
    w.u64(config.fri_config.n_queries)
    w.u64(len(sp.commitments))
    w.hash_array(sp.commitments)

    w.u64(len(sp.sampled_values))
    for tree in sp.sampled_values:
        w.u64(len(tree))
        for col in tree:
            w.qm31_vec(col)

    w.u64(len(sp.decommitments))
    for d in sp.decommitments:
        _write_merkle_decommitment(w, d)

    w.u64(len(sp.queried_values))
    for vals in sp.queried_values:
        vals = np.asarray(vals, np.uint32).ravel()
        w.u64(len(vals))
        w.u32_array(vals)

    w.u64(sp.proof_of_work)

    fp = sp.fri_proof
    _write_fri_layer(w, fp.first_layer)
    w.u64(len(fp.inner_layers))
    for layer in fp.inner_layers:
        _write_fri_layer(w, layer)
    w.qm31_vec(fp.last_layer_poly)
    w.u32(fp.last_layer_log_size)
