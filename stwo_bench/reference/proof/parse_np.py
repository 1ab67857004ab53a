"""bincode (v1) reader for a PlonkWithoutPoseidonProof in the
Sha256MerkleChannel flavour (the bitcoin-facing proof,
recursive-stwo examples/last-layer/src/main.rs:196-200).

The layout is parse.py's after the statement: stmt0 { log_size: u32 },
stmt1 { total_sum: QM31 }, then the same CommitmentSchemeProof, read by
parse.py's own reader, except that every hash (the four roots, each
decommitment's hash witness, each FRI layer's root) is a SHA-256 digest of
32 raw bytes.  A digest is held as its 8 big-endian 32-bit words, (8,)
uint32, the shape parse.py gives a Poseidon31 hash.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .containers import PcsConfig, StarkProof
from .parse import Reader, _read_config_and_stark


@dataclass
class PlonkWithoutPoseidonProof:
    log_size: int
    total_sum: np.ndarray  # (4,) uint32
    config: PcsConfig
    stark_proof: StarkProof


class Sha256Reader(Reader):
    """parse.Reader with SHA-256 digests for hashes."""

    def hash8(self) -> np.ndarray:
        return self.hash_array(1)[0]

    def hash_array(self, n: int) -> np.ndarray:
        words = np.frombuffer(self.data, dtype=">u4", count=8 * n, offset=self.pos).astype(np.uint32)
        self.pos += 32 * n
        return words.reshape(n, 8)


def parse_plonk_without_poseidon_proof(data: bytes) -> PlonkWithoutPoseidonProof:
    r = Sha256Reader(data)
    log_size = r.u32()
    if not 1 <= log_size < 32:
        raise ValueError(f"log size {log_size}")
    total_sum = r.m31_array(4)
    config, stark_proof = _read_config_and_stark(r)
    if not r.done():
        raise ValueError(f"{len(data) - r.pos} trailing bytes")
    return PlonkWithoutPoseidonProof(log_size=log_size, total_sum=total_sum, config=config, stark_proof=stark_proof)
