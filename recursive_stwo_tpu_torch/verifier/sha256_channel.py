"""SHA-256 Fiat-Shamir channel for the Sha256Poseidon31MerkleChannel proofs.

The stwo fork's `Sha256Channel` sources are not vendored in the reference repository
(external git dep, Cargo.toml:18-20), so the semantics here were
reconstructed from the generic call sites the reference DOES contain
(components/hints/src/fiat_shamir.rs:68-256: mix_root per commit,
stmt0.mix_into -> mix_u64 x2, stmt1.mix_into -> mix_felts of 2 felts,
draw_secure_felt, mix_felts(sampled flatten), FriVerifier::commit,
verify_pow_nonce + mix_u64(nonce), draw_u32s query loop) and locked in by
enumeration against `hybrid_hash.bin`'s strong oracles:

  stage A  composition-polynomial identity at the OODS point  (2^-124)
  stage B  proof-of-work trailing_zeros(digest) >= 28          (2^-28)
  stage C  Merkle root reconstruction for all 4 trees + FRI layers

This is host-side scalar work (one transcript per proof, ~40 sha256
compressions) — per-proof scalar transcripts are not the TPU bottleneck;
the heavy per-query work downstream reuses the batched device pipeline.
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple

import numpy as np

P = 2147483647


def _sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


# Variant knobs.  CONFIRMED by the hybrid_hash.bin total-sum oracle
# (docs/sha256_channel_notes.md): mix_root = sha256(digest||root); value
# mixes = sha256(payload_padded32 || digest); draws = sha256(digest||ctr4),
# LE u32 limbs & 0x7fffffff.  The mix_felts chunking for >=2 felts is NOT
# yet pinned (stage A open) — the pair form here is provisional.
DEFAULT_VARIANT = dict(
    root_order="digest_first",   # mix_root: sha256(digest || root)  [confirmed]
    u64_enc="le8_pad32_payload_first",  # [confirmed for values < 2^22]
    felt_enc="le",               # [confirmed for draws]
    felt_chain="per_2felts",     # PROVISIONAL (stage A still open)
    draw_mode="counter4",        # sha256(digest || n_sent_le4)  [confirmed]
    extract="mask31",            # (x & 0x7fffffff) % P          [confirmed]
)


class Sha256Channel:
    """SHA-256 channel (BWS stwo-fork semantics, upstream-stwo structure)."""

    def __init__(self, variant: dict | None = None):
        self.digest = bytes(32)
        self.n_sent = 0
        self.v = dict(DEFAULT_VARIANT, **(variant or {}))

    # -- mixing ------------------------------------------------------------

    def _update(self, payload: bytes) -> None:
        """Value-mix op: confirmed payload-first."""
        self.digest = _sha256(payload + self.digest)
        self.n_sent = 0

    def mix_root(self, root32: bytes) -> None:
        """Confirmed: digest = sha256(digest || root)."""
        assert len(root32) == 32
        self.digest = _sha256(self.digest + root32)
        self.n_sent = 0

    def _u64_bytes(self, value: int) -> bytes:
        enc = self.v["u64_enc"]
        if enc == "le8":
            return int(value).to_bytes(8, "little")
        if enc == "be8":
            return int(value).to_bytes(8, "big")
        if enc == "le8_pad32_back" or enc == "le8_pad32_payload_first":
            return int(value).to_bytes(8, "little") + bytes(24)
        if enc == "pad24_be8":
            return bytes(24) + int(value).to_bytes(8, "big")
        raise ValueError(enc)

    def mix_u64(self, value: int) -> None:
        """Confirmed: digest = sha256(value_padded32 || digest)."""
        payload = self._u64_bytes(value)
        self.digest = _sha256(payload + self.digest)
        self.n_sent = 0

    def _felt_bytes(self, felt4) -> bytes:
        order = "little" if self.v["felt_enc"] == "le" else "big"
        return b"".join(int(x).to_bytes(4, order) for x in felt4)

    def mix_felts(self, felts) -> None:
        """felts: iterable of 4-tuples/arrays of canonical M31 limbs."""
        felts = list(felts)
        if self.v["felt_chain"] == "per_felt":
            for f in felts:
                self._update(self._felt_bytes(f))
        elif self.v["felt_chain"] == "all":
            self._update(b"".join(self._felt_bytes(f) for f in felts))
        elif self.v["felt_chain"] == "per_2felts":
            for i in range(0, len(felts), 2):
                chunk = felts[i : i + 2]
                payload = b"".join(self._felt_bytes(f) for f in chunk)
                self._update(payload.ljust(32, b"\x00"))
        else:
            raise ValueError(self.v["felt_chain"])

    # -- drawing -----------------------------------------------------------

    def _extract_u32s(self, data: bytes) -> List[int]:
        order = "little" if self.v["felt_enc"] == "le" else "big"
        return [int.from_bytes(data[4 * i : 4 * i + 4], order) for i in range(8)]

    def _draw_bytes(self) -> bytes:
        mode = self.v["draw_mode"]
        if mode == "selfhash_then_extract":
            self.digest = _sha256(self.digest)
            return self.digest
        if mode == "extract_then_selfhash":
            src = self.digest
            self.digest = _sha256(self.digest)
            return src
        if mode == "counter4":
            src = _sha256(self.digest + self.n_sent.to_bytes(4, "little"))
            self.n_sent += 1
            return src
        if mode == "counter8":
            src = _sha256(self.digest + self.n_sent.to_bytes(8, "little"))
            self.n_sent += 1
            return src
        raise ValueError(mode)

    def _draw_base_felts(self) -> List[int]:
        """8 M31 limbs per draw; upstream retries the whole batch if any
        raw u32 >= 2P (prob ~2^-28 per batch; absent in the fixtures)."""
        while True:
            limbs = self._extract_u32s(self._draw_bytes())
            if self.v["extract"] == "mask31":
                return [(x & 0x7FFFFFFF) % P for x in limbs]
            if all(x < 2 * P for x in limbs):
                return [x % P for x in limbs]

    def draw_felt(self) -> tuple:
        return tuple(self._draw_base_felts()[:4])

    def draw_felts(self, n: int) -> List[tuple]:
        limbs: List[int] = []
        while len(limbs) < 4 * n:
            limbs.extend(self._draw_base_felts())
        return [tuple(limbs[4 * i : 4 * i + 4]) for i in range(n)]

    def draw_u32s(self) -> List[int]:
        """One draw -> 8 raw u32 query words (no field reduction)."""
        return self._extract_u32s(self._draw_bytes())

    # -- proof of work -------------------------------------------------------

    def trailing_zeros(self) -> int:
        v = int.from_bytes(self.digest[:16], "little")
        if v == 0:
            return 128
        return (v & -v).bit_length() - 1

    def verify_pow_nonce(self, pow_bits: int, nonce: int) -> bool:
        probe = self.clone()
        probe.mix_u64(nonce)
        return probe.trailing_zeros() >= pow_bits

    def clone(self) -> "Sha256Channel":
        c = Sha256Channel(self.v)
        c.digest = self.digest
        c.n_sent = self.n_sent
        return c


class Sha256FSOutput(NamedTuple):
    z: tuple
    alpha: tuple
    random_coeff: tuple
    oods_t: tuple
    after_sampled_values_random_coeff: tuple
    fri_alphas: tuple
    raw_queries: np.ndarray  # (n_queries,) uint32
    pow_ok: bool
    sampled_flat: np.ndarray  # (S, 4) in mix order


def flatten_cols(sampled_values) -> list:
    """TreeVec<Vec<Vec<QM31>>>.flatten_cols(): tree -> column -> samples."""
    out = []
    for tree in sampled_values:
        for col in tree:
            for row in col:
                out.append(tuple(int(x) for x in row))
    return out


def run_sha256_transcript(proof, spec, variant: dict | None = None) -> Sha256FSOutput:
    """Replay hints/fiat_shamir.rs:68-256 over the Sha256 channel."""
    ch = Sha256Channel(variant)
    sp = proof.stark_proof

    def root_bytes(h) -> bytes:
        return bytes(np.asarray(h, np.uint8))

    ch.mix_root(root_bytes(sp.commitments[0]))
    ch.mix_u64(proof.log_size_plonk)
    ch.mix_u64(proof.log_size_poseidon)
    ch.mix_root(root_bytes(sp.commitments[1]))
    z, alpha = ch.draw_felts(2)
    ch.mix_felts([proof.plonk_total_sum, proof.poseidon_total_sum])
    ch.mix_root(root_bytes(sp.commitments[2]))
    random_coeff = ch.draw_felt()
    ch.mix_root(root_bytes(sp.commitments[3]))
    oods_t = ch.draw_felt()

    sampled = flatten_cols(sp.sampled_values)
    ch.mix_felts(sampled)
    after_coeff = ch.draw_felt()

    # FriVerifier::commit: first layer root -> alpha, each inner layer root
    # -> alpha, then mix last-layer poly coeffs (same as the Poseidon path).
    fri_alphas = []
    ch.mix_root(root_bytes(sp.fri_proof.first_layer.commitment))
    fri_alphas.append(ch.draw_felt())
    for layer in sp.fri_proof.inner_layers:
        ch.mix_root(root_bytes(layer.commitment))
        fri_alphas.append(ch.draw_felt())
    ch.mix_felts([tuple(int(x) for x in row) for row in sp.fri_proof.last_layer_poly])

    pow_ok = ch.verify_pow_nonce(spec.pow_bits, sp.proof_of_work)
    ch.mix_u64(sp.proof_of_work)

    raw: List[int] = []
    while len(raw) < spec.n_queries:
        raw.extend(ch.draw_u32s())
    raw = raw[: spec.n_queries]

    return Sha256FSOutput(
        z=z,
        alpha=alpha,
        random_coeff=random_coeff,
        oods_t=oods_t,
        after_sampled_values_random_coeff=after_coeff,
        fri_alphas=tuple(fri_alphas),
        raw_queries=np.array(raw, np.uint64).astype(np.uint32),
        pow_ok=pow_ok,
        sampled_flat=np.array(sampled, np.uint32),
    )
