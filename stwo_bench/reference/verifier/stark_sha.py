"""A plain verifier of one PlonkWithoutPoseidon proof in the
Sha256MerkleChannel flavour (the bitcoin-facing last-layer proof), over the
parsed proof (proof/parse_np.py).

It walks the proof as stwo's verifier does, one proof at a time and query
by query: the SHA-256 channel over the proof's commitments, statement,
samples, FRI roots, last layer and nonce; the four commitment trees'
mixed-degree SHA-256 Merkle decommitments, walked from the queried leaves;
the FRI answers at each query (quotients_host.py); the first layer's circle
folds with the witness siblings, and its pair tree; each inner layer's line
folds and pair tree; the degree-0 last layer at the folded points; and the
PlonkWithoutPoseidon AIR at the OODS point (composition_np.py) with the
statement's public inputs.  Where stwo stops at the first failure,
`verify_proof` gives each named check as a bool, with their conjunction
'ok' last.

Hashing is hashlib's SHA-256 on bytes.  A digest is 32 bytes, held as its 8
big-endian 32-bit words; an M31 value enters a hash as one big-endian
word:
  leaf (a tree's widest level):  sha256(col_0 || col_1 || ...)
  node:                          sha256(left || right || col_0 || ...)

Departures from stwo, each the program's own convention, which the stwo
fork's SHA-256 sources (not public) may not share:
- the channel.  The digest starts as 32 zero bytes.  mix_root: digest =
  sha256(digest || root).  mix_u64: digest = sha256(le8(v) || 24 zero
  bytes || digest).  Felts are mixed two at a time, their 8 limbs as
  little-endian u32s, a lone last felt zero-padded to 32 bytes: digest =
  sha256(payload || digest).  A draw is sha256(digest || le4(n_sent)),
  n_sent counting the draws since the last mix; its 8 little-endian u32s,
  each (x & 0x7fffffff) mod p, are two felts (draw_felt keeps the first).
- the statement: log_size mixed as the felt (log_size, 0, 0, 0), the
  total sum as one felt.
- proof of work: after mixing the nonce, the low pow_bits of the digest's
  first little-endian u32 are zero.
- queries: drawn as felts (8 reduced limbs a draw) and masked to the
  largest domain's log size, where stwo draws raw u32s.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..proof.parse_np import PlonkWithoutPoseidonProof
from . import quotients_host
from .composition_np import composition_value_np
from .spec_np import NoPoseidonSpec
from .stark import (ZERO, Q31, _children, _np_q, _q, _Stream, _torch_q, domain_point, eval_line_poly, flat_samples,
                    fold, line_x, qadd, qinv, qmul, qscale, qsub)

P = (1 << 31) - 1


# --- SHA-256 on words -----------------------------------------------------------

def _bytes(words) -> bytes:
    return np.asarray(words, np.uint32).astype(">u4").tobytes()


def _digest(data: bytes) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(data).digest(), ">u4").astype(np.uint32)


def hash_leaves(cols: np.ndarray) -> np.ndarray:
    """(N, k) column values -> (N, 8) leaf digests."""
    return np.stack([_digest(_bytes(row)) for row in cols])


def hash_nodes(left: np.ndarray, right: np.ndarray, cols: np.ndarray | None) -> np.ndarray:
    """(N, 8) child digests and (N, k) columns or None -> (N, 8) digests."""
    rows = cols if cols is not None else np.zeros((len(left), 0), np.uint32)
    return np.stack([_digest(_bytes(np.concatenate([l, r, c]))) for l, r, c in zip(left, right, rows)])


# --- the SHA-256 channel ------------------------------------------------------------

class Channel:
    def __init__(self):
        self.digest = bytes(32)
        self.n_sent = 0

    def _mixed(self, digest: bytes) -> None:
        self.digest, self.n_sent = digest, 0

    def mix_root(self, root) -> None:
        self._mixed(hashlib.sha256(self.digest + _bytes(root)).digest())

    def mix_felts(self, felts) -> None:
        felts = np.asarray(felts, np.uint32).reshape(-1, 4)
        for k in range(0, len(felts), 2):
            payload = felts[k:k + 2].astype("<u4").tobytes().ljust(32, b"\0")
            self._mixed(hashlib.sha256(payload + self.digest).digest())

    def mix_u64(self, value: int) -> None:
        self._mixed(hashlib.sha256(int(value).to_bytes(8, "little") + bytes(24) + self.digest).digest())

    def draw(self) -> List[int]:
        """Eight reduced limbs: two felts."""
        h = hashlib.sha256(self.digest + self.n_sent.to_bytes(4, "little")).digest()
        self.n_sent += 1
        return [(int.from_bytes(h[4 * i:4 * i + 4], "little") & 0x7FFFFFFF) % P for i in range(8)]

    def draw_felt(self) -> Q31:
        return tuple(self.draw()[:4])


# --- SHA-256 Merkle decommitments -------------------------------------------------------

def commitment_tree(root, depth: int, n_cols: Dict[int, int], positions: List[int], values,
                    hash_witness) -> Tuple[bool, Dict[int, Dict[int, np.ndarray]]]:
    """A commitment tree's decommitment at the queried leaf positions.

    Columns of log size L sit in the nodes of level L.  The queried values
    come level by level from the leaves, each walked node's columns in node
    order; a sibling digest not walked comes from the hash witness.  Returns
    whether it opens to `root` with both witnesses used up, and the opened
    columns {L: {position at L: values}}."""
    vals, hashes = _Stream(values, 1), _Stream(hash_witness, 8)
    nodes = sorted(set(positions))
    top = vals.take(len(nodes) * n_cols[depth]).reshape(len(nodes), n_cols[depth])
    opened = {depth: dict(zip(nodes, top))}
    layer = dict(zip(nodes, hash_leaves(top)))
    for level in range(depth - 1, -1, -1):
        nodes = sorted({p >> 1 for p in nodes})
        k = n_cols.get(level, 0)
        cols = vals.take(len(nodes) * k).reshape(len(nodes), k) if k else None
        if k:
            opened[level] = dict(zip(nodes, cols))
        left, right = _children(layer, nodes, hashes)
        layer = dict(zip(nodes, hash_nodes(left, right, cols)))
    ok = vals.ok and hashes.ok and np.array_equal(layer[0], np.asarray(root, np.uint32))
    return bool(ok), opened


def pair_tree(root, data_logs: Sequence[int], leaf_positions: List[int], values, hash_witness) -> bool:
    """A FRI layer's tree: at each level that holds data, every walked node
    and its sibling carry one QM31 value (four columns), the values in node
    order; the other levels hash the child pair alone."""
    vals, hashes = _Stream(values, 4), _Stream(hash_witness, 8)
    top = max(data_logs)
    walked, layer = sorted(set(leaf_positions)), {}
    for level in range(top, -1, -1):
        if level in data_logs:
            nodes = sorted({v for p in walked for v in (p, p ^ 1)})
            cols = vals.take(len(nodes))
            if level == top:
                hashed = hash_leaves(cols)
            else:
                hashed = hash_nodes(*_children(layer, nodes, hashes), cols)
        else:
            nodes = walked
            hashed = hash_nodes(*_children(layer, nodes, hashes), None)
        layer = dict(zip(nodes, hashed))
        walked = sorted({p >> 1 for p in walked})
    return bool(vals.ok and hashes.ok and np.array_equal(layer[0], np.asarray(root, np.uint32)))


# --- the verifier ------------------------------------------------------------------------

class Transcript(NamedTuple):
    z: Q31
    alpha: Q31
    random_coeff: Q31
    oods: Tuple[Q31, Q31]
    after_samples_coeff: Q31
    fri_alphas: List[Q31]
    raw_queries: List[int]
    pow_ok: bool


def check_names(spec: NoPoseidonSpec) -> List[str]:
    return (["pow", "total_sum", "composition", "fri_last_layer"] + [f"tree{t}" for t in range(4)]
            + ["fri_first"] + [f"fri_inner{i}" for i in range(spec.n_inner_layers)] + ["ok"])


def transcript(spec: NoPoseidonSpec, proof: PlonkWithoutPoseidonProof) -> Transcript:
    sp, fri = proof.stark_proof, proof.stark_proof.fri_proof
    ch = Channel()
    ch.mix_root(sp.commitments[0])
    ch.mix_felts([spec.log_size, 0, 0, 0])
    ch.mix_root(sp.commitments[1])
    d = ch.draw()
    z, alpha = tuple(d[:4]), tuple(d[4:])
    ch.mix_felts(proof.total_sum)
    ch.mix_root(sp.commitments[2])
    random_coeff = ch.draw_felt()
    ch.mix_root(sp.commitments[3])
    t = ch.draw_felt()
    ch.mix_felts(flat_samples(proof))
    after = ch.draw_felt()
    ch.mix_root(fri.first_layer.commitment)
    alphas = [ch.draw_felt()]
    for layer in fri.inner_layers:
        ch.mix_root(layer.commitment)
        alphas.append(ch.draw_felt())
    ch.mix_felts(fri.last_layer_poly)
    ch.mix_u64(int(sp.proof_of_work))
    pow_ok = int.from_bytes(ch.digest[:4], "little") & ((1 << spec.pow_bits) - 1) == 0
    raw = [v for _ in range(-(-spec.n_queries // 8)) for v in ch.draw()][:spec.n_queries]
    # the OODS point: t -> ((1 - t^2) / (1 + t^2), 2t / (1 + t^2))
    t2 = qmul(t, t)
    inv = qinv(qadd((1, 0, 0, 0), t2))
    oods = (qmul(qsub((1, 0, 0, 0), t2), inv), qmul(qadd(t, t), inv))
    return Transcript(z, alpha, random_coeff, oods, after, alphas, raw, pow_ok)


def composition_ok(spec: NoPoseidonSpec, proof: PlonkWithoutPoseidonProof, fs: Transcript) -> bool:
    samples = torch.from_numpy(flat_samples(proof).astype(np.int64))[None]
    ok, _ = composition_value_np(spec, samples, _torch_q(_q(proof.total_sum)), (_torch_q(fs.z), _torch_q(fs.alpha)),
                                 _torch_q(fs.random_coeff), tuple(_torch_q(c) for c in fs.oods))
    return bool(ok[0])


def total_sum_ok(proof: PlonkWithoutPoseidonProof, fs: Transcript, inputs) -> bool:
    """sum over the public inputs of 1 / (value + alpha idx - z), plus the
    table's sum, is zero."""
    total = _q(proof.total_sum)
    for idx, value in inputs:
        total = qadd(total, qinv(qsub(qadd(_q(value), qscale(fs.alpha, idx)), fs.z)))
    return total == ZERO


def verify_proof(spec: NoPoseidonSpec, proof: PlonkWithoutPoseidonProof, inputs) -> Tuple[Dict[str, bool], Transcript]:
    """Every named check of one proof, and its transcript.  Raises
    ValueError where the proof's shape is not the spec's."""
    sp, fri = proof.stark_proof, proof.stark_proof.fri_proof
    if proof.log_size != spec.log_size:
        raise ValueError(f"log size {proof.log_size}, the configuration states {spec.log_size}")
    if [len(t) for t in sp.sampled_values] != [len(t) for t in spec.n_samples_per_column]:
        raise ValueError("the proof's column counts are not the spec's")
    if [[len(c) for c in t] for t in sp.sampled_values] != [list(t) for t in spec.n_samples_per_column]:
        raise ValueError("the proof's samples per column are not the spec's")
    if len(fri.inner_layers) != spec.n_inner_layers:
        raise ValueError(f"{len(fri.inner_layers)} inner FRI layers, the configuration states {spec.n_inner_layers}")
    if len(fri.last_layer_poly) != 1 << spec.log_last_layer_degree_bound:
        raise ValueError("the last layer's degree is not the configuration's")
    fs = transcript(spec, proof)
    checks = {"pow": fs.pow_ok, "total_sum": total_sum_ok(proof, fs, inputs),
              "composition": composition_ok(spec, proof, fs)}

    m = spec.max_first_layer_log
    raw = [q & ((1 << m) - 1) for q in fs.raw_queries]
    trees, opened = [], []
    for t in range(4):
        depth = spec.tree_max_domain_log[t]
        ok, cols = commitment_tree(sp.commitments[t], depth, dict(spec.n_columns_per_log_size[t]),
                                   [q >> (m - depth) for q in raw], sp.queried_values[t],
                                   sp.decommitments[t].hash_witness)
        trees.append(ok)
        opened.append(cols)

    # the FRI answers of each column size at each query, from the opened columns
    samples = flat_samples(proof)[None]
    oods = tuple(_np_q(c) for c in fs.oods)
    answers = {}
    for g, size in enumerate(spec.all_log_sizes):
        pos = [q >> (m - size) for q in raw]
        width = [spec.n_columns_per_log_size[t].get(size, 0) for t in range(4)]
        rows = np.stack([np.concatenate([opened[t].get(size, {}).get(p, np.zeros(width[t], np.uint32))
                                         for t in range(4) if width[t]]) for p in pos])
        pts = [domain_point(p, size) for p in pos]
        got = quotients_host.fri_answers_for_group(
            spec, g, oods, _np_q(fs.after_samples_coeff), samples, rows[None],
            np.array([[x for x, _ in pts]], np.uint32), np.array([[y for _, y in pts]], np.uint32))
        answers[size] = {p: tuple(int(c[0, i]) for c in got) for i, p in enumerate(pos)}

    # the first layer: each size's pairs, a sibling not queried from the witness
    witness = _Stream(fri.first_layer.fri_witness, 4)
    joins, stream = {}, []
    for size in spec.all_log_sizes:
        joins[size] = {}
        for start in sorted({p & ~1 for p in answers[size]}):
            pair = [answers[size].get(v) for v in (start, start + 1)]
            pair = [v if v is not None else _q(witness.take(1)[0]) for v in pair]
            stream += pair
            y = domain_point(start, size)[1]
            joins[size][start >> 1] = fold(pair[0], pair[1], y, fs.fri_alphas[m - size])
    first_ok = witness.ok and pair_tree(fri.first_layer.commitment, spec.all_log_sizes, raw,
                                        np.asarray(stream, np.uint32), fri.first_layer.decommitment.hash_witness)

    # the inner layers: join the next size's circle folds, fold each pair
    folded = {q >> 1: ZERO for q in raw}
    size, inner_ok = m, []
    for i, layer in enumerate(fri.inner_layers):
        if size in joins:
            a2 = qmul(fs.fri_alphas[i], fs.fri_alphas[i])
            folded = {k: qadd(qmul(a2, v), joins[size].get(k, ZERO)) for k, v in folded.items()}
        size -= 1
        witness = _Stream(layer.fri_witness, 4)
        values = {}
        for k in sorted(folded):
            if k ^ 1 not in folded and k ^ 1 not in values:
                values[k ^ 1] = _q(witness.take(1)[0])
            values[k] = folded[k]
        inner_ok.append(witness.ok and pair_tree(layer.commitment, [size], [q >> (m - size) for q in raw],
                                                 np.asarray([values[k] for k in sorted(values)], np.uint32),
                                                 layer.decommitment.hash_witness))
        folded = {k >> 1: fold(values[k], values[k + 1], line_x(k, size), fs.fri_alphas[i + 1])
                  for k in sorted(values) if k % 2 == 0}

    # the last layer: the folded values are its polynomial's
    size -= 1
    coeffs = np.asarray(fri.last_layer_poly, np.uint32).reshape(-1, 4)
    checks["fri_last_layer"] = all(v == eval_line_poly(coeffs, line_x(k, size)) for k, v in folded.items())
    for t in range(4):
        checks[f"tree{t}"] = trees[t]
    checks["fri_first"] = bool(first_ok)
    for i, ok in enumerate(inner_ok):
        checks[f"fri_inner{i}"] = bool(ok)
    checks = {k: bool(v) for k, v in checks.items()}
    checks["ok"] = all(checks.values())
    return checks, fs
