"""A plain verifier of one PlonkWithPoseidon proof, over the parsed proof.

It walks the proof as stwo's verifier does, one proof at a time and query
by query: the Poseidon31 channel over the proof's commitments, sums,
samples, FRI roots, last layer and nonce; the four commitment trees'
mixed-degree Merkle decommitments; the FRI answers at each query; the first
layer's circle folds with the witness siblings, and its pair tree; each
inner layer's line folds and pair tree; and the last layer's polynomial at
the folded points.  Where stwo stops at the first failure, `verify_proof`
goes on and gives each of the batched verifier's named checks as a bool,
with their conjunction 'ok' last, so that each can be compared.

The Merkle walks and the folds are written here; the quotients
(quotients_host.py), the AIR at the OODS point (composition.py) and the
field and circle arithmetic are the reference's own host code.  A clean
proof made by recursive-stwo verifies under it, which ties each of these
to the Rust verifier.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core import qm31 as tq
from ..core.circle_host import CircleDomain, Coset, bit_reverse_index
from ..core.poseidon2_host import permute
from ..core.qm31_host import QM31
from ..proof.containers import PlonkWithPoseidonProof
from . import composition as composition_mod
from . import quotients_host
from .spec import VerifierSpec

P = (1 << 31) - 1
NONCE_BITS = (22, 21, 21)  # the nonce's three limbs, low bits first, as the channel mixes them
Q31 = Tuple[int, int, int, int]
ZERO: Q31 = (0, 0, 0, 0)


# --- QM31 on python ints: (a + b i) + (c + d i) u, i^2 = -1, u^2 = 2 + i ----

def _cmul(x0: int, x1: int, y0: int, y1: int) -> Tuple[int, int]:
    return (x0 * y0 - x1 * y1) % P, (x0 * y1 + x1 * y0) % P


def qadd(x: Q31, y: Q31) -> Q31:
    return tuple((a + b) % P for a, b in zip(x, y))


def qsub(x: Q31, y: Q31) -> Q31:
    return tuple((a - b) % P for a, b in zip(x, y))


def qmul(x: Q31, y: Q31) -> Q31:
    ac = _cmul(x[0], x[1], y[0], y[1])
    bd = _cmul(*_cmul(x[2], x[3], y[2], y[3]), 2, 1)
    ad = _cmul(x[0], x[1], y[2], y[3])
    bc = _cmul(x[2], x[3], y[0], y[1])
    return (ac[0] + bd[0]) % P, (ac[1] + bd[1]) % P, (ad[0] + bc[0]) % P, (ad[1] + bc[1]) % P


def qscale(x: Q31, s: int) -> Q31:
    return tuple(a * s % P for a in x)


def qinv(x: Q31) -> Q31:
    """1 / (a + b u) = (a - b u) / (a^2 - b^2 u^2); 0 maps to 0."""
    a2 = _cmul(x[0], x[1], x[0], x[1])
    b2u = _cmul(*_cmul(x[2], x[3], x[2], x[3]), 2, 1)
    d0, d1 = (a2[0] - b2u[0]) % P, (a2[1] - b2u[1]) % P
    n = pow((d0 * d0 + d1 * d1) % P, P - 2, P)
    i0, i1 = d0 * n % P, -d1 * n % P
    r = _cmul(x[0], x[1], i0, i1)
    s = _cmul(x[2], x[3], i0, i1)
    return r[0], r[1], -s[0] % P, -s[1] % P


def _q(row) -> Q31:
    return tuple(int(v) for v in row)


# --- the Poseidon31 channel -------------------------------------------------

class Channel:
    """The digest is the capacity half of the state; a mix permutes [words,
    digest] and keeps the capacity half; a draw permutes [n_sent, 0...,
    digest] and reads the rate half, n_sent counting the draws since the
    last mix."""

    def __init__(self):
        self.digest = np.zeros(8, np.uint32)
        self.n_sent = 0
        self.mixes = 0
        self.draws = 0

    def mix(self, words) -> None:
        row = np.zeros(8, np.uint32)
        words = np.asarray(words, np.uint32).ravel()
        row[:words.size] = words
        self.digest = permute(np.concatenate([row, self.digest]))[8:]
        self.n_sent = 0
        self.mixes += 1

    def draw(self) -> List[int]:
        state = np.zeros(16, np.uint32)
        state[0] = self.n_sent
        state[8:] = self.digest
        self.n_sent += 1
        self.draws += 1
        return [int(v) for v in permute(state)[:8]]


def split_nonce(nonce: int) -> List[int]:
    out, shift = [], 0
    for bits in NONCE_BITS:
        out.append((nonce >> shift) & ((1 << bits) - 1))
        shift += bits
    return out


def join_nonce(limbs: Sequence[int]) -> int:
    out, shift = 0, 0
    for limb, bits in zip(limbs, NONCE_BITS):
        out |= int(limb) << shift
        shift += bits
    return out


# --- Poseidon31 Merkle hashing (Poseidon31MerkleHasher::hash_node) -----------

def _absorb(cols: np.ndarray) -> np.ndarray:
    """(N, k) column values -> (N, 8) digests, 8 columns a permutation into
    the capacity half."""
    digest = np.zeros((cols.shape[0], 8), np.uint32)
    for lo in range(0, cols.shape[1], 8):
        chunk = np.zeros((cols.shape[0], 8), np.uint32)
        chunk[:, :cols[:, lo:lo + 8].shape[1]] = cols[:, lo:lo + 8]
        digest = permute(np.concatenate([chunk, digest], axis=1))[:, 8:]
    return digest


def hash_leaves(cols: np.ndarray) -> np.ndarray:
    digest = _absorb(cols)
    return permute(np.concatenate([np.zeros_like(digest), digest], axis=1))[:, :8]


def hash_nodes(left: np.ndarray, right: np.ndarray, cols: np.ndarray | None) -> np.ndarray:
    h = permute(np.concatenate([left, right], axis=1))[:, :8]
    if cols is not None and cols.shape[1]:
        h = permute(np.concatenate([h, _absorb(cols)], axis=1))[:, :8]
    return h


class _Stream:
    """Values taken in order from a flat witness; `ok` falls when it runs
    out (zeros are handed out) or when values are left over."""

    def __init__(self, values, width: int):
        self.rows = np.asarray(values, np.uint32).reshape(-1, width)
        self.width, self.at, self.short = width, 0, False

    def take(self, n: int) -> np.ndarray:
        out = np.zeros((n, self.width), np.uint32)
        got = self.rows[self.at:self.at + n]
        out[:len(got)] = got
        self.short |= len(got) < n
        self.at += n
        return out

    @property
    def ok(self) -> bool:
        return not self.short and self.at == len(self.rows)


def _children(prev: Dict[int, np.ndarray], nodes: List[int], witness: _Stream):
    """Each node's children from the level below, a child not walked there
    taken from the hash witness, in node order."""
    left, right = [], []
    for node in nodes:
        for child, side in ((2 * node, left), (2 * node + 1, right)):
            if child not in prev:
                prev[child] = witness.take(1)[0]
            side.append(prev[child])
    return np.stack(left), np.stack(right)


def commitment_tree(root, depth: int, n_cols: Dict[int, int], positions: List[int], values,
                    hash_witness) -> Tuple[bool, Dict[int, Dict[int, np.ndarray]]]:
    """A commitment tree's decommitment at the queried leaf positions.

    Columns of log size L sit in the nodes of level L.  The queried values
    come level by level from the leaves, each walked node's columns in node
    order; a sibling hash not walked comes from the hash witness.  Returns
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
    and its sibling carry one QM31 value, the values in node order; the
    other levels hash the child pair alone."""
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


# --- circle points and folds ---------------------------------------------------

def domain_point(pos: int, log_size: int) -> Tuple[int, int]:
    """The point at bit-reversed position `pos` of the canonic circle domain
    of 2**log_size points."""
    x, y = CircleDomain(Coset.half_odds(log_size - 1)).at(bit_reverse_index(pos, log_size))
    return int(x), int(y)


def line_x(pos: int, log_size: int) -> int:
    """x at bit-reversed position `pos` of the line domain of 2**log_size points."""
    return int(Coset.half_odds(log_size).at(bit_reverse_index(pos, log_size))[0])


def fold(left: Q31, right: Q31, t: int, alpha: Q31) -> Q31:
    """(l + r) + alpha (l - r) / t, t the even point's y (circle) or x (line)."""
    return qadd(qadd(left, right), qmul(alpha, qscale(qsub(left, right), pow(t, P - 2, P))))


def eval_line_poly(coeffs: np.ndarray, x: int) -> Q31:
    """The last layer's polynomial at x: coefficient k multiplies the product
    of the k-th bits' factors x, 2x^2 - 1, ..."""
    factors, f = [], x
    for _ in range(len(coeffs).bit_length() - 1):
        factors.append(f)
        f = (2 * f * f - 1) % P
    v = [_q(c) for c in coeffs]
    for f in reversed(factors):
        v = [qadd(v[j], qscale(v[j + 1], f)) for j in range(0, len(v), 2)]
    return v[0]


# --- the verifier ----------------------------------------------------------------

class Transcript(NamedTuple):
    z: Q31
    alpha: Q31
    random_coeff: Q31
    oods: Tuple[Q31, Q31]
    after_samples_coeff: Q31
    fri_alphas: List[Q31]
    raw_queries: List[int]
    pow_ok: bool
    permutations: int


def check_names(spec: VerifierSpec) -> List[str]:
    return (["pow", "total_sum", "composition", "fri_last_layer"] + [f"tree{t}" for t in range(4)]
            + ["fri_first"] + [f"fri_inner{i}" for i in range(spec.n_inner_layers)] + ["ok"])


def flat_samples(proof: PlonkWithPoseidonProof) -> np.ndarray:
    return np.concatenate([np.asarray(col, np.uint32).reshape(-1, 4)
                           for tree in proof.stark_proof.sampled_values for col in tree])


def transcript(spec: VerifierSpec, proof: PlonkWithPoseidonProof) -> Transcript:
    sp, fri = proof.stark_proof, proof.stark_proof.fri_proof
    ch = Channel()
    ch.mix(sp.commitments[0])
    ch.mix([spec.log_size_plonk])
    ch.mix([spec.log_size_poseidon])
    ch.mix(sp.commitments[1])
    d = ch.draw()
    z, alpha = tuple(d[:4]), tuple(d[4:])
    ch.mix(np.concatenate([proof.plonk_total_sum, proof.poseidon_total_sum]))
    ch.mix(sp.commitments[2])
    random_coeff = tuple(ch.draw()[:4])
    ch.mix(sp.commitments[3])
    t = tuple(ch.draw()[:4])
    samples = flat_samples(proof)
    for k in range(0, len(samples), 2):
        ch.mix(samples[k:k + 2])
    after = tuple(ch.draw()[:4])
    ch.mix(fri.first_layer.commitment)
    alphas = [tuple(ch.draw()[:4])]
    for layer in fri.inner_layers:
        ch.mix(layer.commitment)
        alphas.append(tuple(ch.draw()[:4]))
    last = np.asarray(fri.last_layer_poly, np.uint32).reshape(-1, 4)
    for k in range(0, len(last), 2):
        ch.mix(last[k:k + 2])
    ch.mix(split_nonce(int(sp.proof_of_work)))
    pow_ok = int(ch.digest[0]) & ((1 << spec.pow_bits) - 1) == 0
    raw = [v for _ in range(-(-spec.n_queries // 8)) for v in ch.draw()][:spec.n_queries]
    # the OODS point: t -> ((1 - t^2) / (1 + t^2), 2t / (1 + t^2))
    t2 = qmul(t, t)
    inv = qinv(qadd((1, 0, 0, 0), t2))
    oods = (qmul(qsub((1, 0, 0, 0), t2), inv), qmul(qadd(t, t), inv))
    return Transcript(z, alpha, random_coeff, oods, after, alphas, raw, pow_ok, ch.mixes + ch.draws)


def _np_q(v: Q31) -> QM31:
    return QM31(*(np.array([c], np.uint32) for c in v))


def _torch_q(v: Q31) -> tq.QM31:
    return tq.QM31(*(torch.tensor([c], dtype=torch.int64) for c in v))


def composition_ok(spec: VerifierSpec, proof: PlonkWithPoseidonProof, fs: Transcript) -> bool:
    samples = torch.from_numpy(flat_samples(proof).astype(np.int64))[None]
    ok, _ = composition_mod.composition_value_plain(
        spec, samples, (_torch_q(_q(proof.plonk_total_sum)), _torch_q(_q(proof.poseidon_total_sum))),
        (_torch_q(fs.z), _torch_q(fs.alpha)), _torch_q(fs.random_coeff), tuple(_torch_q(c) for c in fs.oods))
    return bool(ok[0])


def total_sum_ok(proof: PlonkWithPoseidonProof, fs: Transcript, inputs) -> bool:
    """sum over the public inputs of 1 / (value + alpha idx - z), plus both
    tables' sums, is zero."""
    total = qadd(_q(proof.plonk_total_sum), _q(proof.poseidon_total_sum))
    for idx, value in inputs:
        total = qadd(total, qinv(qsub(qadd(_q(value), qscale(fs.alpha, idx)), fs.z)))
    return total == ZERO


def verify_proof(spec: VerifierSpec, proof: PlonkWithPoseidonProof, inputs) -> Tuple[Dict[str, bool], Transcript]:
    """Every named check of one proof, and its transcript.  Raises
    ValueError where the proof's shape is not the spec's."""
    sp, fri = proof.stark_proof, proof.stark_proof.fri_proof
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
