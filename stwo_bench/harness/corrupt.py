"""The seeded corruptions of a verifier batch, and where they sit in the
program's prepared arrays.

A corruption is (slot, kind, where, delta), drawn from the parsed proof and
named in its terms: a sampled value (its index among all the proof's
samples, a coordinate), a value of the first FRI layer's witness (entry,
coordinate), a hash of an inner FRI layer's Merkle witness (layer, entry,
word), or a limb of the PoW nonce.  The value it names moves by `delta` and
stays canonical.  The reference plants it in its own parsed proof
(reference/check_verify.py `corrupted`).  The program's hint preparation
refuses a corrupted proof's bytes for the whole batch, so the program's
slots are corrupted after it: `locate` finds every place of the clean
prepared arrays that holds the named value, by its value, and `plant` moves
it there in one slot.
"""

from __future__ import annotations

import numpy as np

P = (1 << 31) - 1
NONCE_BITS = (22, 21, 21)  # the nonce's three limbs, low bits first
KINDS = ("sampled_value", "first_layer_witness", "inner_layer_witness", "nonce")


def nest_map(fn, x):
    """fn over every array of a nest of named tuples, tuples and dicts."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: nest_map(fn, v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(nest_map(fn, v) for v in x))
    if isinstance(x, tuple):
        return tuple(nest_map(fn, v) for v in x)
    return fn(x)


def tiled(pa, rows: int):
    """`rows` writable copies of a prepared batch of one proof."""
    return nest_map(lambda a: np.broadcast_to(a, (rows,) + a.shape[1:]).copy(), pa)


def draw(rng: np.random.Generator, proof, batch: int, one_in: int, pool: int) -> list:
    """`pool` patterns of corruptions of a batch of `batch`: one slot in
    `one_in` of the pool's, spread evenly over the patterns from the first,
    each slot drawn; the kinds take turns, their places in the proof are
    drawn."""
    sp = proof.stark_proof
    n_samples = sum(len(col) for tree in sp.sampled_values for col in tree)
    n_first = len(sp.fri_proof.first_layer.fri_witness)
    inner = [(i, len(np.asarray(layer.decommitment.hash_witness).reshape(-1, 8)))
             for i, layer in enumerate(sp.fri_proof.inner_layers)]
    inner = [(i, n) for i, n in inner if n]
    n = pool * batch // one_in
    per_pattern = np.bincount([k * pool // n for k in range(n)], minlength=pool)
    patterns, turn = [], int(rng.integers(len(KINDS)))
    for p in range(pool):
        pattern = []
        for slot in sorted(int(s) for s in rng.choice(batch, per_pattern[p], replace=False)):
            kind = KINDS[turn % len(KINDS)]
            turn += 1
            if kind == "sampled_value":
                where = (int(rng.integers(n_samples)), int(rng.integers(4)))
            elif kind == "first_layer_witness":
                where = (int(rng.integers(n_first)), int(rng.integers(4)))
            elif kind == "inner_layer_witness":
                i, size = inner[int(rng.integers(len(inner)))]
                where = (i, int(rng.integers(size)), int(rng.integers(8)))
            else:
                where = (int(rng.integers(3)),)
            bound = (1 << NONCE_BITS[where[0]]) if kind == "nonce" else P
            pattern.append((slot, kind, where, int(rng.integers(1, bound))))
        patterns.append(pattern)
    return patterns


def _array(pa, path: tuple):
    x = pa
    for key in path:
        x = getattr(x, key) if isinstance(key, str) else x[key]
    return x


def locate(pa, proof, kind: str, where: tuple) -> list:
    """The places (path, index within one slot, modulus) of a prepared
    batch of the clean proof that hold the value a corruption names.
    Raises where the value is not found, so a layout the harness misreads
    fails loudly."""
    sp = proof.stark_proof
    if kind == "sampled_value":
        s, k = where
        flat = np.concatenate([np.asarray(c, np.uint32).reshape(-1, 4) for tree in sp.sampled_values for c in tree])
        places = [(("samples_flat",), (s, k), P)] if (pa.samples_flat[0, s] == flat[s]).all() else []
    elif kind == "first_layer_witness":
        e, k = where
        value = np.asarray(sp.fri_proof.first_layer.fri_witness, np.uint32)[e]
        places = [(("first_layer_paths", "sibling_columns", log), (int(q), k), P)
                  for log, cols in pa.first_layer_paths.sibling_columns.items()
                  for q in np.flatnonzero((cols[0] == value).all(axis=-1))]
    elif kind == "inner_layer_witness":
        i, e, w = where
        value = np.asarray(sp.fri_proof.inner_layers[i].decommitment.hash_witness, np.uint32).reshape(-1, 8)[e]
        hashes = pa.inner_layer_paths[i].sibling_hashes[0]
        places = [(("inner_layer_paths", i, "sibling_hashes"), (int(q), int(d), w), P)
                  for q, d in zip(*np.nonzero((hashes == value).all(axis=-1)))]
    elif kind == "nonce":
        (limb,) = where
        places = [(("nonce_limbs",), (limb,), 1 << NONCE_BITS[limb])]
    else:
        raise ValueError(f"unknown corruption {kind!r}")
    if not places:
        raise RuntimeError(f"the prepared arrays hold no {kind} at {where}")
    return places


def plant(pa, row: int, places: list, delta: int) -> None:
    """Move the located values of row `row` of a host batch by `delta`, in place."""
    for path, idx, mod in places:
        arr = _array(pa, path)
        at = (row,) + tuple(idx)
        arr[at] = (int(arr[at]) + delta) % mod
