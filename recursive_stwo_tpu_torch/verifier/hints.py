"""Host-side (numpy) hint preparation: expand stwo's shared-ancestor Merkle
decommitments into fixed-shape per-query paths, and replay the FRI folds to
recover the pair-proof value tensors the device verifier consumes.

This is untrusted precomputation (the device re-derives and checks all of
it); it mirrors the reference hint layer:
  - SinglePathMerkleProof::from_stwo_proof   (hints/decommit.rs:44-183)
  - SinglePairMerkleProof::from_stwo_proof   (hints/folding.rs:93-287)
  - FirstLayerHints / InnerLayersHints       (hints/folding.rs:296-601)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core import circle_host as circle, m31_host as m31, poseidon2_host as poseidon2
from ..core import qm31_host as q
from ..core.qm31_host import QM31
from ..proof.containers import MerkleDecommitment, PlonkWithPoseidonProof
from . import points_host as points_mod
from . import quotients_host as quotients, transcript_host as transcript
from .arrays import PairPaths, ProofArrays, TreePaths, from_proofs
from .spec import VerifierSpec


# ---------------------------------------------------------------------------
# Scalar (host) Poseidon31 Merkle hashing
# ---------------------------------------------------------------------------

def _permute16(state16: np.ndarray) -> np.ndarray:
    return poseidon2.permute(state16.astype(np.uint32))


def hash_column_capacity(cols: np.ndarray) -> np.ndarray:
    """Absorb M31 columns (chunks of 8) into the capacity half."""
    n = len(cols)
    digest = np.zeros(8, np.uint32)
    if n == 0:
        return digest
    n_chunks = (n + 7) // 8
    for ci in range(n_chunks):
        chunk = np.zeros(8, np.uint32)
        part = cols[8 * ci : 8 * ci + 8]
        chunk[: len(part)] = part
        digest = _permute16(np.concatenate([chunk, digest]))[8:]
    return digest


def hash_node(children, cols: np.ndarray) -> np.ndarray:
    """stwo Poseidon31MerkleHasher::hash_node (gadget mirror merkle/lib.rs)."""
    cols = np.asarray(cols, np.uint32)
    if children is None:
        digest = hash_column_capacity(cols)
        return _permute16(np.concatenate([np.zeros(8, np.uint32), digest]))[:8]
    left, right = children
    h = _permute16(np.concatenate([left, right]))[:8]
    if len(cols):
        col_digest = hash_column_capacity(cols)
        h = _permute16(np.concatenate([h, col_digest]))[:8]
    return h


# Batched (row-parallel) variants of the same hashes: one permute call per
# tree level instead of one per node.  They ride the AVX-512 16-way kernel
# (native/poseidon31.cpp) when available and stay fully-batched numpy
# otherwise, which keeps host hint preparation fast even without g++.

def _hash_columns_batch(cols: np.ndarray) -> np.ndarray:
    """(N, k) M31 columns -> (N, 8) capacity digests (chunks of 8)."""
    n_rows, k = cols.shape
    digest = np.zeros((n_rows, 8), np.uint32)
    for ci in range(0, k, 8):
        chunk = np.zeros((n_rows, 8), np.uint32)
        part = cols[:, ci : ci + 8]
        chunk[:, : part.shape[1]] = part
        digest = poseidon2.permute(
            np.concatenate([chunk, digest], axis=1)
        )[:, 8:]
    return digest


def _hash_leaves_batch(cols: np.ndarray) -> np.ndarray:
    """(N, k) -> (N, 8): hash_node(None, cols) for every row."""
    digest = _hash_columns_batch(np.asarray(cols, np.uint32))
    state = np.concatenate([np.zeros_like(digest), digest], axis=1)
    return poseidon2.permute(state)[:, :8]


def _hash_nodes_batch(
    left: np.ndarray, right: np.ndarray, cols: np.ndarray | None
) -> np.ndarray:
    """(N, 8) x2 children + optional (N, k) columns -> (N, 8)."""
    h = poseidon2.permute(np.concatenate([left, right], axis=1))[:, :8]
    if cols is not None and cols.shape[1]:
        col_digest = _hash_columns_batch(np.asarray(cols, np.uint32))
        h = poseidon2.permute(np.concatenate([h, col_digest], axis=1))[:, :8]
    return h


# SHA-256 level-batched twins (verifier/sha256_merkle.py semantics): used
# by the batched path expansion for the Sha256(Poseidon31) flavors, riding
# the AVX-512 16-way kernels instead of one scalar hash per node.

def _sha_words(msgs: np.ndarray) -> np.ndarray:
    from ..core.sha256 import sha256_words
    from ..utils import native

    if native.sha_available():
        return native.sha256_words_batch(np.ascontiguousarray(msgs))
    return sha256_words(msgs)


def _sha_leaves_batch(cols: np.ndarray) -> np.ndarray:
    return _sha_words(np.asarray(cols, np.uint32))


def _sha_nodes_batch(
    left: np.ndarray, right: np.ndarray, cols: np.ndarray | None
) -> np.ndarray:
    parts = [left, right]
    if cols is not None and cols.shape[1]:
        parts.append(np.asarray(cols, np.uint32))
    return _sha_words(np.concatenate(parts, axis=1))


def _level_hashers(flavor: str):
    if flavor == "sha256":
        return _sha_leaves_batch, _sha_nodes_batch
    return _hash_leaves_batch, _hash_nodes_batch


# ---------------------------------------------------------------------------
# Commitment-tree path expansion (single-path proofs)
# ---------------------------------------------------------------------------


def expand_single_paths(
    max_log: int,
    raw_queries: List[int],
    values: np.ndarray,
    n_columns_per_log_size: Dict[int, int],
    decommitment: MerkleDecommitment,
    root: np.ndarray,
    hash_node_fn=None,
):
    """Per-query standalone paths from a shared stwo decommitment.

    Returns (sibling_hashes (Q, max_log, 8), columns {log->(Q, n)}).
    hash_node_fn overrides the Poseidon31 node hash (e.g. the SHA-256
    flavor, verifier/sha256_merkle.py); the default Poseidon31 flavor
    hashes each tree level as ONE batched permute call."""
    queries = sorted(set(raw_queries))
    n_top = n_columns_per_log_size[max_log]
    values = np.ascontiguousarray(values, np.uint32).ravel()
    hw = np.asarray(decommitment.hash_witness, np.uint32).reshape(-1, 8)
    vcur = hcur = 0

    def take_vals(n: int) -> np.ndarray:
        nonlocal vcur
        assert vcur + n <= values.size, "value witness exhausted (corrupted proof?)"
        out = values[vcur : vcur + n]
        vcur += n
        return out

    def take_hash() -> np.ndarray:
        nonlocal hcur
        assert hcur < hw.shape[0], "hash witness exhausted (corrupted proof?)"
        out = hw[hcur]
        hcur += 1
        return out

    assert len(decommitment.column_witness) == 0

    leaf_cols = take_vals(len(queries) * n_top).reshape(len(queries), n_top)
    queries_values = {qq: leaf_cols[i] for i, qq in enumerate(queries)}

    if hash_node_fn is None:
        leaf_hashes = _hash_leaves_batch(leaf_cols)
        hash_layers: List[Dict[int, np.ndarray]] = [
            {qq: leaf_hashes[i] for i, qq in enumerate(queries)}
        ]
    else:
        hash_layers = [
            {qq: hash_node_fn(None, queries_values[qq]) for qq in queries}
        ]
    column_layers: List[Dict[int, np.ndarray]] = []
    positions = sorted(queries)

    for i in range(max_log):
        layer: Dict[int, np.ndarray] = {}
        column_layer: Dict[int, np.ndarray] = {}
        ncols = n_columns_per_log_size.get(max_log - 1 - i, 0)
        parents: List[int] = []
        lefts: List[np.ndarray] = []
        rights: List[np.ndarray] = []
        colrows: List[np.ndarray] = []
        for position in positions:
            if (position >> 1) in column_layer:
                continue
            sibling_idx = position ^ 1
            cols = take_vals(ncols)
            column_layer[position >> 1] = cols
            if sibling_idx not in hash_layers[i]:
                hash_layers[i][sibling_idx] = take_hash()
            sibling = hash_layers[i][sibling_idx]
            own = hash_layers[i][position]
            pair = (own, sibling) if position & 1 == 0 else (sibling, own)
            if hash_node_fn is None:
                parents.append(position >> 1)
                lefts.append(pair[0])
                rights.append(pair[1])
                colrows.append(cols)
            else:
                layer[position >> 1] = hash_node_fn(pair, cols)
                parents.append(position >> 1)
        if hash_node_fn is None and parents:
            hashed = _hash_nodes_batch(
                np.stack(lefts), np.stack(rights),
                np.stack(colrows) if ncols else None,
            )
            for j, parent in enumerate(parents):
                layer[parent] = hashed[j]
        column_layers.append(column_layer)
        hash_layers.append(layer)
        positions = sorted(set(parents))

    assert hcur == hw.shape[0], "unconsumed hash witness"
    assert vcur == values.size, "unconsumed value witness"
    assert np.array_equal(hash_layers[-1][0], root), "tree root mismatch"

    Q = len(raw_queries)
    sib = np.zeros((Q, max_log, 8), np.uint32)
    columns: Dict[int, np.ndarray] = {
        max_log: np.zeros((Q, n_top), np.uint32)
    }
    for lvl, ncols in n_columns_per_log_size.items():
        if lvl != max_log:
            columns[lvl] = np.zeros((Q, ncols), np.uint32)

    for qi, qq in enumerate(raw_queries):
        cur = qq
        for i in range(max_log):
            sib[qi, i] = hash_layers[i][cur ^ 1]
            cur >>= 1
        columns[max_log][qi] = queries_values[qq]
        cur = qq >> 1
        for i, layer in enumerate(column_layers[: max_log - 1]):
            data = layer[cur]
            lvl = max_log - i - 1
            if len(data):
                columns[lvl][qi] = data
            cur >>= 1
    return sib, columns


def expand_single_paths_batched(
    max_log: int,
    raw_queries_list: List[List[int]],
    values_list: List[np.ndarray],
    n_columns_per_log_size: Dict[int, int],
    decommitments: List[MerkleDecommitment],
    roots: List[np.ndarray],
    flavor: str = "p31",
) -> List[tuple]:
    """Batch twin of expand_single_paths over B proofs: identical per-proof
    witness-consumption order and outputs, but each tree level hashes the
    nodes of ALL proofs in one call (the per-call overhead of the native
    kernel dominated single-proof expansion).  flavor selects the node
    hash: "p31" (Poseidon31) or "sha256" (verifier/sha256_merkle.py)."""
    leaves_fn, nodes_fn = _level_hashers(flavor)
    B = len(values_list)
    n_top = n_columns_per_log_size[max_log]

    st = []
    leaf_rows = []
    for bi in range(B):
        queries = sorted(set(raw_queries_list[bi]))
        values = np.ascontiguousarray(values_list[bi], np.uint32).ravel()
        hw = np.asarray(
            decommitments[bi].hash_witness, np.uint32
        ).reshape(-1, 8)
        assert len(decommitments[bi].column_witness) == 0
        nq = len(queries)
        assert nq * n_top <= values.size, "value witness exhausted"
        leaf_cols = values[: nq * n_top].reshape(nq, n_top)
        leaf_rows.append(leaf_cols)
        st.append(
            dict(
                queries=queries,
                values=values,
                vcur=nq * n_top,
                hw=hw,
                hcur=0,
                leaf_cols=leaf_cols,
                hash_layers=[],
                column_layers=[],
                positions=queries,
            )
        )

    leaf_hashed = leaves_fn(np.concatenate(leaf_rows))
    off = 0
    for bi in range(B):
        nq = len(st[bi]["queries"])
        st[bi]["hash_layers"].append(
            {
                qq: leaf_hashed[off + i]
                for i, qq in enumerate(st[bi]["queries"])
            }
        )
        off += nq

    for i in range(max_log):
        ncols = n_columns_per_log_size.get(max_log - 1 - i, 0)
        all_lefts: List[np.ndarray] = []
        all_rights: List[np.ndarray] = []
        all_cols: List[np.ndarray] = []
        job_owner: List[Tuple[int, int]] = []  # (proof, parent)
        for bi in range(B):
            s = st[bi]
            layer: Dict[int, np.ndarray] = {}
            column_layer: Dict[int, np.ndarray] = {}
            hl = s["hash_layers"][i]
            values, hw = s["values"], s["hw"]
            for position in s["positions"]:
                if (position >> 1) in column_layer:
                    continue
                cols = values[s["vcur"] : s["vcur"] + ncols]
                assert cols.size == ncols, "value witness exhausted"
                s["vcur"] += ncols
                column_layer[position >> 1] = cols
                sibling_idx = position ^ 1
                if sibling_idx not in hl:
                    assert s["hcur"] < hw.shape[0], "hash witness exhausted"
                    hl[sibling_idx] = hw[s["hcur"]]
                    s["hcur"] += 1
                own, sibling = hl[position], hl[sibling_idx]
                pair = (own, sibling) if position & 1 == 0 else (sibling, own)
                all_lefts.append(pair[0])
                all_rights.append(pair[1])
                all_cols.append(cols)
                job_owner.append((bi, position >> 1))
            s["column_layers"].append(column_layer)
            s["hash_layers"].append(layer)
            s["positions"] = sorted(column_layer)
        if job_owner:
            hashed = nodes_fn(
                np.stack(all_lefts),
                np.stack(all_rights),
                np.stack(all_cols) if ncols else None,
            )
            for j, (bi, parent) in enumerate(job_owner):
                st[bi]["hash_layers"][i + 1][parent] = hashed[j]

    out = []
    for bi in range(B):
        s = st[bi]
        assert s["hcur"] == s["hw"].shape[0], "unconsumed hash witness"
        assert s["vcur"] == s["values"].size, "unconsumed value witness"
        assert np.array_equal(
            s["hash_layers"][-1][0], roots[bi]
        ), "tree root mismatch"

        raw_queries = raw_queries_list[bi]
        Q = len(raw_queries)
        sib = np.zeros((Q, max_log, 8), np.uint32)
        columns: Dict[int, np.ndarray] = {
            max_log: np.zeros((Q, n_top), np.uint32)
        }
        for lvl, ncols in n_columns_per_log_size.items():
            if lvl != max_log:
                columns[lvl] = np.zeros((Q, ncols), np.uint32)
        qmap = {qq: i for i, qq in enumerate(s["queries"])}
        for qi, qq in enumerate(raw_queries):
            cur = qq
            for i in range(max_log):
                sib[qi, i] = s["hash_layers"][i][cur ^ 1]
                cur >>= 1
            columns[max_log][qi] = s["leaf_cols"][qmap[qq]]
            cur = qq >> 1
            for i, layer in enumerate(s["column_layers"][: max_log - 1]):
                data = layer[cur]
                lvl = max_log - i - 1
                if len(data):
                    columns[lvl][qi] = data
                cur >>= 1
        out.append((sib, columns))
    return out


# ---------------------------------------------------------------------------
# FRI pair-proof expansion
# ---------------------------------------------------------------------------

def expand_pair_paths(
    log_sizes_with_data: List[int],
    root: np.ndarray,
    leaf_queries: List[int],
    values: np.ndarray,
    decommitment: MerkleDecommitment,
    hash_node_fn=None,
):
    """Per-query pair paths (self+sibling QM31 per data level, shared sibling
    hashes).  Returns (sibling_hashes (Q, depth-1, 8),
    self_cols {log->(Q,4)}, sib_cols {log->(Q,4)}).  The default Poseidon31
    flavor hashes each tree level as one batched permute call."""
    max_log = max(log_sizes_with_data)
    data_set = set(log_sizes_with_data)
    assert len(decommitment.column_witness) == 0

    values = np.ascontiguousarray(values, np.uint32).ravel()
    hw = np.asarray(decommitment.hash_witness, np.uint32).reshape(-1, 8)
    vcur = hcur = 0

    def take_hash() -> np.ndarray:
        nonlocal hcur
        assert hcur < hw.shape[0], "hash witness exhausted (corrupted proof?)"
        out = hw[hcur]
        hcur += 1
        return out

    def batch_hash(pairs: List[tuple], cols: np.ndarray | None):
        """pairs [(left8, right8)], cols (N, k) or None -> list of (8,)."""
        if hash_node_fn is not None:
            if cols is None:
                return [
                    hash_node_fn(pair, np.array([])) for pair in pairs
                ]
            return [
                hash_node_fn(pair, cols[j]) for j, pair in enumerate(pairs)
            ]
        hashed = _hash_nodes_batch(
            np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]),
            cols,
        )
        return list(hashed)

    queries = list(leaf_queries)
    queries_values_map: Dict[int, Dict[int, np.ndarray]] = {}
    hash_layers: List[Dict[int, np.ndarray]] = []

    for current in range(max_log, -1, -1):
        queries = sorted(set(queries))
        if current in data_set:
            self_and_sib = sorted({v for qq in queries for v in (qq, qq ^ 1)})
            n_k = len(self_and_sib)
            assert vcur + 4 * n_k <= values.size, "value witness exhausted"
            vals = values[vcur : vcur + 4 * n_k].reshape(n_k, 4)
            vcur += 4 * n_k
            qv = {k: vals[j] for j, k in enumerate(self_and_sib)}
            layer: Dict[int, np.ndarray] = {}
            if current == max_log:
                if hash_node_fn is None:
                    hashed = _hash_leaves_batch(vals)
                else:
                    hashed = [hash_node_fn(None, v) for v in vals]
                for j, k in enumerate(self_and_sib):
                    layer[k] = hashed[j]
            else:
                pairs = []
                for qq in self_and_sib:
                    l_idx, r_idx = qq << 1, (qq << 1) + 1
                    for idx in (l_idx, r_idx):
                        if idx not in hash_layers[-1]:
                            hash_layers[-1][idx] = take_hash()
                    pairs.append(
                        (hash_layers[-1][l_idx], hash_layers[-1][r_idx])
                    )
                hashed = batch_hash(pairs, vals)
                for j, qq in enumerate(self_and_sib):
                    layer[qq] = hashed[j]
            queries_values_map[current] = qv
            hash_layers.append(layer)
        else:
            assert current != max_log
            layer = {}
            pairs = []
            for qq in queries:
                l_idx, r_idx = qq << 1, (qq << 1) + 1
                for idx in (l_idx, r_idx):
                    if idx not in hash_layers[-1]:
                        hash_layers[-1][idx] = take_hash()
                pairs.append((hash_layers[-1][l_idx], hash_layers[-1][r_idx]))
            hashed = batch_hash(pairs, None)
            for j, qq in enumerate(queries):
                layer[qq] = hashed[j]
            hash_layers.append(layer)
        queries = [qq >> 1 for qq in queries]

    assert vcur == values.size, "unconsumed value witness"
    assert hcur == hw.shape[0], "unconsumed hash witness"
    assert len(hash_layers[-1]) == 1 and np.array_equal(hash_layers[-1][0], root)

    hash_node_ = hash_node_fn or hash_node
    Q = len(leaf_queries)
    depth = max_log
    sib = np.zeros((Q, max(depth - 1, 0), 8), np.uint32)
    self_cols = {lvl: np.zeros((Q, 4), np.uint32) for lvl in data_set}
    sib_cols = {lvl: np.zeros((Q, 4), np.uint32) for lvl in data_set}

    for qi, leaf_q in enumerate(leaf_queries):
        query = leaf_q
        si = 0
        for current in range(max_log, 0, -1):
            if current in data_set:
                self_cols[current][qi] = queries_values_map[current][query]
                sib_cols[current][qi] = queries_values_map[current][query ^ 1]
                if current != max_log:
                    sl, sr = (query ^ 1) << 1, ((query ^ 1) << 1) + 1
                    hl = hash_layers[max_log - current - 1]
                    sib[qi, si] = hash_node_((hl[sl], hl[sr]), np.array([]))
                    si += 1
            else:
                sib[qi, si] = hash_layers[max_log - current][query ^ 1]
                si += 1
            query >>= 1
    return sib, self_cols, sib_cols


def expand_pair_paths_batched(
    log_sizes_with_data: List[int],
    roots: List[np.ndarray],
    leaf_queries_list: List[List[int]],
    values_list: List[np.ndarray],
    decommitments: List[MerkleDecommitment],
    flavor: str = "p31",
) -> List[tuple]:
    """Batch twin of expand_pair_paths over B proofs (one FRI layer):
    identical per-proof witness order and outputs, one hash call per tree
    level for all proofs together."""
    leaves_fn, nodes_fn = _level_hashers(flavor)
    B = len(values_list)
    max_log = max(log_sizes_with_data)
    data_set = set(log_sizes_with_data)

    st = []
    for bi in range(B):
        assert len(decommitments[bi].column_witness) == 0
        st.append(
            dict(
                values=np.ascontiguousarray(values_list[bi], np.uint32).ravel(),
                vcur=0,
                hw=np.asarray(
                    decommitments[bi].hash_witness, np.uint32
                ).reshape(-1, 8),
                hcur=0,
                queries=list(leaf_queries_list[bi]),
                qvm={},   # level -> {idx: (4,) values}
                hash_layers=[],
            )
        )

    for current in range(max_log, -1, -1):
        jobs_pairs: List[tuple] = []
        jobs_cols: List[np.ndarray] = []
        jobs_owner: List[Tuple[int, int]] = []  # (proof, node idx)
        leaf_rows: List[np.ndarray] = []
        leaf_owner: List[Tuple[int, int]] = []
        for bi in range(B):
            s = st[bi]
            queries = sorted(set(s["queries"]))
            layer: Dict[int, np.ndarray] = {}
            if current in data_set:
                self_and_sib = sorted(
                    {v for qq in queries for v in (qq, qq ^ 1)}
                )
                n_k = len(self_and_sib)
                vals = s["values"][s["vcur"] : s["vcur"] + 4 * n_k]
                assert vals.size == 4 * n_k, "value witness exhausted"
                vals = vals.reshape(n_k, 4)
                s["vcur"] += 4 * n_k
                s["qvm"][current] = {
                    k: vals[j] for j, k in enumerate(self_and_sib)
                }
                if current == max_log:
                    leaf_rows.append(vals)
                    leaf_owner.extend((bi, k) for k in self_and_sib)
                else:
                    prev = s["hash_layers"][-1]
                    for j, qq in enumerate(self_and_sib):
                        l_idx, r_idx = qq << 1, (qq << 1) + 1
                        for idx in (l_idx, r_idx):
                            if idx not in prev:
                                assert s["hcur"] < s["hw"].shape[0]
                                prev[idx] = s["hw"][s["hcur"]]
                                s["hcur"] += 1
                        jobs_pairs.append((prev[l_idx], prev[r_idx]))
                        jobs_cols.append(vals[j])
                        jobs_owner.append((bi, qq))
            else:
                assert current != max_log
                prev = s["hash_layers"][-1]
                for qq in queries:
                    l_idx, r_idx = qq << 1, (qq << 1) + 1
                    for idx in (l_idx, r_idx):
                        if idx not in prev:
                            assert s["hcur"] < s["hw"].shape[0]
                            prev[idx] = s["hw"][s["hcur"]]
                            s["hcur"] += 1
                    jobs_pairs.append((prev[l_idx], prev[r_idx]))
                    jobs_cols.append(None)
                    jobs_owner.append((bi, qq))
            s["hash_layers"].append(layer)
            s["queries"] = [qq >> 1 for qq in queries]

        if leaf_rows:
            hashed = leaves_fn(np.concatenate(leaf_rows))
            for j, (bi, k) in enumerate(leaf_owner):
                st[bi]["hash_layers"][-1][k] = hashed[j]
        if jobs_owner:
            with_cols = jobs_cols[0] is not None
            hashed = nodes_fn(
                np.stack([p[0] for p in jobs_pairs]),
                np.stack([p[1] for p in jobs_pairs]),
                np.stack(jobs_cols) if with_cols else None,
            )
            for j, (bi, qq) in enumerate(jobs_owner):
                st[bi]["hash_layers"][-1][qq] = hashed[j]

    # sibling column-node recompute (final gather needs hash_node of the
    # sibling's children at data levels below the leaf) — batched too
    recompute_pairs = []
    recompute_owner: List[Tuple[int, int, int]] = []  # (proof, qi, si)
    for bi in range(B):
        s = st[bi]
        assert s["vcur"] == s["values"].size, "unconsumed value witness"
        assert s["hcur"] == s["hw"].shape[0], "unconsumed hash witness"
        assert len(s["hash_layers"][-1]) == 1 and np.array_equal(
            s["hash_layers"][-1][0], roots[bi]
        ), "pair tree root mismatch"

    Q_out = []
    for bi in range(B):
        s = st[bi]
        leaf_queries = leaf_queries_list[bi]
        Q = len(leaf_queries)
        depth = max_log
        sib = np.zeros((Q, max(depth - 1, 0), 8), np.uint32)
        self_cols = {lvl: np.zeros((Q, 4), np.uint32) for lvl in data_set}
        sib_cols = {lvl: np.zeros((Q, 4), np.uint32) for lvl in data_set}
        for qi, leaf_q in enumerate(leaf_queries):
            query = leaf_q
            si = 0
            for current in range(max_log, 0, -1):
                if current in data_set:
                    self_cols[current][qi] = s["qvm"][current][query]
                    sib_cols[current][qi] = s["qvm"][current][query ^ 1]
                    if current != max_log:
                        sl, sr = (query ^ 1) << 1, ((query ^ 1) << 1) + 1
                        hl = s["hash_layers"][max_log - current - 1]
                        recompute_pairs.append((hl[sl], hl[sr]))
                        recompute_owner.append((bi, qi, si))
                        si += 1
                else:
                    sib[qi, si] = s["hash_layers"][max_log - current][query ^ 1]
                    si += 1
                query >>= 1
        Q_out.append((sib, self_cols, sib_cols))

    if recompute_owner:
        hashed = nodes_fn(
            np.stack([p[0] for p in recompute_pairs]),
            np.stack([p[1] for p in recompute_pairs]),
            None,
        )
        for j, (bi, qi, si) in enumerate(recompute_owner):
            Q_out[bi][0][qi, si] = hashed[j]
    return Q_out


# ---------------------------------------------------------------------------
# FRI folding replay (host)
# ---------------------------------------------------------------------------

def _qm31_of(arr4) -> QM31:
    a = np.asarray(arr4, np.uint32)
    return QM31(a[..., 0], a[..., 1], a[..., 2], a[..., 3])


def _qm31_tuple(x: QM31, i=None):
    if i is None:
        return tuple(int(np.asarray(v).ravel()[0]) for v in x)
    return (int(x.a[i]), int(x.b[i]), int(x.c[i]), int(x.d[i]))


def rebuild_first_layer_evals(
    sorted_queries: List[int],
    log_size: int,
    query_evals: List[Tuple[int, int, int, int]],
    witness_iter,
):
    """Insert witness siblings; returns (pairs [(pos0, v_even, v_odd)], in
    sorted subset order) — hints/folding.rs:414-451."""
    queries = sorted(set(sorted_queries))
    qe = iter(query_evals)
    pairs = []
    i = 0
    while i < len(queries):
        qq = queries[i]
        start = (qq >> 1) << 1
        subset = [qq]
        if i + 1 < len(queries) and queries[i + 1] == start + 1:
            subset.append(queries[i + 1])
            i += 2
        else:
            i += 1
        vals = []
        it_subset = iter(subset)
        nxt = next(it_subset, None)
        for pos in (start, start + 1):
            if nxt == pos:
                vals.append(next(qe))
                nxt = next(it_subset, None)
            else:
                vals.append(next(witness_iter))
        pairs.append((start, vals[0], vals[1]))
    return pairs


def fold_circle_pair(v_even, v_odd, pos0: int, log_size: int, alpha: QM31) -> tuple:
    """(l+r) + alpha * (l-r) / y  at the even position's domain point."""
    dom = circle.CircleDomain(circle.Coset.half_odds(log_size - 1))
    _, py = dom.at(circle.bit_reverse_index(pos0, log_size))
    yinv = int(m31.inv(np.uint32(py)))
    l = q.q_scalar(*v_even)
    r = q.q_scalar(*v_odd)
    f0 = q.q_add(l, r)
    f1 = q.q_mul_m31(q.q_sub(l, r), np.uint32(yinv))
    return _qm31_tuple(q.q_add(f0, q.q_mul(f1, alpha)))


def fold_line_pair(v_even, v_odd, left_idx: int, log_size: int, alpha: QM31) -> tuple:
    """(l+r) + alpha * (l-r) / x at half_odds(log_size) bit-reversed index."""
    px, _ = circle.Coset.half_odds(log_size).at(
        circle.bit_reverse_index(left_idx, log_size)
    )
    xinv = int(m31.inv(np.uint32(px)))
    l = q.q_scalar(*v_even)
    r = q.q_scalar(*v_odd)
    f0 = q.q_add(l, r)
    f1 = q.q_mul_m31(q.q_sub(l, r), np.uint32(xinv))
    return _qm31_tuple(q.q_add(f0, q.q_mul(f1, alpha)))


# Vectorized fold twins: one call per (proof, layer) instead of one per
# query pair.  Bit-exact with the scalar versions above.

def _bitrev_arr(idx: np.ndarray, bits: int) -> np.ndarray:
    idx = np.asarray(idx, np.uint64)
    r = np.zeros_like(idx)
    for k in range(bits):
        r |= ((idx >> np.uint64(k)) & np.uint64(1)) << np.uint64(bits - 1 - k)
    return r


_ORDER = 1 << 31


def _coset_points(i_arr: np.ndarray, init_index: int, step_log: int,
                  n_bits: int):
    """Points at index init_index + i*2**step_log for an (N,) index array.

    Only the n_bits variable bits of i are scanned (vs 31 for the generic
    apoints_at_indices), with generator powers pre-shifted by step_log."""
    x0, y0 = circle.point_at_index(init_index)
    x = np.full(i_arr.shape, np.uint32(x0))
    y = np.full(i_arr.shape, np.uint32(y0))
    for k in range(n_bits):
        gx, gy = circle._gen_power_of_two(k + step_log)
        bit = ((i_arr >> np.uint64(k)) & np.uint64(1)).astype(bool)
        nx = m31.sub(m31.mul(x, np.uint32(gx)), m31.mul(y, np.uint32(gy)))
        ny = m31.add(m31.mul(x, np.uint32(gy)), m31.mul(y, np.uint32(gx)))
        x = np.where(bit, nx, x)
        y = np.where(bit, ny, y)
    return x, y


_ORDER_MASK = np.uint64((1 << 31) - 1)


def _circle_domain_y(pos: np.ndarray, log_size: int) -> np.ndarray:
    """y of CircleDomain(half_odds(log_size-1)) at bit-reversed positions.

    Coset index init + i*2^step collapses to one point_at_index lookup
    (index arithmetic mod 2^31), riding the native points kernel."""
    br = _bitrev_arr(pos, log_size)
    init = circle.subgroup_gen_index(log_size + 1)
    half = np.uint64(1 << (log_size - 1))
    i2 = np.where(br < half, br, br - half)
    # conjugate half: index -i has the same x and negated y
    full = (np.uint64(init) + (i2 << np.uint64(31 - (log_size - 1))))
    _, y = circle.apoints_at_indices(full & _ORDER_MASK)
    return np.where(br < half, y, m31.neg(y))


def _line_x(idx: np.ndarray, log_size: int) -> np.ndarray:
    """x of Coset.half_odds(log_size) at bit-reversed indices."""
    br = _bitrev_arr(idx, log_size)
    init = circle.subgroup_gen_index(log_size + 2)
    full = (np.uint64(init) + (br << np.uint64(31 - log_size)))
    x, _ = circle.apoints_at_indices(full & _ORDER_MASK)
    return x


def _q_rows(rows: np.ndarray) -> QM31:
    rows = np.asarray(rows, np.uint32)
    return QM31(rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3])


def _rows_of_q(x: QM31) -> np.ndarray:
    return np.stack(
        [np.asarray(c, np.uint32) for c in x], axis=-1
    )


def fold_circle_pairs(
    v_even: np.ndarray, v_odd: np.ndarray, pos0: np.ndarray,
    log_size: int, alpha: QM31,
) -> np.ndarray:
    """(N, 4) even/odd values at even positions pos0 -> (N, 4) folds."""
    yinv = m31.inv(_circle_domain_y(pos0, log_size))
    l, r = _q_rows(v_even), _q_rows(v_odd)
    f0 = q.q_add(l, r)
    f1 = q.q_mul_m31(q.q_sub(l, r), yinv)
    return _rows_of_q(q.q_add(f0, q.q_mul(f1, alpha)))


def fold_line_pairs(
    v_even: np.ndarray, v_odd: np.ndarray, left_idx: np.ndarray,
    log_size: int, alpha: QM31,
) -> np.ndarray:
    """(N, 4) pair values at even line indices -> (N, 4) folds."""
    xinv = m31.inv(_line_x(left_idx, log_size))
    l, r = _q_rows(v_even), _q_rows(v_odd)
    f0 = q.q_add(l, r)
    f1 = q.q_mul_m31(q.q_sub(l, r), xinv)
    return _rows_of_q(q.q_add(f0, q.q_mul(f1, alpha)))


# ---------------------------------------------------------------------------
# Full host preparation pipeline
# ---------------------------------------------------------------------------

def _fri_hints_native(spec: VerifierSpec, proofs, fs, answers,
                      flavor: str = "p31"):
    """Fused native FRI hint pipeline (pathexpand.cpp::rstpu_fri_fold_hints):
    first-layer rebuild + circle folds, inner-layer assembly + line folds,
    pair-path expansion per layer and the last-layer check, with the
    position-derived 1/y and 1/x tables precomputed here (vectorized).
    Bit-identical to the numpy path below."""
    from ..utils import native

    B = len(proofs)
    Q = spec.n_queries
    M = spec.max_first_layer_log
    n_inner = spec.n_inner_layers
    group_logs = list(spec.all_log_sizes)
    raw = (
        np.asarray(fs.raw_queries, np.uint32) & np.uint32((1 << M) - 1)
    ).astype(np.int64)

    ans = np.stack([_rows_of_q(a) for a in answers])
    alph = np.stack([_rows_of_q(a) for a in fs.fri_alphas])

    yinv = np.empty((len(group_logs), B, Q), np.uint32)
    for g, L in enumerate(group_logs):
        pos0 = (((raw >> (M - L)) >> 1) << 1).astype(np.uint64)
        yinv[g] = m31.inv(_circle_domain_y(pos0.ravel(), L)).reshape(B, Q)
    xinv = np.empty((max(n_inner, 1), B, Q), np.uint32)
    log_size = M
    for i in range(n_inner):
        log_size -= 1
        left = ((raw >> (i + 2)) << 1).astype(np.uint64)
        xinv[i] = m31.inv(_line_x(left.ravel(), log_size)).reshape(B, Q)

    final_log = M - n_inner - 1
    ll_coeffs = np.stack(
        [
            np.asarray(p.stark_proof.fri_proof.last_layer_poly, np.uint32)
            for p in proofs
        ]
    )
    n_doubles = ll_coeffs.shape[1].bit_length() - 1
    idx = (raw >> (n_inner + 1)).astype(np.uint64)
    x = _line_x(idx.ravel(), final_log).reshape(B, Q)
    ll_xs = np.empty((max(n_doubles, 1), B, Q), np.uint32)
    for d in range(n_doubles):
        ll_xs[d] = x
        x = circle.apoint_double_x(x)

    fls = [p.stark_proof.fri_proof.first_layer for p in proofs]
    for fl in fls:
        assert len(fl.decommitment.column_witness) == 0
    in_wit_lists, in_hw_lists = [], []
    for i in range(n_inner):
        layers = [p.stark_proof.fri_proof.inner_layers[i] for p in proofs]
        for layer in layers:
            assert len(layer.decommitment.column_witness) == 0
        in_wit_lists.append([la.fri_witness for la in layers])
        in_hw_lists.append([la.decommitment.hash_witness for la in layers])
    in_roots = (
        np.stack(
            [
                [
                    np.asarray(
                        p.stark_proof.fri_proof.inner_layers[i].commitment,
                        np.uint32,
                    )
                    for p in proofs
                ]
                for i in range(n_inner)
            ]
        )
        if n_inner
        else np.zeros((0, B, 8), np.uint32)
    )

    fl_sib, fl_self, fl_sibc, inner = native.fri_fold_hints(
        Q, M, group_logs, n_inner, raw, ans, alph, yinv, xinv,
        [fl.fri_witness for fl in fls],
        [fl.decommitment.hash_witness for fl in fls],
        np.stack([np.asarray(fl.commitment, np.uint32) for fl in fls]),
        in_wit_lists, in_hw_lists, in_roots, ll_coeffs, ll_xs,
        flavor=flavor,
    )
    # dict insertion order replicates the numpy twin (set iteration
    # order): the circuit layer's witness allocation iterates .items()
    slab_of = {L: g for g, L in enumerate(group_logs)}
    data_set = set(group_logs)
    first_layer_paths = PairPaths(
        sibling_hashes=fl_sib,
        self_columns={L: fl_self[slab_of[L]] for L in data_set},
        sibling_columns={L: fl_sibc[slab_of[L]] for L in data_set},
    )
    inner_layer_paths = tuple(
        PairPaths(
            sibling_hashes=sib,
            self_columns={M - 1 - i: self_c},
            sibling_columns={M - 1 - i: sib_c},
        )
        for i, (sib, self_c, sib_c) in enumerate(inner)
    )
    return first_layer_paths, inner_layer_paths


def _expand_single_stacked(
    depth: int,
    raw_list: List[List[int]],
    values_list: List[np.ndarray],
    n_columns_per_log_size: Dict[int, int],
    decommitments: List[MerkleDecommitment],
    roots: List[np.ndarray],
    batched_flavor,
    hash_node_fn,
) -> TreePaths:
    """Dispatch: C++ (native/pathexpand.cpp) -> level-batched numpy ->
    scalar fallback, all bit-identical."""
    from ..utils import native

    if batched_flavor in ("p31", "sha256") and native.available():
        for d in decommitments:
            assert len(d.column_witness) == 0
        sib, cols = native.expand_single_paths_batch(
            depth,
            np.asarray(raw_list, np.int64),
            values_list,
            n_columns_per_log_size,
            [np.asarray(d.hash_witness, np.uint32) for d in decommitments],
            np.stack([np.asarray(r, np.uint32) for r in roots]),
            flavor=batched_flavor,
        )
        return TreePaths(sibling_hashes=sib, columns=cols)
    if batched_flavor is not None:
        per_proof = expand_single_paths_batched(
            depth, raw_list, values_list, n_columns_per_log_size,
            decommitments, roots, flavor=batched_flavor,
        )
    else:
        per_proof = [
            expand_single_paths(
                depth, raw_list[bi], values_list[bi],
                n_columns_per_log_size, decommitments[bi], roots[bi],
                hash_node_fn=hash_node_fn,
            )
            for bi in range(len(values_list))
        ]
    return _stack_tree_paths(per_proof)


def _expand_pairs_stacked(
    log_sizes_with_data: List[int],
    roots: List[np.ndarray],
    leaf_queries_list: List[List[int]],
    values_list: List[np.ndarray],
    decommitments: List[MerkleDecommitment],
    batched_flavor,
    hash_node_fn,
) -> PairPaths:
    from ..utils import native

    if batched_flavor in ("p31", "sha256") and native.available():
        for d in decommitments:
            assert len(d.column_witness) == 0
        sib, self_cols, sib_cols = native.expand_pair_paths_batch(
            log_sizes_with_data,
            np.stack([np.asarray(r, np.uint32) for r in roots]),
            np.asarray(leaf_queries_list, np.int64),
            values_list,
            [np.asarray(d.hash_witness, np.uint32) for d in decommitments],
            flavor=batched_flavor,
        )
        return PairPaths(
            sibling_hashes=sib,
            self_columns=self_cols,
            sibling_columns=sib_cols,
        )
    if batched_flavor is not None:
        per_proof = expand_pair_paths_batched(
            log_sizes_with_data, roots, leaf_queries_list, values_list,
            decommitments, flavor=batched_flavor,
        )
    else:
        per_proof = [
            expand_pair_paths(
                log_sizes_with_data, roots[bi], leaf_queries_list[bi],
                values_list[bi], decommitments[bi],
                hash_node_fn=hash_node_fn,
            )
            for bi in range(len(values_list))
        ]
    return _stack_pair_paths(per_proof)


def _stack_tree_paths(per_proof: List[tuple]) -> TreePaths:
    sib = np.stack([p[0] for p in per_proof])
    keys = per_proof[0][1].keys()
    cols = {k: np.stack([p[1][k] for p in per_proof]) for k in keys}
    return TreePaths(sibling_hashes=sib, columns=cols)


def _stack_pair_paths(per_proof: List[tuple]) -> PairPaths:
    sib = np.stack([p[0] for p in per_proof])
    keys = per_proof[0][1].keys()
    self_cols = {k: np.stack([p[1][k] for p in per_proof]) for k in keys}
    sib_cols = {k: np.stack([p[2][k] for p in per_proof]) for k in keys}
    return PairPaths(sibling_hashes=sib, self_columns=self_cols, sibling_columns=sib_cols)


def host_fri_answers(spec: VerifierSpec, fs, pa: ProofArrays, tree_paths):
    """Quotients per group in raw-query order (numpy), (B, Q) QM31 per group."""
    from ..utils import native

    oods = points_mod.oods_point_from_t(fs.oods_t)
    half_pts = points_mod.half_index_points(
        spec, fs.raw_queries, spec.final_fold_log
    )
    if native.available() and isinstance(pa.samples_flat, np.ndarray):
        return _host_fri_answers_native(spec, fs, pa, tree_paths, oods,
                                        half_pts)
    answers = []
    for g, L in enumerate(spec.all_log_sizes):
        qL = transcript.queries_at_log_size(spec, fs.raw_queries, L)
        dx, dyq, _ = points_mod.domain_point(half_pts[L], qL)
        row_parts = [
            tree_paths[t].columns[L]
            for t in range(4)
            if L in tree_paths[t].columns
        ]
        rows = np.concatenate(row_parts, axis=-1)
        assert rows.shape[-1] == len(spec.group_columns[g])
        answers.append(
            quotients.fri_answers_for_group(
                spec, g, oods, fs.after_sampled_values_random_coeff,
                pa.samples_flat, rows, dx, dyq,
            )
        )
    return answers


def _host_fri_answers_native(spec, fs, pa, tree_paths, oods, half_pts):
    """C++ twin of the loop below (pathexpand.cpp::rstpu_fri_answers):
    identical quotient values, flat scalar accumulation instead of many
    small numpy ops (the dominant host-prep cost at small batch)."""
    from ..utils import native

    B, Q = np.asarray(fs.raw_queries).shape
    n_groups = len(spec.all_log_sizes)
    group_ncols = [len(spec.group_columns[g]) for g in range(n_groups)]
    qr_slabs = []
    dom_x = np.empty((n_groups, B, Q), np.uint32)
    dom_y = np.empty((n_groups, B, Q), np.uint32)
    for g, L in enumerate(spec.all_log_sizes):
        qL = transcript.queries_at_log_size(spec, fs.raw_queries, L)
        dx, dyq, _ = points_mod.domain_point(half_pts[L], qL)
        dom_x[g] = dx
        dom_y[g] = dyq
        rows = np.concatenate(
            [
                tree_paths[t].columns[L]
                for t in range(4)
                if L in tree_paths[t].columns
            ],
            axis=-1,
        )
        assert rows.shape[-1] == group_ncols[g]
        qr_slabs.append(rows)

    bg, bnc, li, six = [], [], [], []
    col_off = [0]
    px_rows, py_rows = [], []
    for g in range(n_groups):
        for (shift, tlog), cols in quotients.group_batches(spec, g):
            point = (
                oods
                if shift == 0
                else points_mod.shifted_oods_point(oods, shift, tlog)
            )
            px, py = point
            bg.append(g)
            bnc.append(len(cols))
            li.extend(c for c, _ in cols)
            six.extend(s for _, s in cols)
            col_off.append(len(li))
            px_rows.append(
                np.stack([np.asarray(c, np.uint32) for c in px], axis=-1)
            )
            py_rows.append(
                np.stack([np.asarray(c, np.uint32) for c in py], axis=-1)
            )

    rc = np.stack(
        [
            np.asarray(c, np.uint32)
            for c in fs.after_sampled_values_random_coeff
        ],
        axis=-1,
    )
    out = native.fri_answers(
        Q, group_ncols, np.asarray(pa.samples_flat, np.uint32), qr_slabs,
        dom_x, dom_y, rc, bg, bnc, col_off, li, six,
        np.stack(px_rows), np.stack(py_rows),
    )
    return [
        QM31(out[g, ..., 0], out[g, ..., 1], out[g, ..., 2], out[g, ..., 3])
        for g in range(n_groups)
    ]


def prepare(
    spec: VerifierSpec,
    proofs: List[PlonkWithPoseidonProof],
    arrays_fn=from_proofs,
    transcript_fn=None,
    hash_node_fn=None,
) -> ProofArrays:
    """Parse -> transcript replay -> path expansion -> batched tensors.

    arrays_fn/transcript_fn default to the with-poseidon flavor; pass
    (arrays.from_proofs_np, transcript.run_transcript_np) for
    PlonkWithoutPoseidon proofs — everything below is spec-generic.
    hash_node_fn overrides the Merkle node hash; the SHA-256 flavor
    (verifier/sha256_merkle.hash_node) is recognized and expanded through
    the level-batched AVX-512 path like the Poseidon default."""
    from . import sha256_merkle

    batched_flavor = None
    if hash_node_fn is None:
        batched_flavor = "p31"
    elif hash_node_fn is sha256_merkle.hash_node:
        batched_flavor = "sha256"
    # a proof claiming a different PcsConfig than the verifier's is
    # rejected upfront (the reference supplies the config as a trusted
    # constant, examples/single-proof/src/main.rs:28-31; the bundled
    # config bytes must agree or the proof is for another statement)
    expected_cfg = spec.config
    for p in proofs:
        cfg = getattr(p, "config", None)
        assert cfg is None or cfg == expected_cfg, "PcsConfig mismatch"
    pa = arrays_fn(spec, proofs)
    fs = (transcript_fn or transcript.run_transcript)(spec, pa)
    B = len(proofs)
    M = spec.max_first_layer_log

    # commitment-tree paths
    tree_paths = []
    for t in range(4):
        depth = spec.tree_max_domain_log[t]
        raw_list = [
            [
                int(v) >> (M - depth)
                for v in (fs.raw_queries[bi] & np.uint32((1 << M) - 1))
            ]
            for bi in range(B)
        ]
        tree_paths.append(
            _expand_single_stacked(
                depth,
                raw_list,
                [p.stark_proof.queried_values[t] for p in proofs],
                spec.n_columns_per_log_size[t],
                [p.stark_proof.decommitments[t] for p in proofs],
                [p.stark_proof.commitments[t] for p in proofs],
                batched_flavor,
                hash_node_fn,
            )
        )

    answers = host_fri_answers(spec, fs, pa, tree_paths)

    from ..utils import native as native_mod

    if batched_flavor in ("p31", "sha256") and native_mod.available():
        first_layer_paths, inner_layer_paths = _fri_hints_native(
            spec, proofs, fs, answers, batched_flavor
        )
        return pa._replace(
            tree_paths=tuple(tree_paths),
            first_layer_paths=first_layer_paths,
            inner_layer_paths=inner_layer_paths,
        )

    # first FRI layer: rebuild full pair evals, fold, expand pair paths.
    # Pair rebuilding stays per-proof python (witness order is sequential
    # per proof) but the circle folds are one call per group over ALL
    # proofs' pairs and path expansion hashes all proofs per level.
    raw_lists = [
        [int(v) for v in (fs.raw_queries[bi] & np.uint32((1 << M) - 1))]
        for bi in range(B)
    ]
    fl_values_list: List[np.ndarray] = []
    group_pairs = [
        {"pos": [], "ve": [], "vo": [], "bid": []}
        for _ in spec.all_log_sizes
    ]
    pair_slices: List[Dict[int, tuple]] = [dict() for _ in range(B)]
    for bi, proof in enumerate(proofs):
        raw_all = raw_lists[bi]
        witness_iter = iter(
            tuple(row)
            for row in np.asarray(
                proof.stark_proof.fri_proof.first_layer.fri_witness,
                np.uint32,
            ).tolist()
        )
        stream = []
        for g, L in enumerate(spec.all_log_sizes):
            qL_raw = [v >> (M - L) for v in raw_all]
            sorted_q = sorted(set(qL_raw))
            ans_rows = np.stack(
                [answers[g].a[bi], answers[g].b[bi],
                 answers[g].c[bi], answers[g].d[bi]], axis=-1
            ).tolist()
            ans_map = {
                qq: tuple(ans_rows[qi]) for qi, qq in enumerate(qL_raw)
            }
            query_evals = [ans_map[qq] for qq in sorted_q]
            pairs = rebuild_first_layer_evals(sorted_q, L, query_evals, witness_iter)
            gp = group_pairs[g]
            pair_slices[bi][g] = (len(gp["pos"]), len(pairs))
            for pos0, ve, vo in pairs:
                gp["pos"].append(pos0)
                gp["ve"].append(ve)
                gp["vo"].append(vo)
                gp["bid"].append(bi)
                stream.extend(ve)
                stream.extend(vo)
        assert next(witness_iter, None) is None
        fl_values_list.append(np.array(stream, np.uint32))

    folded_by_group: Dict[int, np.ndarray] = {}
    for g, L in enumerate(spec.all_log_sizes):
        gp = group_pairs[g]
        if gp["pos"]:
            alpha = fs.fri_alphas[M - L]
            bid = np.asarray(gp["bid"], np.int64)
            alpha_rows = QM31(
                alpha.a[bid], alpha.b[bid], alpha.c[bid], alpha.d[bid]
            )
            folded_by_group[g] = fold_circle_pairs(
                np.array(gp["ve"], np.uint32),
                np.array(gp["vo"], np.uint32),
                np.array(gp["pos"], np.uint64),
                L, alpha_rows,
            )
    folded_lists = {
        g: arr.tolist() for g, arr in folded_by_group.items()
    }
    folded_evals_all = []  # per proof: {L: [folded (sorted pair order)]}
    for bi in range(B):
        folded_evals = {}
        for g, L in enumerate(spec.all_log_sizes):
            off, n = pair_slices[bi][g]
            folded_evals[L] = [
                tuple(row) for row in folded_lists[g][off : off + n]
            ] if n else []
        folded_evals_all.append(folded_evals)

    first_layer_paths = _expand_pairs_stacked(
        list(spec.all_log_sizes),
        [p.stark_proof.fri_proof.first_layer.commitment for p in proofs],
        raw_lists,
        fl_values_list,
        [p.stark_proof.fri_proof.first_layer.decommitment for p in proofs],
        batched_flavor,
        hash_node_fn,
    )

    # inner layers — layer-major: per-proof python assembles the witness
    # streams (sequential consumption order per proof) while line folds and
    # path expansion run once per layer over all proofs.
    inner_paths: List[list] = [[] for _ in range(spec.n_inner_layers)]
    folded_state: List[Dict[int, tuple]] = [
        {qq >> 1: (0, 0, 0, 0) for qq in raw_lists[bi]} for bi in range(B)
    ]
    log_size = M
    for i in range(spec.n_inner_layers):
        alpha = fs.fri_alphas[i]
        alpha_next = fs.fri_alphas[i + 1]
        if log_size in folded_evals_all[0]:
            # fold-in mix: one batched q-op pass over all proofs' rows
            rows_cur, rows_add, bids, owners = [], [], [], []
            for bi in range(B):
                keys = sorted(folded_state[bi])
                rows_cur.extend(folded_state[bi][k] for k in keys)
                rows_add.extend(folded_evals_all[bi][log_size])
                bids.extend([bi] * len(keys))
                owners.extend((bi, k) for k in keys)
            bid = np.asarray(bids, np.int64)
            a_rows = QM31(
                alpha.a[bid], alpha.b[bid], alpha.c[bid], alpha.d[bid]
            )
            a2 = q.q_mul(a_rows, a_rows)
            cur = _q_rows(np.array(rows_cur, np.uint32))
            add = _q_rows(np.array(rows_add, np.uint32))
            mixed = _rows_of_q(q.q_add(q.q_mul(a2, cur), add)).tolist()
            for j, (bi, k) in enumerate(owners):
                folded_state[bi][k] = tuple(mixed[j])
        log_size -= 1

        streams: List[np.ndarray] = []
        all_le, all_ri, all_idx, bids, slices = [], [], [], [], []
        for bi, proof in enumerate(proofs):
            layer = proof.stark_proof.fri_proof.inner_layers[i]
            folded = folded_state[bi]
            wit = iter(
                tuple(row)
                for row in np.asarray(layer.fri_witness, np.uint32).tolist()
            )
            decommitmented = {}
            pair_items = {}  # left_idx -> (left_v, right_v)
            for k in sorted(folded):
                v = folded[k]
                sibling_v = folded[k ^ 1] if (k ^ 1) in folded else next(wit)
                left_v, right_v = (v, sibling_v) if k & 1 == 0 else (sibling_v, v)
                left_idx = (k >> 1) << 1
                decommitmented[left_idx] = left_v
                decommitmented[left_idx + 1] = right_v
                pair_items[left_idx] = (left_v, right_v)
            assert next(wit, None) is None
            left_idxs = sorted(pair_items)
            slices.append((len(all_idx), len(left_idxs)))
            for li in left_idxs:
                all_le.append(pair_items[li][0])
                all_ri.append(pair_items[li][1])
                all_idx.append(li)
                bids.append(bi)
            stream = []
            for kk in sorted(decommitmented):
                stream.extend(decommitmented[kk])
            streams.append(np.array(stream, np.uint32))

        bid = np.asarray(bids, np.int64)
        a_next_rows = QM31(
            alpha_next.a[bid], alpha_next.b[bid],
            alpha_next.c[bid], alpha_next.d[bid],
        )
        folded_rows = fold_line_pairs(
            np.array(all_le, np.uint32),
            np.array(all_ri, np.uint32),
            np.array(all_idx, np.uint64),
            log_size, a_next_rows,
        )
        folded_list = folded_rows.tolist()
        for bi in range(B):
            off, n = slices[bi]
            folded_state[bi] = {
                all_idx[off + j] >> 1: tuple(folded_list[off + j])
                for j in range(n)
            }

        layer_queries = [
            [qq >> (M - log_size) for qq in raw_lists[bi]] for bi in range(B)
        ]
        inner_paths[i] = _expand_pairs_stacked(
            [log_size],
            [p.stark_proof.fri_proof.inner_layers[i].commitment
             for p in proofs],
            layer_queries,
            streams,
            [p.stark_proof.fri_proof.inner_layers[i].decommitment
             for p in proofs],
            batched_flavor,
            hash_node_fn,
        )

    # last layer consistency (host-side sanity; device re-checks).
    # fold([c0..], [f0, f1, ..]) = fold(first half, rest) + f0 * fold(second
    # half, rest) — evaluated iteratively bottom-up: adjacent pairs combine
    # with the most-doubled factor first, one vectorized pass per level.
    log_size -= 1
    for bi, proof in enumerate(proofs):
        folded = folded_state[bi]
        coeffs = np.asarray(
            proof.stark_proof.fri_proof.last_layer_poly, np.uint32
        )
        idxs = sorted(folded)
        px = _line_x(np.array(idxs, np.uint64), log_size)
        doublings = []
        x = px
        for _ in range(coeffs.shape[0].bit_length() - 1):
            doublings.append(x)
            x = circle.apoint_double_x(x)

        # components shaped (n_coeffs, N)
        v = QM31(*(
            np.broadcast_to(coeffs[:, k : k + 1], (coeffs.shape[0], px.size))
            for k in range(4)
        ))
        for f in reversed(doublings):
            even = QM31(*(c[0::2] for c in v))
            odd = QM31(*(c[1::2] for c in v))
            v = q.q_add(even, q.q_mul_m31(odd, f))
        expected = np.stack(
            [np.asarray(c, np.uint32)[0] for c in v], axis=-1
        )
        got = np.array([folded[idx] for idx in idxs], np.uint32)
        assert np.array_equal(got, expected), "last layer mismatch"

    inner_layer_paths = tuple(inner_paths)

    return pa._replace(
        tree_paths=tuple(tree_paths),
        first_layer_paths=first_layer_paths,
        inner_layer_paths=inner_layer_paths,
    )
