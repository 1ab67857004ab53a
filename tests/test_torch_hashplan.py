"""The port's hash-plan passes (absorb_packed, leaf_rate_many, walk_scan)
against the JAX package's on the synthetic walks of tests/test_hashplan.py:
capacity digests, leaf hashes and verdicts, reference on numpy and on
jax.numpy inputs.  Tolerance 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recursive_stwo_tpu.verifier import hashplan as r_hp
from recursive_stwo_tpu_torch.verifier import hashplan as t_hp
from test_hashplan import B, Q, _build_single


@pytest.fixture(scope="module")
def walks():
    rng = np.random.default_rng(7)
    return [
        _build_single(rng, 6, [2, 4]),
        _build_single(rng, 9, [0]),
        _build_single(rng, 4, []),
    ]


def _run(hp, walks_raw, cast):
    """Chains -> digests -> leaves -> walks through one hashplan module;
    returns (capacity digests, leaf hashes, verdicts)."""
    chains, chain_of = [], []
    for w in walks_raw:
        chain_of.append(
            dict(leaf=len(chains),
                 cols={h: len(chains) + 1 + i for i, h in enumerate(sorted(w["col_cols"]))})
        )
        chains.append(cast(w["leaf_cols"]))
        for h in sorted(w["col_cols"]):
            chains.append(cast(w["col_cols"][h]))
    digests = hp.absorb_packed(chains)
    leafs = hp.leaf_rate_many([digests[c["leaf"]] for c in chain_of])
    singles = [
        hp.SingleWalk(
            depth=w["depth"],
            queries=cast(w["queries"]),
            sibling_hashes=cast(w["sibling_hashes"]),
            col_caps={h: digests[chain_of[i]["cols"][h]] for h in w["col_cols"]},
            leaf=leafs[i],
            root=cast(w["root"]),
        )
        for i, w in enumerate(walks_raw)
    ]
    oks, _ = hp.walk_scan(singles, [])
    return digests, leafs, oks


def _port(walks_raw):
    digests, leafs, oks = _run(
        t_hp, walks_raw, lambda x: torch.from_numpy(np.asarray(x).astype(np.int64))
    )
    to_np = lambda ds: [d.numpy().reshape(8, B, Q) for d in ds]  # noqa: E731
    return to_np(digests), to_np(leafs), [o.numpy() for o in oks]


def _reference(walks_raw, cast):
    digests, leafs, oks = _run(r_hp, walks_raw, cast)
    to_np = lambda ds: [  # noqa: E731
        np.asarray(r_hp._from_lm(np.asarray(d), B, Q)).astype(np.int64) for d in ds
    ]
    return to_np(digests), to_np(leafs), [np.asarray(o) for o in oks]


@pytest.mark.parametrize("backend", ["np", "jnp"])
def test_passes_match_reference(walks, backend):
    cast = (lambda x: x) if backend == "np" else jnp.asarray
    ref, got = _reference(walks, cast), _port(walks)
    for r_list, g_list in zip(ref, got):
        assert len(r_list) == len(g_list)
        for r, g in zip(r_list, g_list):
            assert np.array_equal(r, g)
    for ok in got[2]:
        assert ok.shape == (B,) and ok.all()


def test_wrong_root_flips_only_that_walk(walks):
    bad = [dict(w) for w in walks]
    bad[1] = dict(bad[1], root=bad[1]["root"] ^ 1)
    oks = _port(bad)[2]
    assert oks[0].all() and oks[2].all() and not oks[1].any()


def test_corrupt_sibling_flips_only_that_walk(walks):
    bad = [dict(w) for w in walks]
    sib = bad[0]["sibling_hashes"].copy()
    sib[1, :, 2, 3] ^= 1  # proof 1 only
    bad[0] = dict(bad[0], sibling_hashes=sib)
    ref_oks = _reference(bad, lambda x: x)[2]
    oks = _port(bad)[2]
    for r, g in zip(ref_oks, oks):
        assert np.array_equal(r, g)
    assert not oks[0][1] and oks[0][[0, 2]].all()
    assert oks[1].all() and oks[2].all()


def test_chain_without_columns_has_zero_digest():
    chains = [np.zeros((B, Q, 0), np.uint32), np.ones((B, Q, 3), np.uint32)]
    ref = [r_hp._from_lm(d, B, Q).astype(np.int64) for d in r_hp.absorb_packed(chains)]
    got = t_hp.absorb_packed([torch.from_numpy(c.astype(np.int64)) for c in chains])
    for r, g in zip(ref, got):
        assert np.array_equal(r, g.numpy().reshape(8, B, Q))
    assert not got[0].any() and got[1].any()


# ---------------------------------------------------------------------------
# The op table and its descriptors (what the scan kernel reads on CUDA),
# run through scan_plain on the CPU
# ---------------------------------------------------------------------------

from recursive_stwo_tpu_torch.ops import poseidon_cuda  # noqa: E402
from recursive_stwo_tpu_torch.tools import scan_cases  # noqa: E402
from test_hashplan import _col_cap, _leaf_fin, _node, _rand  # noqa: E402

N = B * Q


def _build_pair(rng, depth, col_levels):
    """A consistent FRI pair walk (the semantics of _pair_prog): columns of
    4 (self) and 11 (sibling) words at `col_levels` (all >= 1), every query
    of a proof on one path; returns the raw arrays and the (B, Q, 8) digest."""
    rep = lambda a: np.repeat(a, Q, axis=1)  # noqa: E731
    queries = rep(rng.integers(0, 1 << depth, (B, 1)).astype(np.uint32))
    sib = rep(_rand(rng, B, 1, depth - 1, 8))
    self_leaf_cols, sib_leaf_cols = rep(_rand(rng, B, 1, 4)), rep(_rand(rng, B, 1, 11))
    self_cols = {h: rep(_rand(rng, B, 1, 4)) for h in col_levels}
    sib_cols = {h: rep(_rand(rng, B, 1, 11)) for h in col_levels}
    col_at = {depth - 1 - h: h for h in col_levels}
    cur, carry_b = _leaf_fin(_col_cap(self_leaf_cols)), None
    for t in range(depth):
        if t == 0:
            b = _leaf_fin(_col_cap(sib_leaf_cols))
        elif (t - 1) in col_at:
            b = carry_b
        else:
            b = sib[:, :, t - 1]
        bit = ((queries >> t) & 1)[..., None] != 0
        cur = _node(np.where(bit, b, cur), np.where(bit, cur, b))
        if t in col_at:
            h = col_at[t]
            cur = _node(cur, _col_cap(self_cols[h]))
            carry_b = _node(sib[:, :, t], _col_cap(sib_cols[h]))
    return dict(depth=depth, queries=queries, sibling_hashes=sib, self_leaf_cols=self_leaf_cols,
                sib_leaf_cols=sib_leaf_cols, self_cols=self_cols, sib_cols=sib_cols,
                root=cur[:, 0], digest=cur)


@pytest.fixture(scope="module")
def pair_walks():
    rng = np.random.default_rng(11)
    return [_build_pair(rng, 6, [1, 3]), _build_pair(rng, 4, []), _build_pair(rng, 5, [2])]


def _walk_objects(hp, singles_raw, pairs_raw, cast):
    """Chains -> digests -> leaves -> (singles, pairs) through one hashplan module."""
    chains, idx = [], {}

    def add(key, arr):
        idx[key] = len(chains)
        chains.append(cast(arr))

    for i, w in enumerate(singles_raw):
        add(("s", i), w["leaf_cols"])
        for h in sorted(w["col_cols"]):
            add(("s", i, h), w["col_cols"][h])
    for j, w in enumerate(pairs_raw):
        add(("self", j), w["self_leaf_cols"])
        add(("sib", j), w["sib_leaf_cols"])
        for h in sorted(w["self_cols"]):
            add(("self", j, h), w["self_cols"][h])
            add(("sib", j, h), w["sib_cols"][h])
    digests = hp.absorb_packed(chains)
    leaf_keys = [("s", i) for i in range(len(singles_raw))]
    leaf_keys += [(k, j) for j in range(len(pairs_raw)) for k in ("self", "sib")]
    leaf = dict(zip(leaf_keys, hp.leaf_rate_many([digests[idx[k]] for k in leaf_keys])))
    singles = [
        hp.SingleWalk(depth=w["depth"], queries=cast(w["queries"]),
                      sibling_hashes=cast(w["sibling_hashes"]),
                      col_caps={h: digests[idx[("s", i, h)]] for h in w["col_cols"]},
                      leaf=leaf[("s", i)], root=cast(w["root"]))
        for i, w in enumerate(singles_raw)
    ]
    pairs = [
        hp.PairWalk(depth=w["depth"], queries=cast(w["queries"]),
                    sibling_hashes=cast(w["sibling_hashes"]),
                    self_caps={h: digests[idx[("self", j, h)]] for h in w["self_cols"]},
                    sib_caps={h: digests[idx[("sib", j, h)]] for h in w["sib_cols"]},
                    self_leaf=leaf[("self", j)], sib_leaf=leaf[("sib", j)], root=cast(w["root"]))
        for j, w in enumerate(pairs_raw)
    ]
    return chains, singles, pairs


def _port_cast(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("backend", ["np", "jnp"])
def test_pair_walks_match_reference(walks, pair_walks, backend):
    """Singles and pair walks with column levels (sibcol ops writing carry_b):
    the port's per-walk digests equal the model's, and its verdicts the JAX
    package's walk_scan's, all accepting."""
    cast = (lambda x: x) if backend == "np" else jnp.asarray
    _, r_singles, r_pairs = _walk_objects(r_hp, walks, pair_walks, cast)
    r_oks = [np.asarray(o) for o in sum(r_hp.walk_scan(r_singles, r_pairs), [])]
    _, singles, pairs = _walk_objects(t_hp, walks, pair_walks, _port_cast)
    prog = t_hp.walk_program(singles, pairs)
    assert any(f & poseidon_cuda.WRITE_B for f in prog.ops[..., poseidon_cuda.F_FLAGS].flatten().tolist())
    digests = t_hp.scan_plain(prog)
    for j, w in enumerate(pair_walks):
        assert np.array_equal(digests[len(walks) + j].numpy(), w["digest"].reshape(N, 8).T.astype(np.int64))
    oks = [o.numpy() for o in sum(t_hp.walk_scan(singles, pairs), [])]
    for r, g in zip(r_oks, oks):
        assert np.array_equal(r, g) and g.all()


def test_pair_walk_corrupt_sibling_matches_reference(walks, pair_walks):
    """A flipped sibling hash in proof 1 at a level that a sibcol op reads
    (pair 0, level 2 at t=2) and at one read raw by a node op (pair 2)."""
    bad = [dict(w) for w in pair_walks]
    for j, level in ((0, 2), (2, 0)):
        sib = bad[j]["sibling_hashes"].copy()
        sib[1, :, level, 5] ^= 1
        bad[j] = dict(bad[j], sibling_hashes=sib)
    r_oks = [np.asarray(o) for o in r_hp.walk_scan(*_walk_objects(r_hp, walks, bad, lambda x: x)[1:])[1]]
    oks = [o.numpy() for o in t_hp.walk_scan(*_walk_objects(t_hp, walks, bad, _port_cast)[1:])[1]]
    for r, g in zip(r_oks, oks):
        assert np.array_equal(r, g)
    assert not oks[0][1] and oks[0][[0, 2]].all()
    assert oks[1].all()
    assert not oks[2][1] and oks[2][[0, 2]].all()


def test_lanes_ending_early(walks):
    """Three single walks of 10, 8 and 4 ops in four lanes: the lanes end at
    different steps (one is empty), and each walk's digest is its root."""
    _, singles, _ = _walk_objects(t_hp, walks, [], _port_cast)
    prog = t_hp.walk_program(singles, [])
    active = (prog.ops[..., poseidon_cuda.F_FLAGS] & poseidon_cuda.ACTIVE) != 0
    assert sorted(active.sum(dim=1).tolist()) == [0, 4, 8, 10]
    assert poseidon_cuda.scan_permutations(prog.ops, prog.n) == 22 * N
    digests = t_hp.scan_plain(prog)
    for wi, w in enumerate(walks):
        assert np.array_equal(digests[wi].numpy(), np.repeat(w["root"], Q, axis=0).T.astype(np.int64))


@pytest.mark.parametrize("backend", ["np", "jnp"])
def test_absorb_widths_match_reference(backend):
    """Chains of 0, 1, 3, 8, 11, 17 and 24 columns, one a strided view: the
    chunks past a chain's end read as zeros, a chain of none has digest 0."""
    rng = np.random.default_rng(5)
    widths = (0, 1, 3, 8, 11, 17, 24)
    chains = [_rand(rng, B, Q, w) for w in widths]
    cast = (lambda x: x) if backend == "np" else jnp.asarray
    ref = [r_hp._from_lm(np.asarray(d), B, Q).astype(np.int64) for d in r_hp.absorb_packed([cast(c) for c in chains])]
    ported = [_port_cast(c) for c in chains]
    ported[4] = _port_cast(np.concatenate([chains[4], chains[3]], axis=-1))[:, :, :11]  # a view
    prog = t_hp.absorb_program(ported)
    assert any(0 < nw < 8 for nw in prog.ops[..., poseidon_cuda.F_A + 4].flatten().tolist())
    got = t_hp.scan_plain(prog)
    for r, g in zip(ref, got):
        assert np.array_equal(r, g.numpy().reshape(8, B, Q))
    assert not got[0].any()


def _reference_lanes(progs, lanes=t_hp.LANES):
    """The JAX package's greedy packing of per-walk (or per-chain) programs."""
    order = sorted(range(len(progs)), key=lambda i: -len(progs[i]))
    lane_prog = [[] for _ in range(lanes)]
    for i in order:
        ln = min(range(lanes), key=lambda l: len(lane_prog[l]))
        lane_prog[ln].extend(progs[i])
    return lane_prog


def _dense(x):
    return None if x is None else r_hp._from_lm(np.asarray(x), B, Q).reshape(8, N).astype(np.int64)


def _same(ref, got):
    return (ref is None and got is None) or np.array_equal(ref, got.numpy())


def test_descriptors_decode_to_reference_dense_tables(walks, pair_walks):
    """Every (lane, step) of the port's op tables, read through its
    descriptors, gives the in_a, in_b and query bit that the JAX package's
    scan bodies find in their dense (T, lanes, 8, R, 128) tables, with the
    same wiring flags and output slots."""
    chains_np, r_singles, r_pairs = _walk_objects(r_hp, walks, pair_walks, lambda x: x)
    chains, singles, pairs = _walk_objects(t_hp, walks, pair_walks, _port_cast)
    R = r_hp._n_rows(B, Q)
    pc = poseidon_cuda

    # walks
    r_progs = [r_hp._single_prog(wk, wi, R) for wi, wk in enumerate(r_singles)]
    r_progs += [r_hp._pair_prog(wk, wi + len(r_singles), R) for wi, wk in enumerate(r_pairs)]
    prog = t_hp.walk_program(singles, pairs)
    for ln, lane in enumerate(_reference_lanes(r_progs)):
        for t, s in enumerate(lane):
            in_a, in_b, bit = t_hp.step_inputs(prog, ln, t)
            fl = int(prog.ops[ln, t, pc.F_FLAGS])
            assert _same(_dense(s["in_a"]), in_a) and _same(_dense(s["in_b"]), in_b)
            ref_bit = None if s["bit"] is None else np.asarray(s["bit"]).reshape(-1)[:N] != 0
            assert (ref_bit is None and bit is None) or np.array_equal(ref_bit, bit.numpy())
            assert bool(fl & pc.A_IN) == (s["a_sel"] == r_hp._A_IN)
            assert (fl >> pc.B_SEL_SHIFT) & 3 == s["b_sel"]
            assert bool(fl & pc.WRITE_B) == s["write_b"] and bool(fl & pc.SWAP) == s["swap"]
            assert int(prog.ops[ln, t, pc.F_OUT]) == (s["walk"] if s.get("last") else -1)
        assert len(lane) == len(prog.ops[ln]) or not int(prog.ops[ln, len(lane), pc.F_FLAGS]) & pc.ACTIVE

    # absorb: the reference's lane-major chunks, chains padded to 8 columns
    r_chunked = []
    for ci, c in enumerate(chains_np):
        c = np.concatenate([c, np.zeros(c.shape[:-1] + ((-c.shape[-1]) % 8,), np.uint32)], axis=-1)
        c = c.reshape(B, Q, -1, 8)
        n = c.shape[2]
        r_chunked.append([(r_hp._to_lm(c[:, :, k], R), k == 0, ci if k == n - 1 else -1) for k in range(n)])
    prog = t_hp.absorb_program(chains)
    for ln, lane in enumerate(_reference_lanes(r_chunked)):
        for t, (chunk, start, oid) in enumerate(lane):
            in_a, in_b, bit = t_hp.step_inputs(prog, ln, t)
            fl = int(prog.ops[ln, t, pc.F_FLAGS])
            assert _same(_dense(chunk), in_a) and in_b is None and bit is None
            assert bool(fl & pc.START) == start and int(prog.ops[ln, t, pc.F_OUT]) == oid


def test_scan_wrapper_checks_descriptors_and_device():
    """The CUDA wrapper refuses sources off the card (no fallback), and its
    pointer pass refuses a descriptor that reads past its source."""
    prog = scan_cases.seeded_programs(5, 4, 0, "cpu")[1][1]
    with pytest.raises(ValueError, match="CUDA"):
        poseidon_cuda.wordmajor_scan(prog.ops, prog.sources, prog.n_out, prog.n, False)
    table = poseidon_cuda._resolve(prog.ops, prog.sources, prog.n_out, prog.n)
    row = prog.ops[0, 0].tolist()
    src = prog.sources[row[poseidon_cuda.F_B]]
    assert int(table[0, 0, poseidon_cuda.F_B]) == src.data_ptr() + 8 * row[poseidon_cuda.F_B + 1]
    bad = prog.ops.clone()
    bad[0, 0, poseidon_cuda.F_B + 2] = 10**6  # stride_n far past the source
    with pytest.raises(ValueError, match="outside"):
        poseidon_cuda._resolve(bad, prog.sources, prog.n_out, prog.n)
    bad = prog.ops.clone()
    bad[0, 0, poseidon_cuda.F_OUT] = prog.n_out
    with pytest.raises(ValueError, match="output slots"):
        poseidon_cuda._resolve(bad, prog.sources, prog.n_out, prog.n)
    # an op that reads a descriptor without a source (a null pointer on the card)
    fl = prog.ops[..., poseidon_cuda.F_FLAGS]
    b_sel = (fl >> poseidon_cuda.B_SEL_SHIFT) & 3
    for field, reads in ((poseidon_cuda.F_A, (fl & poseidon_cuda.A_IN) != 0),
                         (poseidon_cuda.F_A, b_sel == poseidon_cuda.B_IN_A),
                         (poseidon_cuda.F_B, b_sel == poseidon_cuda.B_IN_B),
                         (poseidon_cuda.F_Q, (fl & poseidon_cuda.SWAP) != 0)):
        ln, t = (int(i) for i in (((fl & poseidon_cuda.ACTIVE) != 0) & reads).nonzero()[0])
        bad = prog.ops.clone()
        bad[ln, t, field] = -1
        with pytest.raises(ValueError, match="no source"):
            poseidon_cuda._resolve(bad, prog.sources, prog.n_out, prog.n)


@pytest.mark.parametrize("lanes", [1, 4])
def test_seeded_programs_cover_every_op_kind(lanes):
    """The programs the card holds the kernel to (chip_smoke phase 3, the
    cuda tests) run on the CPU through scan_plain and hold every op kind."""
    pc = poseidon_cuda
    (_, absorb), (_, walk) = scan_cases.seeded_programs(7, 4, 1, "cpu")
    fl = walk.ops[..., pc.F_FLAGS]
    kinds = {(int(f) >> pc.B_SEL_SHIFT) & 3 for f in fl[(fl & pc.ACTIVE) != 0]}
    assert kinds == {pc.B_CARRY_B, pc.B_IN_A, pc.B_IN_B}
    assert ((fl & pc.SWAP) != 0).any() and ((fl & pc.WRITE_B) != 0).any()
    last = [int(fl[ln][(fl[ln] & pc.ACTIVE) != 0][-1]) for ln in range(4)]
    assert any(f & pc.WRITE_B for f in last)
    assert ((absorb.ops[..., pc.F_FLAGS] & pc.START) != 0).any()
    for _, prog in scan_cases.seeded_programs(7, lanes, 1, "cpu"):
        out = t_hp.scan_plain(prog)
        assert out.shape == (prog.n_out, 8, 7) and bool(((out >= 0) & (out < 2**31 - 1)).all())
