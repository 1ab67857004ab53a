"""The FRI witness plans of the port (recursive_stwo_tpu_torch/prover/
fri_plan.py) against the host witness functions they replace on the decommit
path (prover/fri_host.py `first_layer_witness` / `inner_layer_witness`), run
on the identity evaluation: column 0 of their output is the positions they
gather, which the plans must give element for element and in order.  Queries
are seeded numpy, as fri_tail draws them (raw queries below 2**max_log, each
inner layer's one bit shorter than the last)."""

import time

import numpy as np
import pytest

from recursive_stwo_tpu_torch.core.qm31_host import QM31
from recursive_stwo_tpu_torch.prover import fri_host, fri_plan


def _identity(L):
    idx = np.arange(1 << L, dtype=np.uint32)
    return QM31(idx, idx, idx, idx)


def _random(seed, n, log):
    return [int(v) for v in np.random.default_rng(seed).integers(0, 1 << log, n)]


def _duplicated(seed, n, log):
    qs = _random(seed, n // 2, log)
    return qs + qs[::-1]


def _pairs(seed, n, log):
    """Both members of every pair queried: nothing left to gather."""
    starts = [(v >> 1) << 1 for v in _random(seed, n // 2, log)]
    return [s + b for s in starts for b in (0, 1)]


def _mixed(seed, n, log):
    """Half full pairs, half single queries, shuffled."""
    qs = _pairs(seed, n // 2, log) + _random(seed + 1, n // 2, log)
    np.random.default_rng(seed + 2).shuffle(qs)
    return qs


QUERIES = {"random": _random, "duplicated": _duplicated, "pairs": _pairs, "mixed": _mixed}

# (queries, n_queries, max_log, first-layer group logs); L - max_log large
# (the 4 and 6 bit groups under 16 queries) makes queries collide after the
# shift
FIRST_CASES = [
    ("random", 8, 16, (16,)),
    ("random", 16, 16, (16,)),
    ("random", 8, 12, (8,)),
    ("random", 16, 20, (6,)),
    ("random", 16, 16, (4,)),
    ("duplicated", 8, 14, (14,)),
    ("duplicated", 16, 16, (12,)),
    ("pairs", 8, 16, (16,)),
    ("pairs", 16, 10, (10,)),
    ("mixed", 16, 16, (16, 15)),
    ("random", 8, 16, (16, 15, 14)),
    ("random", 16, 18, (16, 9, 4)),
    ("mixed", 8, 13, (13, 12, 11, 10)),
]


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
@pytest.mark.parametrize("kind,n,max_log,logs", FIRST_CASES)
def test_first_layer_positions_match_host_witness(kind, n, max_log, logs, seed):
    raw = QUERIES[kind](seed, n, max_log)
    want = fri_host.first_layer_witness({L: _identity(L) for L in logs}, raw, max_log)[:, 0].astype(np.int64)
    got = np.concatenate([fri_plan.first_layer_positions(raw, max_log, L) for L in sorted(logs, reverse=True)])
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if kind == "pairs" and logs == (max_log,):
        assert got.size == 0


# (queries, n_queries, layer log, inner layers folded below the raw draw)
INNER_CASES = [
    ("random", 8, 16, 0),
    ("random", 16, 16, 0),
    ("random", 8, 12, 3),
    ("random", 16, 4, 0),
    ("random", 16, 6, 10),
    ("duplicated", 8, 10, 0),
    ("duplicated", 16, 14, 2),
    ("pairs", 8, 16, 0),
    ("pairs", 16, 8, 0),
    ("mixed", 16, 15, 0),
    ("mixed", 8, 5, 7),
]


@pytest.mark.parametrize("seed", [1, 2**32 + 3])
@pytest.mark.parametrize("kind,n,L,shift", INNER_CASES)
def test_inner_layer_positions_match_host_witness(kind, n, L, shift, seed):
    queries = [v >> shift for v in QUERIES[kind](seed, n, L + shift)]
    want = fri_host.inner_layer_witness(_identity(L), queries)[:, 0].astype(np.int64)
    got = fri_plan.inner_layer_positions(queries)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if kind == "pairs" and shift == 0:
        assert got.size == 0


@pytest.mark.parametrize("n", [8, 16])
def test_plans_scale_with_the_queries_not_the_layer(n):
    """At max_log = L = 40 an identity evaluation would be 2**40 rows; the
    plans see only the queries."""
    log = 40
    raw = _mixed(5, n, log)
    t0 = time.perf_counter()
    first = fri_plan.first_layer_positions(raw, log, log)
    inner = fri_plan.inner_layer_positions(raw)
    assert time.perf_counter() - t0 < 0.1
    qset = set(raw)
    for got in (first, inner):
        assert 0 < got.size <= n
        assert not qset & set(got.tolist())
        assert all((int(p) ^ 1) in qset for p in got)
        assert int(got.max()) < 1 << log
