"""The FRI witness plans (recursive_stwo_tpu_torch/prover/fri_plan.py) at
recursion-chain level 1's shape, the cell chain_level1.resident's:
`fast_prover`'s 80 queries over first-layer groups of log 21, 20 and 19 and
inner layers of log 20 down to 10, against the host witness functions
(prover/fri_host.py) on the identity evaluation, element for element and in
order.  Queries are drawn as fri_tail draws them (raw queries below 2**21,
each inner layer's one bit shorter than the last); 80 of them collide after
the shifts, and the duplicated and paired draws collide on purpose."""

import numpy as np
import pytest

from recursive_stwo_tpu_torch.core.qm31_host import QM31
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.prover import fri_host, fri_plan

N_QUERIES = flagship.PRESETS["fast_prover"].fri_config.n_queries
MAX_LOG = 21  # level 1's first-layer groups: 2^21, 2^20, 2^19
GROUP_LOGS = (21, 20, 19)
INNER_LOGS = tuple(range(20, 9, -1))  # its 11 inner layers


def _identity(L):
    idx = np.arange(1 << L, dtype=np.uint32)
    return QM31(idx, idx, idx, idx)


def _random(rng):
    return [int(v) for v in rng.integers(0, 1 << MAX_LOG, N_QUERIES)]


def _duplicated(rng):
    qs = _random(rng)[: N_QUERIES // 2]
    return qs + qs[::-1]


def _paired(rng):
    """Half the draws both members of a pair, half single queries,
    shuffled."""
    starts = [(v >> 1) << 1 for v in _random(rng)[: N_QUERIES // 4]]
    qs = [s + b for s in starts for b in (0, 1)] + _random(rng)[: N_QUERIES // 2]
    rng.shuffle(qs)
    return qs


def _clustered(rng):
    """Queries in one narrow window: they share pairs in the first layer and
    merge within a few inner layers."""
    base = int(rng.integers(0, (1 << MAX_LOG) - 4 * N_QUERIES))
    return [base + int(v) for v in rng.integers(0, 4 * N_QUERIES, N_QUERIES)]


DRAWS = {"random": _random, "duplicated": _duplicated, "paired": _paired, "clustered": _clustered}
SEEDS = [0, 7, 2**31 + 5, 2**40 + 9]


@pytest.fixture(scope="module")
def identities():
    return {L: _identity(L) for L in GROUP_LOGS}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("draw", list(DRAWS))
def test_level1_plans_match_host_witness(draw, seed, identities):
    raw = DRAWS[draw](np.random.default_rng(seed))
    assert len(raw) == N_QUERIES == 80
    want = fri_host.first_layer_witness(identities, raw, MAX_LOG)[:, 0].astype(np.int64)
    got = np.concatenate([fri_plan.first_layer_positions(raw, MAX_LOG, L) for L in GROUP_LOGS])
    np.testing.assert_array_equal(got, want)
    queries, collided = [v >> 1 for v in raw], 0
    for L in INNER_LOGS:
        want = fri_host.inner_layer_witness(_identity(L), queries)[:, 0].astype(np.int64)
        got = fri_plan.inner_layer_positions(queries)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        collided += len(set(queries)) < len(queries)
        queries = [v >> 1 for v in queries]
    # the duplicated, paired and clustered draws collide in every inner
    # layer (80 random ones in 2^10 positions do with probability 0.95)
    if draw != "random":
        assert collided == len(INNER_LOGS)
