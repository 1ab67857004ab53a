"""The FRI last layer of the port (recursive_stwo_tpu_torch/prover/fri_last.py)
against the JAX package's flow (recursive_stwo_tpu/prover/fri.py
`line_interpolate`, then the kept positions and the degree check, as the
port's prover/fri.py ran it on its host copy), bit for bit, and the host side
of its CUDA kernel.

Layers are seeded (tools/prover_cases.last_layer_case: random coefficients
below the bound, planted ones past it).  The twiddle table is held to the
copy's own coset points; a numpy model of the kernel's two phases
(csrc/fri_fold.cu `fri_last_kernel`: slabs, the scratch columns, tiles, the
write index and the counts), at the kernel's constants and at smaller slabs,
to the plain version.  The kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import os
import re

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.core.qm31 import QM31
from recursive_stwo_tpu.prover import fri as r_fri
from recursive_stwo_tpu_torch.core import circle_host
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.ops import fri_fold_cuda
from recursive_stwo_tpu_torch.prover import fri_last
from recursive_stwo_tpu_torch.prover.prove import prove
from recursive_stwo_tpu_torch.tools import prover_cases as cases
from recursive_stwo_tpu_torch.verifier.spec import VerifierSpec

P = 2**31 - 1
META = dict(device="meta", dtype=torch.int64)
CASES = [(1, 0), (2, 1), (4, 2), (9, 0), (12, 5), (16, 7)]
SOURCE = os.path.join(os.path.dirname(fri_fold_cuda.__file__), "..", "csrc", "fri_fold.cu")


def _jax_flow(g: torch.Tensor, level: int, bound: int) -> np.ndarray:
    """prover/fri.py's last layer before fri_last: the JAX package's host
    interpolation, the kept positions and the degree check."""
    full = r_fri.line_interpolate(QM31(*g.numpy().astype(np.uint32)), level)
    keep = np.arange(1 << bound) << (level - bound)
    mask = np.zeros(1 << level, bool)
    mask[keep] = True
    if full[~mask].any():
        raise ValueError("folded evaluations exceed the last-layer degree bound")
    return full[keep]


@pytest.mark.parametrize("level,bound", CASES)
def test_last_layer_poly_matches_the_copy(level, bound):
    """The plain version (what a CPU tensor takes) gives the JAX package's
    kept coefficients, bit for bit, in its dtype and layout."""
    case = cases.last_layer_case(level, bound, "cpu", seed=level)
    want = _jax_flow(case.g, level, bound)
    got = fri_last.last_layer_poly(case.g, level, bound)
    assert got.dtype == want.dtype == np.uint32 and got.shape == (1 << bound, 4)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("level,bound", [(2, 1), (9, 0), (12, 5), (16, 7)])
def test_a_coefficient_past_the_bound_raises(level, bound):
    """A planted coefficient past the kept ones (the first such position and
    the last) raises the same ValueError in both."""
    for p in (1 << bound, (1 << level) - 1):
        case = cases.last_layer_case(level, bound, "cpu", seed=p, planted=(p,))
        for run in (_jax_flow, fri_last.last_layer_poly):
            with pytest.raises(ValueError, match=fri_last.DEGREE_ERROR):
                run(case.g, level, bound)


@pytest.mark.parametrize("log", range(1, 11))
def test_twiddles_are_the_copys_inverse_x(log):
    """Round L's table is the inverse of the x the copy divides by: its coset
    points from one `Coset.half_odds(log).at(bit_reverse_index(i))` a point,
    the even ones doubled L times, inverted by Python's pow (inv(0) = 0)."""
    n = 1 << log
    coset = circle_host.Coset.half_odds(log)
    x = [int(coset.at(circle_host.bit_reverse_index(i, log))[0]) for i in range(n)]
    tw = fri_last.twiddles(log, torch.device("cpu")).tolist()
    assert len(tw) == n - 1
    for L in range(log):
        want = [pow(v, P - 2, P) for v in x[0::2]]
        assert tw[n - (n >> L) : n - (n >> L) + len(want)] == want, L
        x = [(2 * v * v - 1) % P for v in x[0::2]]


def _constants() -> dict:
    with open(SOURCE) as f:
        src = f.read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
            for k in ("kSlabLog", "kMaxRowLog", "kMaxClusterLog")}


def _kernel_model(g: np.ndarray, tw: np.ndarray, level: int, bound: int, slab_log: int, cluster_log: int):
    """fri_last_kernel's output words, block by block: a column's cluster of
    2**min(k2, cluster_log) ranks; phase 1's slabs into the scratch column,
    then phase 2's tiles, the product by 2**-level, the write index and each
    rank's count added to the column's; the butterflies of a round at once
    (they are disjoint)."""
    k1 = min(level, slab_log)
    k2, n = level - k1, 1 << level
    logw, half = k1 - k2, 1 << (k1 - 1)
    ranks, units, u = 1 << min(k2, cluster_log), 1 << k2, np.arange(half)
    scale = pow(2, -level, P)
    out = np.full((4 << bound) + 4, -1, np.int64)  # a word never written shows
    for col in range(4):
        mid = np.full(n, -1, np.int64)
        for rank in range(ranks):
            for s in range(rank, units, ranks):
                base = s << k1
                v = g[col, base : base + (1 << k1)].copy()
                for L in range(k1):
                    lo = ((u >> L) << (L + 1)) | (u & ((1 << L) - 1))
                    t = tw[n - (n >> L) + ((base + lo) >> (L + 1))]
                    a, b = v[lo], v[lo + (1 << L)]
                    v[lo], v[lo + (1 << L)] = (a + b) % P, (a - b) % P * t % P
                mid[base : base + (1 << k1)] = v
        count = 0
        e = np.arange(1 << k1)
        for rank in range(ranks):
            for s in range(rank, units, ranks):
                w0 = s << logw
                pos = ((e >> logw) << k1) + w0 + (e & ((1 << logw) - 1))
                v = mid[pos]
                assert (v >= 0).all(), "phase 2 read a scratch word phase 1 never wrote"
                for j in range(k2):
                    h, w = u >> logw, u & ((1 << logw) - 1)
                    hlo = ((h >> j) << (j + 1)) | (h & ((1 << j) - 1))
                    lo, hi = (hlo << logw) + w, ((hlo + (1 << j)) << logw) + w
                    t = tw[n - (n >> (k1 + j)) + (hlo >> (j + 1))]
                    a, b = v[lo], v[hi]
                    v[lo], v[hi] = (a + b) % P, (a - b) % P * t % P
                c = v * scale % P
                kept = (pos >> bound) == 0
                rows = np.array([circle_host.bit_reverse_index(int(p), bound) if bound else 0 for p in pos[kept]], np.int64)
                out[rows * 4 + col] = c[kept]
                count += int((c[~kept] != 0).sum())
        out[(4 << bound) + col] = count
    return out


@pytest.mark.parametrize("level,bound,slab_log", [(1, 0, None), (9, 0, None), (14, 3, None), (16, 7, None),
                                                   (17, 7, None), (5, 2, 3), (6, 6, 3), (7, 3, 4), (8, 0, 4)])
def test_kernel_model_matches_the_plain_version(level, bound, slab_log):
    """The kernel's schedule (its constants parsed from the source, or a
    smaller slab so that small layers take both phases, clusters and several
    slabs a rank) gives the plain version's kept coefficients, every output
    word written, and the counts of a clean layer and of one with three
    coefficients planted past the bound."""
    k = _constants()
    assert fri_fold_cuda.MAX_LAST_LOG == k["kSlabLog"] + k["kMaxRowLog"] and k["kMaxRowLog"] <= k["kSlabLog"]
    slab_log = slab_log or k["kSlabLog"]
    n = 1 << level
    planted = sorted({n - 1, (1 << bound) + (n - (1 << bound)) // 3, (1 << bound) + (n - (1 << bound)) // 2}
                     if bound < level else set())
    for extra in ((), planted):
        case = cases.last_layer_case(level, bound, "cpu", seed=level + len(extra), planted=extra)
        got = _kernel_model(case.g.numpy(), fri_last.twiddles(level, torch.device("cpu")).numpy(), level, bound,
                            slab_log, k["kMaxClusterLog"])
        assert (got >= 0).all()
        assert list(got[4 << bound :]) == [len(extra)] * 4
        v = fri_last.interpolate_plain(case.g, level)
        kept = v[:, torch.as_tensor(circle_host.bit_reverse_indices(bound))].T.numpy()
        assert np.array_equal(got[: 4 << bound].reshape(-1, 4), kept)
        if not extra:
            assert np.array_equal(kept, fri_last.last_layer_poly(case.g, level, bound))


def test_cpu_tensors_take_the_plain_version_once_a_proof(monkeypatch):
    """On the CPU last_layer_poly takes the plain version, never the
    kernel's wrapper, once a proof, at the proof's (level, bound); the
    proof's bytes are the CPU run's."""
    calls = []
    plain = fri_last.last_layer_poly_plain

    def spy(g, level, bound):
        calls.append((tuple(g.shape), level, bound))
        return plain(g, level, bound)

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    want = flagship.proof_bytes(prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device="cpu"))
    monkeypatch.setattr(fri_last, "last_layer_poly_plain", spy)
    monkeypatch.setattr(fri_fold_cuda, "last_layer", refuse)
    proof = prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device="cpu")
    assert flagship.proof_bytes(proof) == want
    spec = VerifierSpec.from_proof(proof)
    level = spec.max_first_layer_log - 1 - spec.n_inner_layers
    assert calls == [((4, 1 << level), level, spec.log_last_layer_degree_bound)]


def test_last_layer_limits_raise():
    """Every limit of the kernel's wrapper raises ValueError before the
    library loads (meta tensors), and last_layer_poly's own on the CPU."""
    ok_g, ok_tw = torch.empty((4, 1 << 5), **META), torch.empty((1 << 5) - 1, **META)
    bad = [
        (torch.empty((4, 1), **META), torch.empty(0, **META), 0, 0),
        (torch.empty((4, 1 << 24), **META), torch.empty((1 << 24) - 1, **META), 24, 0),
        (ok_g, ok_tw, 5, -1),
        (ok_g, ok_tw, 5, 6),
        (torch.empty((4, 1 << 4), **META), ok_tw, 5, 2),
        (torch.empty((4, 1 << 5), device="meta", dtype=torch.int32), ok_tw, 5, 2),
        (torch.empty((1 << 5, 4), **META).T, ok_tw, 5, 2),
        (ok_g, torch.empty(1 << 5, **META), 5, 2),
        (ok_g, ok_tw, 5, 2),
        (torch.zeros((4, 1 << 5), dtype=torch.int64), torch.zeros((1 << 5) - 1, dtype=torch.int64), 5, 2),
    ]
    for g, tw, level, bound in bad:
        with pytest.raises(ValueError):
            fri_fold_cuda.last_layer(g, tw, level, bound)
    g = torch.zeros((4, 1 << 3), dtype=torch.int64)
    for level, bound in ((0, 0), (3, 4), (3, -1)):
        with pytest.raises(ValueError):
            fri_last.last_layer_poly(g, level, bound)
