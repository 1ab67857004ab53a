"""The host helpers of the provers: the OODS point from its draw, the
squaring-ladder factors at a point, a constant-point shift and each AIR's
sampled-values layout.

Copied from recursive_stwo_tpu/prover/prove.py (`_oods_point`,
`_factors_at_point`, `_add_const`, `_assemble_samples`) and prove_np.py
(`_assemble_samples_np`); the rest of those modules is the JAX package's
host and device flows, which the port replaces with prover/flow.py.
"""

from __future__ import annotations

import numpy as np

from ..cs import scalar


def _oods_point(t4):
    t = tuple(int(x) for x in t4)
    t2 = scalar.q_mul(t, t)
    inv = scalar.q_inv(scalar.q_add(t2, scalar.QONE))
    return (
        scalar.q_mul(scalar.q_sub(scalar.QONE, t2), inv),
        scalar.q_mul(scalar.q_add(t, t), inv),
    )


def _factors_at_point(log_size: int, p4):
    """(log_size, 4) QM31 squaring-ladder factors (y, x, pi(x), ...)."""
    px, py = p4
    factors = [py, px]
    x = px
    for _ in range(max(0, log_size - 2)):
        sq = scalar.q_mul(x, x)
        x = scalar.q_sub(scalar.q_add(sq, sq), scalar.QONE)
        factors.append(x)
    return np.array(factors[:log_size], np.uint32)


def _add_const(p4, c):
    px, py = p4
    cx, cy = c
    return (
        scalar.q_sub(scalar.q_mul_m31(px, cx), scalar.q_mul_m31(py, cy)),
        scalar.q_add(scalar.q_mul_m31(px, cy), scalar.q_mul_m31(py, cx)),
    )


def _assemble_samples(spec, lp, lq, bound, samples_at):
    """TreeVec[tree][col] -> (n_samples, 4) arrays in proof order."""
    sampled = []
    for t in range(3):
        tree_cols = []
        plonk = samples_at[((t, "p"), 0)]
        pos = samples_at[((t, "q"), 0)]
        n_plonk = plonk.shape[0]
        for ci in range(n_plonk + pos.shape[0]):
            cur = plonk[ci] if ci < n_plonk else pos[ci - n_plonk]
            n_samples = spec.n_samples_per_column[t][ci]
            if n_samples == 1:
                tree_cols.append(cur[None, :])
            else:
                prev_all = samples_at[((t, "p" if ci < n_plonk else "q"), -1)]
                prev = prev_all[ci if ci < n_plonk else ci - n_plonk]
                tree_cols.append(np.stack([prev, cur]))
        sampled.append(tree_cols)
    comp = samples_at[((3, "c"), 0)]
    sampled.append([comp[ci][None, :] for ci in range(8)])
    return sampled


def _assemble_samples_np(spec, bound, samples_at):
    """Copied from prover/prove_np.py:82-96: TreeVec[tree][col] ->
    (n_samples, 4) arrays in proof order."""
    sampled = []
    for t in range(3):
        cols = samples_at[(t, 0)]
        tree_cols = []
        for ci in range(cols.shape[0]):
            if spec.n_samples_per_column[t][ci] == 1:
                tree_cols.append(cols[ci][None, :])
            else:
                prev = samples_at[(t, -1)][ci]
                tree_cols.append(np.stack([prev, cols[ci]]))
        sampled.append(tree_cols)
    comp = samples_at[(3, 0)]
    sampled.append([comp[ci][None, :] for ci in range(8)])
    return sampled
