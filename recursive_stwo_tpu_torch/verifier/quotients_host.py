"""Host copy of recursive_stwo_tpu/verifier/quotients.py (numpy only; its jax branches are
removed).  The torch twin is quotients.py beside it.

OODS quotient ("FRI answer") evaluation, batched over proofs x queries.

TPU-first restructure of the reference quotient math
(/root/reference/components/recursive/answer/src/data_structures.rs):
columns are STACKED on a trailing axis — line coefficients for a whole
sample batch are computed with (B, C)-shaped CM31/QM31 tensor ops, the
random-coefficient powers come from one scan, and the per-query numerator is
a log-depth modular tree reduction over the column axis.  The traced program
is O(#batches) bodies, independent of the column count.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core import m31_host as m31
from ..core import qm31_host as q
from ..core.m31_host import P
from ..core.qm31_host import CM31, QM31
from .spec import (
    N_INTERACTION_PLONK,
    N_PREPROCESSED_PLONK,
    N_TRACE_PLONK,
    VerifierSpec,
)
from . import points_host as points_mod


def _xp(arr):
    return np


def column_trace_log(spec: VerifierSpec, tree: int, col: int) -> int:
    """Trace-domain log of a committed column == its degree log (spec
    generic: works for both the two-table and the single-table AIRs)."""
    return spec.tree_col_degree_logs[tree][col]


def group_batches(spec: VerifierSpec, g: int):
    """[(batch_key, [(local_col, flat_sample_idx), ...])...] in encounter
    order; key (0, 0) is the OODS batch."""
    batches = []
    index: Dict[Tuple[int, int], int] = {}
    for local, (tree, col) in enumerate(spec.group_columns[g]):
        shifts = spec.sample_shifts_per_column[tree][col]
        base = spec.sample_offsets[tree][col]
        for si, shift in enumerate(shifts):
            key = (0, 0) if shift == 0 else (shift, column_trace_log(spec, tree, col))
            if key not in index:
                index[key] = len(batches)
                batches.append((key, []))
            batches[index[key]][1].append((local, base + si))
    return batches


def m31_modsum(x, axis: int):
    """Modular sum along an axis via log-depth pairwise reduction."""
    xp = _xp(x)
    x = xp.moveaxis(x, axis, -1)
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        lo = m31.add(x[..., :half], x[..., half : 2 * half])
        if n % 2:
            lo = xp.concatenate([lo, x[..., -1:]], axis=-1)
        x = lo
    return x[..., 0]


def q_modsum(x: QM31, axis: int) -> QM31:
    return QM31(*(m31_modsum(comp, axis) for comp in x))


def rc_power_chain(rc: QM31, n: int) -> QM31:
    """Stacked rc**k for k=0..n-1; components shaped (n,) + rc.shape."""
    # doubling blocks: pows[m:2m] = pows[:m] * rc^m — O(log n) q_muls
    comps = [np.empty((n,) + rc.a.shape, np.uint32) for _ in range(4)]
    one = q.q_one(rc.a)
    for ci in range(4):
        comps[ci][0] = one[ci]
    done = 1
    block_mult = rc
    while done < n:
        m = min(done, n - done)
        prefix = QM31(*(c[:m] for c in comps))
        block = q.q_mul(prefix, block_mult)
        for ci in range(4):
            comps[ci][done : done + m] = block[ci]
        done += m
        block_mult = q.q_mul(block_mult, block_mult)
    return QM31(*comps)


def fri_answers_for_group(
    spec: VerifierSpec,
    g: int,
    oods: Tuple[QM31, QM31],
    random_coeff: QM31,
    samples_flat,
    queried_rows,
    dom_x,
    dom_y,
    rc_powers: QM31 = None,
    rc_power_base: int = 0,
) -> QM31:
    """Quotient values for group g; queried_rows (B, Q, C) in group column
    order; dom_x/dom_y (B, Q).  Returns QM31 of (B, Q)."""
    xp = _xp(dom_x)
    batches = group_batches(spec, g)
    n_total = sum(len(cols) for _, cols in batches)
    if rc_powers is None:
        rc_powers = rc_power_chain(random_coeff, n_total)
        rc_power_base = 0

    # -2u constant
    neg2u = QM31(
        np.uint32(0), np.uint32(0), np.uint32(P - 2), np.uint32(0)
    )

    acc = q.q_zero(dom_x)
    k = rc_power_base
    for (shift, tlog), cols in batches:
        point = (
            oods if shift == 0 else points_mod.shifted_oods_point(oods, shift, tlog)
        )
        px, py = point
        C = len(cols)
        local_idx = np.array([c for c, _ in cols], np.int64)
        sample_idx = np.array([s for _, s in cols], np.int64)

        # sampled values, stacked (B, C)
        sv = samples_flat[:, xp.asarray(sample_idx)]  # (B, C, 4)
        v0 = CM31(sv[..., 0], sv[..., 1])
        v1 = CM31(sv[..., 2], sv[..., 3])
        y0 = CM31(py.a[:, None], py.b[:, None])
        y1 = CM31(py.c[:, None], py.d[:, None])

        # alpha_k = -2u * rc^k for this batch's k-range, (B, C)
        apow = QM31(*(xp.moveaxis(comp[k : k + C], 0, -1) for comp in rc_powers))
        alpha = q.q_mul(apow, _q_bcast_scalar(neg2u, apow.a))
        k += C

        a_c = v1
        c_c = CM31(y1.re + 0 * v1.re, y1.im + 0 * v1.im)
        b_c = q.c_sub(q.c_mul(v0, y1), q.c_mul(v1, y0))
        A = q.q_mul_cm31(alpha, a_c)  # (B, C)
        Bq = q.q_mul_cm31(alpha, b_c)
        Cq = q.q_mul_cm31(alpha, c_c)

        # terms over (B, Q, C): Cq*val - (A*dom_y + Bq)
        val = queried_rows[:, :, xp.asarray(local_idx)]  # (B, Q, C)
        Ae = QM31(*(comp[:, None, :] for comp in A))
        Be = QM31(*(comp[:, None, :] for comp in Bq))
        Ce = QM31(*(comp[:, None, :] for comp in Cq))
        dy = dom_y[:, :, None]
        term = q.q_sub(q.q_mul_m31(Ce, val), q.q_add(q.q_mul_m31(Ae, dy), Be))
        numerator = q_modsum(term, axis=2)  # (B, Q)

        # denominator inverse (CM31 over (B, Q))
        prx, pix = CM31(px.a[:, None], px.b[:, None]), CM31(px.c[:, None], px.d[:, None])
        pry, piy = CM31(py.a[:, None], py.b[:, None]), CM31(py.c[:, None], py.d[:, None])
        ta = q.c_mul(CM31(m31.sub(prx.re, dom_x), prx.im + 0 * dom_x), piy)
        tb = q.c_mul(CM31(m31.sub(pry.re, dom_y), pry.im + 0 * dom_y), pix)
        denom_inv = q.c_inv(q.c_sub(ta, tb))

        acc = q.q_add(acc, q.q_mul_cm31(numerator, denom_inv))
    return acc


def _q_bcast_scalar(x: QM31, like) -> QM31:
    return QM31(*(like * 0 + comp for comp in x))


def _modsum_cols(col_rows, idxs: np.ndarray, Cq: QM31) -> QM31:
    """sum_c Cq[c] * col_rows[idxs[c]] mod P, all 4 QM31 components in one
    float64 dgemm per 32-column chunk.

    Coefficients are split into 16-bit halves and columns are chunked so
    every partial dot stays below 2^53 (exact in float64):
    32 cols x (2^31 * 2^16) = 2^52.  col_rows entries are (N,) views into
    the original LDE blocks — no (N, C) transpose materialization."""
    N = col_rows[idxs[0]].size
    acc = [np.zeros(N, np.int64) for _ in range(4)]
    C = len(idxs)

    def fold(t):
        """int64 in [0, 2^53) -> [0, P) via 2^31 == 1 folds (no division)."""
        t = (t & P) + (t >> 31)
        t = (t & P) + (t >> 31)
        return t - (t >= P) * P

    for c0 in range(0, C, 32):
        pos = np.arange(c0, min(c0 + 32, C))
        chunk = np.empty((len(pos), N), np.float64)
        for j, p in enumerate(pos):
            chunk[j] = col_rows[idxs[p]]
        co = np.stack([np.asarray(comp)[pos] for comp in Cq])  # (4, k)
        M = np.concatenate(
            [co & np.uint32(0xFFFF), co >> np.uint32(16)]
        ).astype(np.float64)  # (8, k)
        R = M @ chunk  # (8, N) dgemm
        for ci in range(4):
            acc[ci] = fold(
                acc[ci]
                + fold(R[ci].astype(np.int64))
                + (fold(R[ci + 4].astype(np.int64)) << 16)
            )
    return QM31(*(a.astype(np.uint32) for a in acc))


def fri_answers_for_group_prover(
    spec: VerifierSpec,
    g: int,
    oods: Tuple[QM31, QM31],
    random_coeff: QM31,
    samples_flat: np.ndarray,
    queried_rows: np.ndarray,
    dom_x: np.ndarray,
    dom_y: np.ndarray,
) -> QM31:
    """Host-prover quotient evaluation over a FULL commitment domain.

    Same math as fri_answers_for_group with B=1, restructured for the
    prover flow: the per-column line coefficients are scalars there, so
    the numerator collapses to one modular matvec per sample batch
    (sum_c Cq_c*val_c - (sum_c A_c)*y - sum_c B_c) and rides BLAS
    instead of C vectorized passes over the 2^23+-point domain.
    queried_rows: list of per-column (N,) arrays (views into the LDE
    blocks), dom_x/dom_y (N,); returns QM31 of (N,)."""
    batches = group_batches(spec, g)
    n_total = sum(len(cols) for _, cols in batches)
    rc_powers = rc_power_chain(random_coeff, n_total)

    neg2u = QM31(np.uint32(0), np.uint32(0), np.uint32(P - 2), np.uint32(0))

    acc = q.q_zero(dom_x)
    k = 0
    for (shift, tlog), cols in batches:
        point = (
            oods if shift == 0 else points_mod.shifted_oods_point(oods, shift, tlog)
        )
        px, py = point
        C = len(cols)
        local_idx = np.array([c for c, _ in cols], np.int64)
        sample_idx = np.array([s for _, s in cols], np.int64)

        sv = samples_flat[0, sample_idx]  # (C, 4)
        v0 = CM31(sv[:, 0], sv[:, 1])
        v1 = CM31(sv[:, 2], sv[:, 3])
        y0 = CM31(py.a, py.b)  # scalar-shaped (1,)
        y1 = CM31(py.c, py.d)

        apow = QM31(*(comp[k : k + C, 0] for comp in rc_powers))  # (C,)
        alpha = q.q_mul(apow, _q_bcast_scalar(neg2u, apow.a))
        k += C

        a_c = v1
        c_c = CM31(y1.re + 0 * v1.re, y1.im + 0 * v1.im)
        b_c = q.c_sub(q.c_mul(v0, y1), q.c_mul(v1, y0))
        A = q.q_mul_cm31(alpha, a_c)  # (C,)
        Bq = q.q_mul_cm31(alpha, b_c)
        Cq = q.q_mul_cm31(alpha, c_c)

        # numerator = (sum Cq_c * val_c) - (sum A_c)*y - sum B_c
        dot = _modsum_cols(queried_rows, local_idx, Cq)
        A_sum = QM31(*(
            np.uint32(comp.astype(np.int64).sum() % P) for comp in A
        ))
        B_sum = QM31(*(
            np.uint32(comp.astype(np.int64).sum() % P) for comp in Bq
        ))
        y_term = q.q_mul_m31(_q_bcast_scalar(A_sum, dom_y), dom_y)
        numerator = q.q_sub(dot, q.q_add(y_term, _q_bcast_scalar(B_sum, dom_y)))

        # denominator inverse (CM31 over (N,))
        prx, pix = CM31(px.a, px.b), CM31(px.c, px.d)
        pry, piy = CM31(py.a, py.b), CM31(py.c, py.d)
        ta = q.c_mul(CM31(m31.sub(prx.re, dom_x), prx.im + 0 * dom_x), piy)
        tb = q.c_mul(CM31(m31.sub(pry.re, dom_y), pry.im + 0 * dom_y), pix)
        denom_inv = q.c_inv(q.c_sub(ta, tb))

        acc = q.q_add(acc, q.q_mul_cm31(numerator, denom_inv))
    return acc


def total_rc_powers(spec: VerifierSpec) -> int:
    return max(
        sum(len(cols) for _, cols in group_batches(spec, g))
        for g in range(len(spec.all_log_sizes))
    )
