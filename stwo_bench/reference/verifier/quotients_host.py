"""OODS quotient ("FRI answer") evaluation on the host (numpy), batched over
proofs x queries.

TPU-first restructure of the reference quotient math
(recursive-stwo components/recursive/answer/src/data_structures.rs):
columns are STACKED on a trailing axis — line coefficients for a whole
sample batch are computed with (B, C)-shaped CM31/QM31 tensor ops, the
random-coefficient powers come from one scan, and the per-query numerator is
a log-depth modular tree reduction over the column axis.  The traced program
is O(#batches) bodies, independent of the column count.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core import m31_host as m31
from ..core import qm31_host as q
from ..core.m31_host import P
from ..core.qm31_host import CM31, QM31
from .spec import VerifierSpec
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
