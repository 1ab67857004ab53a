"""Circle FFT interpolation over M31 (stwo basis), in numpy, and the
evaluation of a polynomial at an extension-field point.

A circle polynomial of log_size n is represented by 2^n coefficients in the
stwo FFT basis: b_{j}(p) = y^{j_0} * x^{j_1} * pi(x)^{j_2} * ... *
pi^{n-2}(x)^{j_{n-1}} where j_k are the bits of the coefficient index and
pi(x) = 2x^2 - 1.  Evaluations live on CanonicCoset(n).circle_domain() in
bit-reversed index order, the commitment layout.  Transforms are vectorized
over leading axes (columns).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..core import circle_host as ccircle
from ..core import m31_host as m31


@lru_cache(maxsize=None)
def domain_points_bit_reversed(log_size: int):
    """(x, y) uint32 arrays of the circle domain in bit-reversed order."""
    dom = ccircle.CanonicCoset(log_size).circle_domain()
    n = 1 << log_size
    br = ccircle.bit_reverse_indices(log_size)
    half = dom.half_coset
    order = np.uint64(1) << np.uint64(31)
    idx = (
        np.uint64(half.initial_index)
        + br.astype(np.uint64) * np.uint64(half.step_index)
    ) % order
    conj = br >= (n // 2)
    idx_conj = (
        np.uint64(half.initial_index)
        + (br - n // 2).astype(np.uint64) * np.uint64(half.step_index)
    ) % order
    idx = np.where(conj, (order - idx_conj) % order, idx)
    return ccircle.apoints_at_indices(idx)


@lru_cache(maxsize=None)
def _twiddles(log_size: int):
    """Per-layer folding twiddles for the bit-reversed layout.

    layer 0 pairs (2k, 2k+1): conjugate points, twiddle = y of the even
    element; layer k>0 pairs 2^k apart: twiddle = x after (k-1) doublings.
    Returns list of uint32 arrays, layer k has 2^(log_size-1-k) entries
    indexed by the group's position.
    """
    x, y = domain_points_bit_reversed(log_size)
    n = 1 << log_size
    out = [y[0:n:2].copy()]
    cur_x = x[0:n:2].copy()
    for _ in range(1, log_size):
        t = cur_x[0 : len(cur_x) : 2].copy()
        out.append(t)
        sq = m31.mul(t, t)
        cur_x = m31.sub(m31.add(sq, sq), np.uint32(1))
    return out


@lru_cache(maxsize=None)
def _inv_twiddles(log_size: int):
    return [m31.inv(t) for t in _twiddles(log_size)]


def interpolate(values):
    """Evaluations (..., 2^n) in bit-reversed domain order -> coefficients
    (..., 2^n) in the stwo FFT basis (natural index order)."""
    values = np.asarray(values, dtype=np.uint32)
    n = values.shape[-1]
    log_size = n.bit_length() - 1
    assert 1 << log_size == n
    itw = _inv_twiddles(log_size)
    v = values
    for layer in range(log_size):
        step = 1 << layer
        shape = v.shape[:-1] + (n // (2 * step), 2, step)
        g = v.reshape(shape)
        a, b = g[..., 0, :], g[..., 1, :]
        t = itw[layer].reshape((n // (2 * step), 1))
        f0 = m31.add(a, b)
        f1 = m31.mul(m31.sub(a, b), t)
        v = np.stack([f0, f1], axis=-2).reshape(v.shape)
    # scale by 1/2^log_size; the layering already leaves coefficients in
    # natural basis-index order (empirically verified vs basis products)
    inv2n = m31.inv(np.uint32(1 << log_size))
    return m31.mul(v, inv2n)


def eval_basis_at_point(log_size: int, px, py, q_ops):
    """All 2^log_size basis values at an extension-field point.

    q_ops: module with q_mul/q_one etc. (core.qm31 wrappers); px, py are
    QM31 scalars.  Returns list of QM31 (ordered by coefficient index).
    Used for OODS evaluation: f(p) = sum_j c_j * b_j(p)."""
    factors = [py, px]
    x = px
    for _ in range(log_size - 2):
        sq = q_ops.q_mul(x, x)
        x = q_ops.q_sub(q_ops.q_add(sq, sq), q_ops.q_one(x.a))
        factors.append(x)
    factors = factors[:log_size]

    vals = [q_ops.q_one(px.a)]
    for f in factors:
        vals = vals + [q_ops.q_mul(v, f) for v in vals]
    return vals


def eval_at_point(coeffs4, px, py):
    """Evaluate a QM31-coefficient poly (n, 4) at a QM31 point; returns a
    4-tuple.  Horner-free: basis product accumulation, O(n)."""
    from ..core import qm31_host as q

    coeffs4 = np.asarray(coeffs4, dtype=np.uint32)
    n = coeffs4.shape[0]
    log_size = n.bit_length() - 1
    if n == 1:
        return tuple(int(v) for v in coeffs4[0])
    basis = eval_basis_at_point(log_size, px, py, q)
    acc = q.q_zero(px.a)
    for j in range(n):
        c = q.QM31(*(np.uint32(coeffs4[j, k]) for k in range(4)))
        acc = q.q_add(acc, q.q_mul(c, basis[j]))
    return tuple(int(np.asarray(v)) for v in acc)
