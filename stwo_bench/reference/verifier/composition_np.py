"""The PlonkWithoutPoseidon AIR at the OODS point, in plain torch: its
constraints in their emission order (recursive-stwo
constraint_system/src/plonk_without_poseidon.rs:410-631), folded by
composition.py's Horner sink and mask access, and compared with the
composition polynomial's committed split values.

Per row: four pow5 constraints op2 (a_k^4 - b_k), one limb each; the gate
c - expected, expected = is_arith op1 (a + b) + (1 - op1) a b + is_m4 M4(h)
+ is_hadamard h + is_grandsum (g, g, g, g), with is_arith = (1 - op3)(1 -
op4), is_m4 = op3 (1 - op4), is_hadamard = (1 - op3) op4, is_grandsum = op3
op4, h the limb products of a and b and g the sum of every limb of a and b
(the product term is not under is_arith: every SIMD row has op1 = 1); then
the logup of (a, a_wire) and (b, b_wire) at multiplicity one and (c,
c_wire) at mult_c, in batches [a, b] and [c].
"""

from __future__ import annotations

import torch

from ..core import qm31 as q
from ..core.qm31 import QM31
from . import points as points_mod
from .composition import HornerSink, _Eval, _matches_committed


def _m4(h):
    """The M4 matrix (stwo's apply_m4) on four QM31 values."""
    t0 = q.q_add(h[0], h[1])
    t1 = q.q_add(h[2], h[3])
    t2 = q.q_add(q.q_add(h[1], h[1]), t1)
    t3 = q.q_add(q.q_add(h[3], h[3]), t0)
    t4 = q.q_add(q.q_add(q.q_add(t1, t1), q.q_add(t1, t1)), t3)
    t5 = q.q_add(q.q_add(q.q_add(t0, t0), q.q_add(t0, t0)), t2)
    return [q.q_add(t3, t5), t5, q.q_add(t2, t4), t4]


def evaluate_plonk_np(ev: _Eval, lookup) -> None:
    a_wire, b_wire, c_wire, op1, op2, op3, op4, mult_c = (ev.preprocessed() for _ in range(8))
    vals = [ev.trace() for _ in range(12)]
    a, b, c = vals[0:4], vals[4:8], vals[8:12]
    one = q.q_one(op1.a)

    for k in range(4):
        a2 = q.q_mul(a[k], a[k])
        ev.add_constraint(q.q_mul(op2, q.q_sub(q.q_mul(a2, a2), b[k])))

    h = [q.q_mul(a[k], b[k]) for k in range(4)]
    grand = a[0]
    for v in a[1:] + b:
        grand = q.q_add(grand, v)
    a_val, b_val, c_val = q.q_combine4(*a), q.q_combine4(*b), q.q_combine4(*c)
    not3, not4 = q.q_sub(one, op3), q.q_sub(one, op4)
    expected = q.q_add(
        q.q_add(q.q_mul(q.q_mul(not3, not4), q.q_mul(op1, q.q_add(a_val, b_val))),
                q.q_mul(q.q_mul(q.q_sub(one, op1), a_val), b_val)),
        q.q_add(q.q_add(q.q_mul(q.q_mul(op3, not4), q.q_combine4(*_m4(h))),
                        q.q_mul(q.q_mul(not3, op4), q.q_combine4(*h))),
                q.q_mul(q.q_mul(op3, op4), q.q_combine4(grand, grand, grand, grand))),
    )
    ev.add_constraint(q.q_sub(c_val, expected))

    ev.add_to_relation(lookup, one, [a_val, a_wire])
    ev.add_to_relation(lookup, one, [b_val, b_wire])
    ev.add_to_relation(lookup, mult_c, [c_val, c_wire])
    ev.finalize_logup(2)


def composition_value_np(spec, samples_flat: torch.Tensor, total_sum: QM31, lookup, random_coeff: QM31,
                         oods) -> tuple:
    """((B,) bool, the (B,) QM31 Horner value of every constraint): whether
    the constraints at the OODS point equal the composition polynomial's
    committed split values."""
    oods_x, _ = oods
    constraints = HornerSink(random_coeff, samples_flat.shape[0])
    denom_inv = q.q_inv(points_mod.coset_vanishing_canonic(oods_x, spec.log_size))
    evaluate_plonk_np(_Eval(spec, samples_flat, (0, 0, 0), total_sum, denom_inv, spec.log_size, constraints),
                      lookup)
    return _matches_committed(spec, samples_flat, oods_x, constraints.acc), constraints.acc
