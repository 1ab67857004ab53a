"""In-point AIR evaluation: the composition polynomial check at the OODS
point, in plain torch, batched over proofs.

The PlonkWithPoseidon AIR's constraints in their emission order, the
16-word poseidon state as stacked (B, 16) QM31 tensors, and Horner
accumulation over all emitted constraints as they are emitted
(`HornerSink`).  `composition_value_plain` returns the Horner value beside
the bool.
"""

from __future__ import annotations

from typing import List

import torch

from ..core import m31
from ..core import qm31 as q
from ..core.poseidon2_host import MAT_DIAG16_M_1
from ..core.qm31 import QM31
from . import points as points_mod
from .quotients import q_modsum
from .spec import (
    N_INTERACTION_PLONK,
    N_PREPROCESSED_PLONK,
    N_TRACE_PLONK,
    VerifierSpec,
)


class HornerSink:
    """Constraint sink: `append` folds each column of a (B, n) QM31 block
    into acc = ((c0*rc + c1)*rc + c2)..., lane by lane in emission order, so
    no list of constraints is held."""

    def __init__(self, rc: QM31, n: int):
        self.rc = rc
        self.n = n
        self.acc = None

    def append(self, block: QM31) -> None:
        shapes = {tuple(x.shape) for x in block}
        if len(shapes) != 1 or len(block.a.shape) != 2 or block.a.shape[0] != self.n:
            raise ValueError(f"constraint block of shapes {shapes}, expected ({self.n}, k)")
        for t in range(block.a.shape[-1]):
            c = _lane(block, t)
            # the first step is 0 * rc + c = c
            self.acc = c if self.acc is None else q.q_add(q.q_mul(self.acc, self.rc), c)


class _Eval:
    """EvalAtRowVar equivalent; constraints go (already scaled by this
    component's 1/vanishing) to a `HornerSink`."""

    def __init__(
        self,
        spec: VerifierSpec,
        samples_flat: torch.Tensor,
        tree_col_base,
        total_sum: QM31,
        denom_inverse: QM31,
        log_size: int,
        constraints: HornerSink,
    ):
        self.spec = spec
        self.samples = samples_flat
        self.base = tree_col_base
        self.cursor = [0, 0, 0]
        self.denom_inverse = denom_inverse
        self.constraints = constraints
        self.fracs: List[tuple] = []
        self.cumsum_shift = q.q_mul_m31(total_sum, pow(1 << log_size, m31.P - 2, m31.P))

    # -- mask access ---------------------------------------------------------

    def _sample_idx(self, tree: int, col: int, k: int) -> int:
        return self.spec.sample_offsets[tree][col] + k

    def _gather(self, idxs) -> QM31:
        s = self.samples[:, torch.tensor(idxs, device=self.samples.device)]
        return QM31(s[..., 0], s[..., 1], s[..., 2], s[..., 3])

    def next_mask(self, tree: int, n: int = 1):
        col = self.base[tree] + self.cursor[tree]
        self.cursor[tree] += 1
        return [self._gather([self._sample_idx(tree, col, k)]) for k in range(n)]

    def preprocessed(self) -> QM31:
        v = self.next_mask(0)[0]
        return QM31(*(c[:, 0] for c in v))

    def trace(self) -> QM31:
        v = self.next_mask(1)[0]
        return QM31(*(c[:, 0] for c in v))

    def preprocessed_block(self, n: int) -> QM31:
        """n consecutive preprocessed columns, stacked (B, n)."""
        cols = [self.base[0] + self.cursor[0] + i for i in range(n)]
        self.cursor[0] += n
        return self._gather([self._sample_idx(0, c, 0) for c in cols])

    def trace_block(self, n: int) -> QM31:
        cols = [self.base[1] + self.cursor[1] + i for i in range(n)]
        self.cursor[1] += n
        return self._gather([self._sample_idx(1, c, 0) for c in cols])

    def next_extension_mask(self, n: int):
        cols = [self.next_mask(2, n) for _ in range(4)]
        out = []
        for k in range(n):
            vals = [QM31(*(c[:, 0] for c in cols[j][k])) for j in range(4)]
            out.append(q.q_combine4(*vals))
        return out

    # -- constraints / logup -------------------------------------------------

    def add_constraint(self, v: QM31):
        """Scalar (B,) constraint."""
        self.constraints.append(
            QM31(*(c[:, None] for c in q.q_mul(v, self.denom_inverse)))
        )

    def add_constraint_block(self, v: QM31):
        """Stacked (B, n) constraints, emitted in lane order."""
        self.constraints.append(q.q_mul(v, _bc(self.denom_inverse)))

    def add_to_relation(self, lookup, mult: QM31, values: List[QM31]):
        z, alpha = lookup
        denom = values[0]
        apow = None
        for v in values[1:]:
            apow = alpha if apow is None else q.q_mul(apow, alpha)
            denom = q.q_add(denom, q.q_mul(apow, v))
        self.fracs.append((mult, q.q_sub(denom, z)))

    def finalize_logup(self, batch_size: int):
        batched = []
        for i in range(0, len(self.fracs), batch_size):
            chunk = self.fracs[i : i + batch_size]
            p, qq = chunk[0]
            for num, den in chunk[1:]:
                p = q.q_add(q.q_mul(p, den), q.q_mul(num, qq))
                qq = q.q_mul(qq, den)
            batched.append((p, qq))
        prev_col_cumsum = q.q_zero(self.denom_inverse.a)
        for num, den in batched[:-1]:
            (cur,) = self.next_extension_mask(1)
            diff = q.q_sub(cur, prev_col_cumsum)
            prev_col_cumsum = cur
            self.add_constraint(q.q_sub(q.q_mul(diff, den), num))
        num, den = batched[-1]
        prev_row, cur = self.next_extension_mask(2)
        diff = q.q_sub(q.q_sub(cur, prev_row), prev_col_cumsum)
        fixed = q.q_add(diff, self.cumsum_shift)
        self.add_constraint(q.q_sub(q.q_mul(fixed, den), num))


def _bc(x: QM31) -> QM31:  # (B,) -> (B, 1)
    return QM31(*(c[..., None] for c in x))


def _lane(s: QM31, i: int) -> QM31:
    return QM31(*(c[..., i] for c in s))


# ---------------------------------------------------------------------------
# plonk AIR
# ---------------------------------------------------------------------------

def evaluate_plonk(ev: _Eval, lookup):
    a_wire = ev.preprocessed()
    b_wire = ev.preprocessed()
    c_wire = ev.preprocessed()
    op = ev.preprocessed()
    mult_a = ev.preprocessed()
    mult_b = ev.preprocessed()
    mult_c = ev.preprocessed()
    poseidon_wire = ev.preprocessed()
    mult_poseidon = ev.preprocessed()
    enforce_c_m31 = ev.preprocessed()

    vals = [ev.trace() for _ in range(12)]
    a, b, c = vals[0:4], vals[4:8], vals[8:12]

    ev.add_constraint(q.q_mul(enforce_c_m31, c[1]))
    ev.add_constraint(q.q_mul(enforce_c_m31, c[2]))
    ev.add_constraint(q.q_mul(enforce_c_m31, c[3]))

    a_val = q.q_combine4(*a)
    b_val = q.q_combine4(*b)
    c_val = q.q_combine4(*c)

    one = q.q_one(op.a)
    gate = q.q_sub(
        q.q_sub(c_val, q.q_mul(op, q.q_add(a_val, b_val))),
        q.q_mul(q.q_mul(q.q_sub(one, op), a_val), b_val),
    )
    ev.add_constraint(gate)

    ev.add_to_relation(lookup, mult_a, [a_val, a_wire])
    ev.add_to_relation(lookup, mult_b, [b_val, b_wire])
    ev.add_to_relation(lookup, mult_c, [c_val, c_wire])
    ev.add_to_relation(lookup, q.q_neg(mult_poseidon), [poseidon_wire, a_val, b_val])
    ev.finalize_logup(2)


# ---------------------------------------------------------------------------
# poseidon AIR (stacked 16-lane state)
# ---------------------------------------------------------------------------

def _q_mds16(s: QM31) -> QM31:
    """External round matrix on (B, 16) QM31 state (cf. poseidon2.mds16)."""
    g = QM31(*(c.reshape(c.shape[:-1] + (4, 4)) for c in s))
    x0, x1, x2, x3 = (_lane(g, i) for i in range(4))
    t0 = q.q_add(x0, x1)
    t1 = q.q_add(x2, x3)
    t2 = q.q_add(q.q_add(x1, x1), t1)
    t3 = q.q_add(q.q_add(x3, x3), t0)
    t4 = q.q_add(q.q_add(q.q_add(t1, t1), q.q_add(t1, t1)), t3)
    t5 = q.q_add(q.q_add(q.q_add(t0, t0), q.q_add(t0, t0)), t2)
    t6 = q.q_add(t3, t5)
    t7 = q.q_add(t2, t4)
    t = QM31(*(torch.stack(parts, dim=-1) for parts in zip(t6, t5, t7, t4)))
    sums = q_modsum(t, -2)  # (B, 4)
    out = q.q_add(t, QM31(*(c[..., None, :] for c in sums)))
    return QM31(*(c.reshape(s.a.shape) for c in out))


def _q_internal(s: QM31) -> QM31:
    """Internal round matrix: out = total + s * diag."""
    diag = torch.as_tensor(MAT_DIAG16_M_1.astype("int64"), device=s.a.device)
    total = q_modsum(s, -1)
    scaled = QM31(*(m31.mul(c, diag) for c in s))
    return q.q_add(scaled, _bc(total))


def _q_pow5(x: QM31) -> QM31:
    x2 = q.q_mul(x, x)
    return q.q_mul(q.q_mul(x2, x2), x)


def evaluate_poseidon(ev: _Eval, lookup):
    is_first = ev.preprocessed()
    is_last = ev.preprocessed()
    is_full = ev.preprocessed()
    one = q.q_one(is_first.a)
    is_not_first = q.q_sub(one, is_first)
    is_not_last = q.q_sub(one, is_last)
    is_partial = q.q_sub(is_not_first, is_full)

    round_id = ev.preprocessed()
    rc0 = ev.preprocessed_block(16)  # (B, 16)
    rc1 = ev.preprocessed_block(16)
    ext1 = ev.preprocessed()
    ext2 = ev.preprocessed()
    ext1_nz = ev.preprocessed()
    ext2_nz = ev.preprocessed()
    swap_bit_addr = _lane(rc0, 0)

    in_state = ev.trace_block(16)  # (B, 16)
    inter = ev.trace_block(16)
    out_state = ev.trace_block(16)
    swap_bit_value = _lane(inter, 0)

    # first round: swap halves + external matrix
    rolled = QM31(*(torch.cat([c[..., 8:], c[..., :8]], dim=-1) for c in in_state))
    permuted = q.q_add(
        q.q_mul(in_state, _bc(q.q_sub(one, swap_bit_value))),
        q.q_mul(rolled, _bc(swap_bit_value)),
    )
    permuted = _q_mds16(permuted)
    ev.add_constraint_block(q.q_mul(_bc(is_first), q.q_sub(permuted, out_state)))

    # full round
    frs = _q_pow5(q.q_add(in_state, rc0))
    ev.add_constraint_block(q.q_mul(_bc(is_full), q.q_sub(inter, frs)))
    frs = _q_mds16(_q_pow5(q.q_add(_q_mds16(inter), rc1)))
    ev.add_constraint_block(q.q_mul(_bc(is_full), q.q_sub(out_state, frs)))

    # partial rounds
    prs = in_state
    c_partial = []
    for r in range(14):
        inter_r = _lane(inter, r)
        c_partial.append(
            q.q_sub(inter_r, _q_pow5(q.q_add(_lane(prs, 0), _lane(rc0, r))))
        )
        prs = QM31(
            *(torch.cat([ir[..., None], pc[..., 1:]], dim=-1) for ir, pc in zip(inter_r, prs))
        )
        prs = _q_internal(prs)
    c_partial = QM31(*(torch.stack([c[i] for c in c_partial], dim=-1) for i in range(4)))
    ev.add_constraint_block(q.q_mul(_bc(is_partial), c_partial))
    ev.add_constraint_block(q.q_mul(_bc(is_partial), q.q_sub(out_state, prs)))

    # lookup relations
    in_left_id = q.q_add(round_id, round_id)
    in_right_id = q.q_add(in_left_id, one)
    out_left_id = q.q_add(in_right_id, one)
    out_right_id = q.q_add(out_left_id, one)

    def quarter(s: QM31, i: int) -> QM31:
        return q.q_combine4(*(_lane(s, 4 * i + j) for j in range(4)))

    sel = q.q_mul(ext1_nz, is_first)
    rid = q.q_add(q.q_mul(is_first, ext1), q.q_mul(is_not_first, in_left_id))
    ev.add_to_relation(
        lookup, q.q_sub(sel, is_not_first),
        [rid, quarter(in_state, 0), quarter(in_state, 1)],
    )

    sel = q.q_mul(ext2_nz, is_first)
    rid = q.q_add(q.q_mul(is_first, ext2), q.q_mul(is_not_first, in_right_id))
    ev.add_to_relation(
        lookup, q.q_sub(sel, is_not_first),
        [rid, quarter(in_state, 2), quarter(in_state, 3)],
    )

    sel = q.q_mul(ext1_nz, is_last)
    rid = q.q_add(q.q_mul(is_last, ext1), q.q_mul(is_not_last, out_left_id))
    ev.add_to_relation(
        lookup, q.q_add(sel, is_not_last),
        [rid, quarter(out_state, 0), quarter(out_state, 1)],
    )

    sel = q.q_mul(ext2_nz, is_last)
    rid = q.q_add(q.q_mul(is_last, ext2), q.q_mul(is_not_last, out_right_id))
    ev.add_to_relation(
        lookup, q.q_add(sel, is_not_last),
        [rid, quarter(out_state, 2), quarter(out_state, 3)],
    )

    ev.add_to_relation(
        lookup, q.q_mul(is_first, is_not_last), [swap_bit_value, swap_bit_addr]
    )
    ev.finalize_logup(3)


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------

def composition_value_plain(spec, samples_flat: torch.Tensor, sums, lookup, random_coeff: QM31, oods) -> tuple:
    """((B,) bool, the (B,) QM31 Horner value of every constraint): whether
    the constraints at the OODS point equal the composition polynomial's
    committed split values.  `sums` is the two tables' total sums (plonk,
    poseidon)."""
    oods_x, _ = oods
    constraints = HornerSink(random_coeff, samples_flat.shape[0])
    plonk_total_sum, poseidon_total_sum = sums
    denom_inv_plonk = q.q_inv(points_mod.coset_vanishing_canonic(oods_x, spec.log_size_plonk))
    ev = _Eval(spec, samples_flat, (0, 0, 0), plonk_total_sum, denom_inv_plonk, spec.log_size_plonk, constraints)
    evaluate_plonk(ev, lookup)

    denom_inv_pos = q.q_inv(points_mod.coset_vanishing_canonic(oods_x, spec.log_size_poseidon))
    ev = _Eval(spec, samples_flat, (N_PREPROCESSED_PLONK, N_TRACE_PLONK, N_INTERACTION_PLONK),
               poseidon_total_sum, denom_inv_pos, spec.log_size_poseidon, constraints)
    evaluate_poseidon(ev, lookup)
    computed = constraints.acc
    return _matches_committed(spec, samples_flat, oods_x, computed), computed


def _matches_committed(spec, samples_flat: torch.Tensor, oods_x: QM31, computed: QM31) -> torch.Tensor:
    """(B,) bool: the Horner-folded constraints equal the composition
    polynomial's committed split values at the OODS point."""

    def comp_sample(col):
        s = samples_flat[:, spec.sample_offsets[3][col]]
        return QM31(s[:, 0], s[:, 1], s[:, 2], s[:, 3])

    left = q.q_combine4(*[comp_sample(i) for i in range(4)])
    right = q.q_combine4(*[comp_sample(i) for i in range(4, 8)])
    xpow = points_mod.repeated_double_x(oods_x, spec.composition_log_degree_bound - 2)
    expected = q.q_add(left, q.q_mul(right, xpow))

    eq = computed.a == expected.a
    for comp_c, comp_e in zip(computed[1:], expected[1:]):
        eq = eq & (comp_c == comp_e)
    return eq
