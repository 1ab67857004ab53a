"""Poseidon2-16 half-state gadget (the workhorse of in-circuit hashing).

A `Poseidon2Half` carries 8 M31 values (= half the 16-wide state).  Two
modes, dispatched on the constraint-system flavor exactly like the
reference enum (/root/reference/primitives/poseidon31/src/lib.rs):

* Native (PlonkWithPoseidonCS): two QM31 wires plus a `sel_value` wire
  created by a poseidon-tagged mul gate; `permute` computes natively and
  records one Poseidon-accelerator flow entry.
* Emulated (PlonkWithoutPoseidonCS): two QM31 wires treated as 4-lane
  M31 SIMD; `permute` runs the full round structure in ~O(100) gates via
  the m4/pow5m4/pow5/hadamard/grandsum gate set (emulated.rs:80-221).
"""

from __future__ import annotations

import numpy as np

from ..core import poseidon2_host as poseidon2
from ..cs.system import PlonkWithPoseidonCS
from .fields import M31Var, QM31Var


def _permute16(values16):
    state = np.array(values16, dtype=np.uint32)
    return [int(x) for x in poseidon2.permute(state)]


def _is_native(cs) -> bool:
    return isinstance(cs, PlonkWithPoseidonCS)


class Poseidon2Half:
    """Native half-state var: value (8 ints), left/right QM31 wires,
    sel_value wire (0 if not table-linked)."""

    __slots__ = ("cs", "value", "left_variable", "right_variable", "sel_value")

    def __init__(self, cs, value, left_variable, right_variable, sel_value):
        self.cs = cs
        self.value = tuple(int(v) % ((1 << 31) - 1) for v in value)
        self.left_variable = left_variable
        self.right_variable = right_variable
        self.sel_value = sel_value

    # -- constructors ------------------------------------------------------
    @classmethod
    def new_witness(cls, cs, value):
        if not _is_native(cs):
            return Poseidon2HalfEmulated(
                QM31Var.new_witness(cs, tuple(value[0:4])),
                QM31Var.new_witness(cs, tuple(value[4:8])),
            )
        left = QM31Var.new_witness(cs, tuple(value[0:4]))
        right = QM31Var.new_witness(cs, tuple(value[4:8]))
        sel = cs.assemble_poseidon_gate(left.variable, right.variable)
        return cls(cs, value, left.variable, right.variable, sel)

    @classmethod
    def new_single_use_witness_only(cls, cs, value):
        """Witness with no wires: only consumed as permutation input
        (lib.rs:51-74)."""
        if not _is_native(cs):
            return Poseidon2Half.new_witness(cs, value)
        return cls(cs, value, 0, 0, 0)

    @classmethod
    def from_m31(cls, slice8):
        assert len(slice8) == 8
        cs = slice8[0].cs
        left = QM31Var.from_m31(*slice8[0:4])
        right = QM31Var.from_m31(*slice8[4:8])
        if not _is_native(cs):
            return Poseidon2HalfEmulated(left, right)
        sel = cs.assemble_poseidon_gate(left.variable, right.variable)
        return cls(
            cs, [v.value for v in slice8], left.variable, right.variable, sel
        )

    @classmethod
    def from_qm31(cls, a: QM31Var, b: QM31Var):
        cs = a.cs
        if not _is_native(cs):
            return Poseidon2HalfEmulated(a, b)
        sel = cs.assemble_poseidon_gate(a.variable, b.variable)
        return cls(cs, a.value + b.value, a.variable, b.variable, sel)

    @classmethod
    def zero(cls, cs):
        if not _is_native(cs):
            return Poseidon2HalfEmulated(QM31Var.zero(cs), QM31Var.zero(cs))
        key = "poseidon2 zero_half"
        sel = cs.get_cache(key)
        if sel is None:
            sel = cs.assemble_poseidon_gate(0, 0)
            cs.set_cache(key, sel)
        return cls(cs, (0,) * 8, 0, 0, sel)

    def to_qm31(self):
        return [
            QM31Var(self.cs, self.value[0:4], self.left_variable),
            QM31Var(self.cs, self.value[4:8], self.right_variable),
        ]

    # -- the permutation ---------------------------------------------------
    @staticmethod
    def permute(left, right, ignore_left, ignore_right, is_swap=None):
        """(new_left, new_right); is_swap = (bit_value, bit_variable) or
        None (lib.rs:282-423)."""
        if isinstance(left, Poseidon2HalfEmulated):
            return permute_emulated(left, right, is_swap)
        cs = left.cs
        assert isinstance(cs, PlonkWithPoseidonCS)
        if is_swap is not None and is_swap[0]:
            state = list(right.value) + list(left.value)
        else:
            state = list(left.value) + list(right.value)
        state = _permute16(state)

        def make_half(vals):
            ol = QM31Var.new_witness(cs, tuple(vals[0:4]))
            orr = QM31Var.new_witness(cs, tuple(vals[4:8]))
            sel = cs.assemble_poseidon_gate(ol.variable, orr.variable)
            return Poseidon2Half(cs, vals, ol.variable, orr.variable, sel)

        if ignore_left:
            new_left = Poseidon2Half(cs, state[0:8], 0, 0, 0)
        else:
            new_left = make_half(state[0:8])
        if ignore_right:
            new_right = Poseidon2Half(cs, state[8:16], 0, 0, 0)
        else:
            new_right = make_half(state[8:16])

        swap_addr, swap_bit = (
            (is_swap[1], is_swap[0]) if is_swap is not None else (0, False)
        )
        cs.invoke_poseidon_accelerator(
            (left.sel_value, right.sel_value, new_left.sel_value,
             new_right.sel_value),
            (left.value, right.value, new_left.value, new_right.value),
            swap_addr,
            swap_bit,
        )
        return new_left, new_right

    @staticmethod
    def permute_get_rate(left, right):
        return Poseidon2Half.permute(left, right, False, True)[0]

    @staticmethod
    def permute_get_capacity(left, right):
        return Poseidon2Half.permute(left, right, True, False)[1]

    @staticmethod
    def swap_permute_get_rate(left, right, is_swap):
        return Poseidon2Half.permute(left, right, False, True, is_swap)[0]

    @staticmethod
    def swap_permute_get_capacity(left, right, is_swap):
        return Poseidon2Half.permute(left, right, True, False, is_swap)[1]

    def equalverify(self, rhs: "Poseidon2Half") -> None:
        assert self.value == rhs.value
        self.cs.insert_gate(self.left_variable, 0, rhs.left_variable, 1)
        self.cs.insert_gate(self.right_variable, 0, rhs.right_variable, 1)


class Poseidon2HalfEmulated:
    """Emulated half-state: 2 QM31 wires as 4-lane M31 SIMD
    (lib.rs:30-34, emulated.rs)."""

    __slots__ = ("cs", "elems")

    def __init__(self, a: QM31Var, b: QM31Var):
        self.cs = a.cs
        self.elems = [a, b]

    @property
    def value(self):
        return self.elems[0].value + self.elems[1].value

    def to_qm31(self):
        return list(self.elems)

    def equalverify(self, rhs) -> None:
        for left, right in zip(self.elems, rhs.elems):
            left.equalverify(right)


def _q_wrap(cs, variable: int) -> QM31Var:
    return QM31Var(cs, cs.value(variable), variable)


def _apply_4x4_mds(x: QM31Var) -> QM31Var:
    cs = x.cs
    ones = QM31Var.new_constant(cs, (1, 1, 1, 1))
    return _q_wrap(cs, cs.do_m4_gate(x.variable, ones.variable))


def _apply_16x16_mds(state):
    p = [_apply_4x4_mds(s) for s in state]
    t = ((p[0] + p[1]) + p[2]) + p[3]
    return [p[0] + t, p[1] + t, p[2] + t, p[3] + t]


def _pow5m4(x: QM31Var) -> QM31Var:
    cs = x.cs
    b = QM31Var.new_witness(cs, tuple(pow(v, 4, (1 << 31) - 1) for v in x.value))
    return _q_wrap(cs, cs.do_pow5m4_gate(x.variable, b.variable))


def _pow5_var(cs, variable: int) -> int:
    val = cs.value(variable)
    b = QM31Var.new_witness(cs, tuple(pow(v, 4, (1 << 31) - 1) for v in val))
    return cs.do_pow5_gate(variable, b.variable)


def permute_emulated(left, right, is_swap=None):
    """SIMD-gate Poseidon2 permutation (emulated.rs:80-221)."""
    cs = left.cs

    if is_swap is not None:
        bit_value, bit_variable = is_swap
        bit_var = M31Var(cs, 1 if bit_value else 0, bit_variable)
        rml = [r - l for r, l in zip(right.elems, left.elems)]
        rml_bit = [x * bit_var for x in rml]
        left_elems = [x + l for x, l in zip(rml_bit, left.elems)]
        right_elems = [r - x for r, x in zip(right.elems, rml_bit)]
    else:
        left_elems = list(left.elems)
        right_elems = list(right.elems)

    state = [left_elems[0], left_elems[1], right_elems[0], right_elems[1]]
    state = _apply_16x16_mds(state)

    RC0 = poseidon2.FIRST_FOUR_ROUND_RC
    RC1 = poseidon2.LAST_FOUR_ROUNDS_RC
    RCP = poseidon2.PARTIAL_ROUNDS_RC
    DIAG = poseidon2.MAT_DIAG16_M_1

    for r in range(4):
        for i in range(4):
            rc = tuple(int(v) for v in RC0[r][4 * i : 4 * i + 4])
            state[i] = state[i] + QM31Var.new_constant(cs, rc)
        state = [_pow5m4(s) for s in state]
        t = ((state[0] + state[1]) + state[2]) + state[3]
        state = [s + t for s in state]

    for r in range(14):
        # isolate limb 0, add RC, pow5, recombine (emulated.rs:141-160)
        first_only = cs.do_hadamard(state[0].variable, 1)
        mask = QM31Var.new_constant(cs, (0, 1, 1, 1))
        without_first = cs.do_hadamard(state[0].variable, mask.variable)
        rc = M31Var.new_constant(cs, int(RCP[r]))
        first_only = cs.add(first_only, rc.variable)
        first_only = _pow5_var(cs, first_only)
        state[0] = _q_wrap(cs, cs.add(first_only, without_first))

        sum1 = cs.do_grandsum_gate(state[0].variable, state[1].variable)
        sum2 = cs.do_grandsum_gate(state[2].variable, state[3].variable)
        total = cs.add(sum1, sum2)
        for i in range(4):
            diag = tuple(int(v) for v in DIAG[4 * i : 4 * i + 4])
            v = cs.do_hadamard(
                state[i].variable, QM31Var.new_constant(cs, diag).variable
            )
            state[i] = _q_wrap(cs, cs.add(total, v))

    for r in range(4):
        for i in range(4):
            rc = tuple(int(v) for v in RC1[r][4 * i : 4 * i + 4])
            state[i] = state[i] + QM31Var.new_constant(cs, rc)
        state = [_pow5m4(s) for s in state]
        t = ((state[0] + state[1]) + state[2]) + state[3]
        state = [s + t for s in state]

    return (
        Poseidon2HalfEmulated(state[0], state[1]),
        Poseidon2HalfEmulated(state[2], state[3]),
    )
