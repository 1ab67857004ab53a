"""Plonk constraint-system builders (the framework's L1 graph recorder).

Two flavors, mirroring the reference semantics exactly:

* `PlonkWithPoseidonCS` — 3-wire Plonk rows `c = op*(a+b) + (1-op)*a*b` with
  an `enforce_c_m31` flag, plus a Poseidon2-16 accelerator table ("flow")
  linked to the Plonk table by logup multiplicities.
  Reference: /root/reference/constraint_system/src/plonk_with_poseidon.rs.
* `PlonkWithoutPoseidonCS` — same skeleton with selector columns op1..op4
  adding SIMD gates (m4 / pow5m4 / pow5 / hadamard / grandsum) that treat
  one QM31 wire as 4 M31 lanes.
  Reference: /root/reference/constraint_system/src/plonk_without_poseidon.rs.

TPU-first design notes: the builder runs eagerly on the host with
python-int scalar values (`cs.scalar`) — circuit *structure* is data
independent given a spec, so this is a one-time trace-generation pass, not
the production verification path.  All finalization passes
(`check_arithmetics`, `populate_logup_arguments`,
`check_poseidon_invocations`) and trace generation are vectorized numpy
over the whole gate table; the emitted column tensors feed the prover
directly.

The Poseidon padding constants C1/C2/C3 (reference
plonk_with_poseidon.rs:296-321 uses stwo's CONSTANT_1..3 from the
non-vendored stwo fork) are chosen self-consistently here:
C1 = zeros, C2||C3 = permute(C1||C1).  Padding rows have wire=0 and never
enter the logup argument, so any permutation-consistent triple is sound;
only byte-identity of stwo-generated padded traces would differ.
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from ..core import poseidon2_host as poseidon2
from . import scalar
from .scalar import P, QONE, QZERO, QI, QJ

N_LANES = 16  # stwo SimdBackend lane count (plonk_with_poseidon.rs:10)
LOG_RESERVED = 16


class Mode(enum.Enum):
    PUBLIC_INPUT = 0
    WITNESS = 1
    CONSTANT = 2


# Poseidon accelerator padding constants (see module docstring).
PAD_C1 = (0,) * 8
_pad_state = poseidon2.permute(np.zeros(16, dtype=np.uint32))
PAD_C2 = tuple(int(x) for x in _pad_state[:8])
PAD_C3 = tuple(int(x) for x in _pad_state[8:])


def _q_of_limbs(v0: int, v1: int, v2: int, v3: int):
    return (v0 % P, v1 % P, v2 % P, v3 % P)


class _BaseCS:
    """State shared by both flavors: variables, cache, wires, bootstrap."""

    def __init__(self):
        self.variables: list = [QZERO, QONE, QI, QJ]
        self.cache: dict = {}
        self.a_wire: list = []
        self.b_wire: list = []
        self.c_wire: list = []
        self.num_input = 3
        self.is_program_started = False

    # -- value plumbing ----------------------------------------------------
    def value(self, idx: int):
        return self.variables[idx]

    def _push_value(self, v) -> int:
        idx = len(self.variables)
        self.variables.append(v)
        return idx

    def num_vars(self) -> int:
        return len(self.variables)

    def get_cache(self, key: str) -> Optional[int]:
        return self.cache.get(key)

    def set_cache(self, key: str, idx: int) -> None:
        self.cache[key] = idx


class PlonkWithPoseidonCS(_BaseCS):
    def __init__(self):
        super().__init__()
        self.poseidon_wire: list = []
        self.enforce_c_m31: list = []
        self.op: list = []
        # poseidon flow: parallel lists, one item per accelerator invocation
        self.flow_wires: list = []  # [ (w1,w2,w3,w4) ]
        self.flow_hashes: list = []  # [ (h1,h2,h3,h4) ], each h = 8-tuple
        self.flow_swap: list = []  # [ (addr, swap_bool) ]

        self.mult_a = self.mult_b = self.mult_c = self.mult_poseidon = None

        # bootstrap rows pin vars 0..3 to 0, 1, i, j
        # (plonk_with_poseidon.rs:63-96)
        for w in range(4):
            self._raw_row(w, 0, w, 1, 0, 0)

    def _raw_row(self, a, b, c, op, pw, em31):
        self.a_wire.append(a)
        self.b_wire.append(b)
        self.c_wire.append(c)
        self.op.append(op)
        self.poseidon_wire.append(pw)
        self.enforce_c_m31.append(em31)

    # -- gate API (plonk_with_poseidon.rs:101-244) -------------------------
    def insert_gate(self, a_wire: int, b_wire: int, c_wire: int, op: int):
        self.is_program_started = True
        n = len(self.variables)
        assert a_wire < n and b_wire < n and c_wire < n
        self._raw_row(a_wire, b_wire, c_wire, op % P, 0, 0)

    def enforce_zero(self, var: int):
        self.is_program_started = True
        self._raw_row(var, 0, 0, 1, 0, 0)

    def add(self, a_wire: int, b_wire: int) -> int:
        c = self._push_value(
            scalar.q_add(self.variables[a_wire], self.variables[b_wire])
        )
        self.insert_gate(a_wire, b_wire, c, 1)
        return c

    def mul(self, a_wire: int, b_wire: int) -> int:
        c = self._push_value(
            scalar.q_mul(self.variables[a_wire], self.variables[b_wire])
        )
        self.insert_gate(a_wire, b_wire, c, 0)
        return c

    def mul_constant(self, a_wire: int, constant: int) -> int:
        c = self._push_value(
            scalar.q_mul_m31(self.variables[a_wire], constant % P)
        )
        self.insert_gate(a_wire, 0, c, constant)
        return c

    def assemble_poseidon_gate(self, a_wire: int, b_wire: int) -> int:
        """Mul gate whose output wire doubles as a poseidon-table entry
        (plonk_with_poseidon.rs:155-175)."""
        self.is_program_started = True
        c = self._push_value(
            scalar.q_mul(self.variables[a_wire], self.variables[b_wire])
        )
        self._raw_row(a_wire, b_wire, c, 0, c, 0)
        return c

    def invoke_poseidon_accelerator(self, wires, hashes, swap_addr, swap_bit):
        self.flow_wires.append(tuple(wires))
        self.flow_hashes.append(tuple(tuple(h) for h in hashes))
        self.flow_swap.append((swap_addr, bool(swap_bit)))

    # -- allocation (plonk_with_poseidon.rs:196-277) -----------------------
    def new_m31(self, value: int, mode: Mode) -> int:
        value = value % P
        c = self._push_value(scalar.q_from_m31(value))
        if mode == Mode.PUBLIC_INPUT:
            assert not self.is_program_started
            self._raw_row(c, 0, c, 1, 0, 1)
            self.num_input += 1
        elif mode == Mode.WITNESS:
            self.is_program_started = True
            self._raw_row(c, 0, c, 1, 0, 1)
        else:  # constant: 1 * op(=value) pins c = value
            self.is_program_started = True
            self._raw_row(1, 0, c, value, 0, 0)
        return c

    def new_qm31(self, value, mode: Mode) -> int:
        value = _q_of_limbs(*value)
        c = self._push_value(value)
        if mode == Mode.PUBLIC_INPUT:
            assert not self.is_program_started
            self._raw_row(c, 0, c, 1, 0, 1)
            self.num_input += 1
        elif mode == Mode.WITNESS:
            self.is_program_started = True
            # no row: witness QM31 is unconstrained at allocation
        else:  # constant via two limb-composition gates (:256-277)
            self.is_program_started = True
            fr = self.new_m31(value[0], Mode.CONSTANT)
            fi = self.new_m31(value[1], Mode.CONSTANT)
            sr = self.new_m31(value[2], Mode.CONSTANT)
            si = self.new_m31(value[3], Mode.CONSTANT)
            t = self.mul(fi, 2)
            a_wire = self.add(fr, t)
            t = self.mul(si, 2)
            t = self.add(sr, t)
            b_wire = self.mul(t, 3)
            self._raw_row(a_wire, b_wire, c, 1, 0, 0)
        return c

    # -- finalization ------------------------------------------------------
    def pad(self):
        assert self.mult_a is None
        n_pos = len(self.flow_wires)
        padded_pos = max(N_LANES * 2, -(-n_pos // 16) * 16)
        for _ in range(n_pos, padded_pos):
            self.invoke_poseidon_accelerator(
                (0, 0, 0, 0), (PAD_C1, PAD_C1, PAD_C2, PAD_C3), 0, False
            )
        n = len(self.a_wire)
        padded = max(N_LANES, 1 << (n - 1).bit_length())
        for _ in range(n, padded):
            self._raw_row(0, 0, 0, 1, 0, 0)

    def _var_array(self) -> np.ndarray:
        return np.array(self.variables, dtype=np.uint32)  # (n_vars, 4)

    def check_arithmetics(self):
        """Vectorized re-verification of every row
        (plonk_with_poseidon.rs:337-381)."""
        from ..core import qm31_host as q

        V = self._var_array()
        aw = np.asarray(self.a_wire)
        bw = np.asarray(self.b_wire)
        cw = np.asarray(self.c_wire)
        op = np.asarray(self.op, dtype=np.uint32)
        a = q.QM31(*(V[aw, k] for k in range(4)))
        b = q.QM31(*(V[bw, k] for k in range(4)))
        c = q.QM31(*(V[cw, k] for k in range(4)))
        lhs = q.q_add(
            q_mul_scalar_m31(q.q_add(a, b), op),
            q_mul_scalar_m31(q.q_mul(a, b), (1 - op) % P),
        )
        bad = np.nonzero(
            (lhs.a != c.a) | (lhs.b != c.b) | (lhs.c != c.c) | (lhs.d != c.d)
        )[0]
        assert bad.size == 0, f"rows {bad[:10]} fail the gate constraint"
        em = np.asarray(self.enforce_c_m31, dtype=bool)
        bad = np.nonzero(em & ((c.b != 0) | (c.c != 0) | (c.d != 0)))[0]
        assert bad.size == 0, f"rows {bad[:10]} fail the c-is-M31 constraint"

    def populate_logup_arguments(self):
        """Per-row logup multiplicities by first-occurrence counting
        (plonk_with_poseidon.rs:383-466), vectorized."""
        assert self.mult_a is None
        n_vars = len(self.variables)
        n_rows = len(self.a_wire)
        assert n_rows & (n_rows - 1) == 0

        aw = np.asarray(self.a_wire)
        bw = np.asarray(self.b_wire)
        cw = np.asarray(self.c_wire)
        counts = np.zeros(n_vars, dtype=np.int64)
        np.add.at(counts, aw, 1)
        np.add.at(counts, bw, 1)
        np.add.at(counts, cw, 1)
        counts[1 : 1 + self.num_input] += 1
        if self.flow_swap:
            swap_addrs = np.asarray([s[0] for s in self.flow_swap])
            np.add.at(counts, swap_addrs, 1)

        # flatten in row-major (a, b, c) order; first occurrence of a wire
        # in that order carries 1 - counts[wire], later ones carry 1
        flat = np.empty(3 * n_rows, dtype=np.int64)
        flat[0::3], flat[1::3], flat[2::3] = aw, bw, cw
        _, first_idx = np.unique(flat, return_index=True)
        mult = np.ones(3 * n_rows, dtype=np.int64)
        mult[first_idx] = 1 - counts[flat[first_idx]]
        self.mult_a = mult[0::3].copy()
        self.mult_b = mult[1::3].copy()
        self.mult_c = mult[2::3].copy()

        # poseidon multiplicities: flow-side use count of each entry wire
        pos_counts = np.zeros(n_vars, dtype=np.int64)
        if self.flow_wires:
            fw = np.asarray(self.flow_wires).ravel()
            np.add.at(pos_counts, fw, 1)
        pos_counts[0] = 0
        pw = np.asarray(self.poseidon_wire)
        self.mult_poseidon = np.where(pw != 0, pos_counts[pw], 0)
        used = (pw != 0) & (self.mult_poseidon != 0)
        assert (counts[pw[used]] == 1).all(), (
            "poseidon entry wires must be single-use"
        )

    def check_poseidon_invocations(self):
        """Natively replay every accelerator entry
        (plonk_with_poseidon.rs:468-519), vectorized over the flow."""
        if not self.flow_wires:
            return
        V = self._var_array()
        pw = np.asarray(self.poseidon_wire)
        aw = np.asarray(self.a_wire)
        bw = np.asarray(self.b_wire)
        mp = self.mult_poseidon
        assert mp is not None, "populate_logup_arguments must run first"

        # wire -> 8-limb hash (a||b limbs of the defining mul gate)
        rows = np.nonzero(mp != 0)[0]
        hash_of = {}
        for i in rows:
            hash_of[int(pw[i])] = tuple(V[aw[i]]) + tuple(V[bw[i]])

        wires = np.asarray(self.flow_wires)  # (N, 4)
        hashes = np.asarray(self.flow_hashes, dtype=np.uint32)  # (N, 4, 8)
        swap = np.asarray([s[1] for s in self.flow_swap], dtype=bool)

        for k in range(4):
            nz = np.nonzero(wires[:, k] != 0)[0]
            for i in nz:
                assert hash_of[int(wires[i, k])] == tuple(hashes[i, k]), (
                    f"flow entry {i} slot {k} mismatches its table wire"
                )

        left = np.where(swap[:, None], hashes[:, 1], hashes[:, 0])
        right = np.where(swap[:, None], hashes[:, 0], hashes[:, 1])
        state = np.concatenate([left, right], axis=1)  # (N, 16)
        out = poseidon2.permute(state)
        expected = np.concatenate([hashes[:, 2], hashes[:, 3]], axis=1)
        assert (out == expected).all(), "poseidon accelerator replay failed"

    def generate_trace(self) -> dict:
        """Column tensors in the reference trace layout
        (plonk_with_poseidon.rs:521-628) + the poseidon flow arrays."""
        n_rows = len(self.a_wire)
        assert n_rows & (n_rows - 1) == 0 and n_rows >= N_LANES
        assert self.mult_a is not None

        V = self._var_array()
        aw = np.asarray(self.a_wire, dtype=np.uint32)
        bw = np.asarray(self.b_wire, dtype=np.uint32)
        cw = np.asarray(self.c_wire, dtype=np.uint32)
        to_m31 = lambda m: np.asarray(m % P, dtype=np.uint32)
        cols = {
            "mult_a": to_m31(self.mult_a),
            "mult_b": to_m31(self.mult_b),
            "mult_c": to_m31(self.mult_c),
            "poseidon_wire": np.asarray(self.poseidon_wire, dtype=np.uint32),
            "mult_poseidon": to_m31(self.mult_poseidon),
            "enforce_c_m31": np.asarray(self.enforce_c_m31, dtype=np.uint32),
            "a_wire": aw,
            "b_wire": bw,
            "c_wire": cw,
            "op": np.asarray(self.op, dtype=np.uint32),
        }
        for name, w in (("a", aw), ("b", bw), ("c", cw)):
            for k in range(4):
                cols[f"{name}_val_{k}"] = V[w, k]
        cols["flow_wires"] = np.asarray(self.flow_wires, dtype=np.uint32)
        cols["flow_hashes"] = np.asarray(self.flow_hashes, dtype=np.uint32)
        cols["flow_swap_addr"] = np.asarray(
            [s[0] for s in self.flow_swap], dtype=np.uint32
        )
        cols["flow_swap_bit"] = np.asarray(
            [s[1] for s in self.flow_swap], dtype=np.uint32
        )
        return cols


def q_mul_scalar_m31(x, s):
    """QM31 (core SoA) * M31 scalar array."""
    from ..core import m31_host as m, qm31_host as q

    return q.QM31(m.mul(x.a, s), m.mul(x.b, s), m.mul(x.c, s), m.mul(x.d, s))


class PlonkWithoutPoseidonCS(_BaseCS):
    """Selector table (plonk_without_poseidon.rs:566-596):
    arith=(op2,op3,op4)=(0,0,0), hadamard=(0,0,1), pow5m4=(1,1,0),
    pow5=(1,0,1), m4=(0,1,0), grandsum=(0,1,1)."""

    def __init__(self):
        super().__init__()
        self.op1: list = []
        self.op2: list = []
        self.op3: list = []
        self.op4: list = []
        self.mult_c = None
        for w in range(4):
            self._raw_row(w, 0, w, 1, 0, 0, 0)

    def _raw_row(self, a, b, c, op1, op2, op3, op4):
        self.a_wire.append(a)
        self.b_wire.append(b)
        self.c_wire.append(c)
        self.op1.append(op1)
        self.op2.append(op2)
        self.op3.append(op3)
        self.op4.append(op4)

    def insert_gate(self, a_wire: int, b_wire: int, c_wire: int, op: int):
        self.is_program_started = True
        n = len(self.variables)
        assert a_wire < n and b_wire < n and c_wire < n
        self._raw_row(a_wire, b_wire, c_wire, op % P, 0, 0, 0)

    def enforce_zero(self, var: int):
        self.is_program_started = True
        self._raw_row(var, 0, 0, 1, 0, 0, 0)

    def add(self, a_wire: int, b_wire: int) -> int:
        c = self._push_value(
            scalar.q_add(self.variables[a_wire], self.variables[b_wire])
        )
        self.insert_gate(a_wire, b_wire, c, 1)
        return c

    def mul(self, a_wire: int, b_wire: int) -> int:
        c = self._push_value(
            scalar.q_mul(self.variables[a_wire], self.variables[b_wire])
        )
        self.insert_gate(a_wire, b_wire, c, 0)
        return c

    def mul_constant(self, a_wire: int, constant: int) -> int:
        c = self._push_value(
            scalar.q_mul_m31(self.variables[a_wire], constant % P)
        )
        self.insert_gate(a_wire, 0, c, constant)
        return c

    # -- SIMD gates (plonk_without_poseidon.rs:108-244) --------------------
    @staticmethod
    def _m4(x):
        t0 = (x[0] + x[1]) % P
        t1 = (x[2] + x[3]) % P
        t2 = (2 * x[1] + t1) % P
        t3 = (2 * x[3] + t0) % P
        t4 = (4 * t1 + t3) % P
        t5 = (4 * t0 + t2) % P
        return ((t3 + t5) % P, t5, (t2 + t4) % P, t4)

    def _hadamard_val(self, a_wire, b_wire):
        a, b = self.variables[a_wire], self.variables[b_wire]
        return tuple(a[k] * b[k] % P for k in range(4))

    def _simd_row(self, a_wire, b_wire, value, sel):
        self.is_program_started = True
        c = self._push_value(value)
        self._raw_row(a_wire, b_wire, c, 1, *sel)
        return c

    def do_m4_gate(self, a_wire: int, b_wire: int) -> int:
        a = self.variables[a_wire]
        return self._simd_row(a_wire, b_wire, self._m4(a), (0, 1, 0))

    def do_pow5m4_gate(self, a_wire: int, b_wire: int) -> int:
        h = self._hadamard_val(a_wire, b_wire)
        return self._simd_row(a_wire, b_wire, self._m4(h), (1, 1, 0))

    def do_pow5_gate(self, a_wire: int, b_wire: int) -> int:
        h = self._hadamard_val(a_wire, b_wire)
        return self._simd_row(a_wire, b_wire, h, (1, 0, 1))

    def do_hadamard(self, a_wire: int, b_wire: int) -> int:
        h = self._hadamard_val(a_wire, b_wire)
        return self._simd_row(a_wire, b_wire, h, (0, 0, 1))

    def do_grandsum_gate(self, a_wire: int, b_wire: int) -> int:
        a, b = self.variables[a_wire], self.variables[b_wire]
        s = (sum(a) + sum(b)) % P
        return self._simd_row(a_wire, b_wire, (s, s, s, s), (0, 1, 1))

    # -- allocation (plonk_without_poseidon.rs:290-389) --------------------
    def new_m31(self, value: int, mode: Mode) -> int:
        value = value % P
        c = self._push_value(scalar.q_from_m31(value))
        if mode == Mode.PUBLIC_INPUT:
            assert not self.is_program_started
            # hadamard row vs wire 1: c = a * (1,1,1,1) pins limbs 1..3 = 0
            self._raw_row(c, 1, c, 1, 0, 0, 1)
            self.num_input += 1
        elif mode == Mode.WITNESS:
            self.is_program_started = True
            self._raw_row(c, 1, c, 1, 0, 0, 1)
        else:
            self.is_program_started = True
            self._raw_row(1, 0, c, value, 0, 0, 0)
        return c

    def new_qm31(self, value, mode: Mode) -> int:
        value = _q_of_limbs(*value)
        c = self._push_value(value)
        if mode == Mode.PUBLIC_INPUT:
            assert not self.is_program_started
            self._raw_row(c, 0, c, 1, 0, 0, 0)
            self.num_input += 1
        elif mode == Mode.WITNESS:
            self.is_program_started = True
            self._raw_row(c, 0, c, 1, 0, 0, 0)
        else:
            self.is_program_started = True
            fr = self.new_m31(value[0], Mode.CONSTANT)
            fi = self.new_m31(value[1], Mode.CONSTANT)
            sr = self.new_m31(value[2], Mode.CONSTANT)
            si = self.new_m31(value[3], Mode.CONSTANT)
            t = self.mul(fi, 2)
            a_wire = self.add(fr, t)
            t = self.mul(si, 2)
            t = self.add(sr, t)
            b_wire = self.mul(t, 3)
            self._raw_row(a_wire, b_wire, c, 1, 0, 0, 0)
        return c

    # -- finalization ------------------------------------------------------
    def pad(self):
        assert self.mult_c is None
        n = len(self.a_wire)
        padded = max(N_LANES, 1 << (n - 1).bit_length())
        for _ in range(n, padded):
            self._raw_row(0, 0, 0, 1, 0, 0, 0)

    def check_arithmetics(self):
        """Vectorized selector-aware row check
        (plonk_without_poseidon.rs:410-598)."""
        from ..core import m31_host as m, qm31_host as q

        V = np.array(self.variables, dtype=np.uint32)
        aw = np.asarray(self.a_wire)
        bw = np.asarray(self.b_wire)
        cw = np.asarray(self.c_wire)
        op1 = np.asarray(self.op1, dtype=np.uint32)
        sel = tuple(
            np.asarray(x, dtype=np.int64)
            for x in (self.op2, self.op3, self.op4)
        )
        op2, op3, op4 = sel
        known = {(0, 0, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 0), (0, 1, 1)}
        combos = set(zip(op2.tolist(), op3.tolist(), op4.tolist()))
        assert combos <= known, f"unknown selector combos {combos - known}"

        a = q.QM31(*(V[aw, k] for k in range(4)))
        b = q.QM31(*(V[bw, k] for k in range(4)))
        c = q.QM31(*(V[cw, k] for k in range(4)))

        is_arith = (1 - op3) * (1 - op4)
        non_arith = is_arith == 0
        assert (op1[non_arith] == 1).all() and (
            op1[(op2 == 1) & (op3 == 0) & (op4 == 1)] == 1
        ).all(), "SIMD gates require op1 = 1"

        arith = q.q_add(
            q_mul_scalar_m31(q.q_add(a, b), op1),
            q_mul_scalar_m31(q.q_mul(a, b), (1 - op1) % P),
        )
        had = q.QM31(*(m.mul(getattr(a, f), getattr(b, f)) for f in "abcd"))
        m4 = _m4_vec(had)
        gs = had.a * 0
        for f in "abcd":
            gs = m.add(m.add(gs, getattr(a, f)), getattr(b, f))
        gsq = q.QM31(gs, gs, gs, gs)

        is_m4 = op3 * (1 - op4)
        is_had = (1 - op3) * op4
        is_gs = op3 * op4
        # pow5 family additionally pins b = a^4 limb-wise
        pow4 = q.QM31(
            *(m.mul(m.mul(x, x), m.mul(x, x)) for x in (a.a, a.b, a.c, a.d))
        )
        p5rows = op2 == 1
        for f in "abcd":
            assert (
                getattr(pow4, f)[p5rows] == getattr(b, f)[p5rows]
            ).all(), "pow5 gate: b != a^4"

        expected = q.QM31(
            *(
                (
                    is_arith * getattr(arith, f).astype(np.int64)
                    + is_m4 * getattr(m4, f)
                    + is_had * getattr(had, f)
                    + is_gs * getattr(gsq, f)
                )
                for f in "abcd"
            )
        )
        for f in "abcd":
            bad = np.nonzero(getattr(expected, f) != getattr(c, f))[0]
            assert bad.size == 0, f"rows {bad[:10]} fail ({f} limb)"

    def populate_logup_arguments(self):
        """(plonk_without_poseidon.rs:600-631): only c-wire multiplicities."""
        assert self.mult_c is None
        n_vars = len(self.variables)
        n_rows = len(self.a_wire)
        assert n_rows & (n_rows - 1) == 0
        aw = np.asarray(self.a_wire)
        bw = np.asarray(self.b_wire)
        cw = np.asarray(self.c_wire)
        counts = np.zeros(n_vars, dtype=np.int64)
        np.add.at(counts, aw, 1)
        np.add.at(counts, bw, 1)
        np.add.at(counts, cw, 1)
        counts[1 : 1 + self.num_input] += 1
        _, first_idx = np.unique(cw, return_index=True)
        mult_c = np.ones(n_rows, dtype=np.int64)
        mult_c[first_idx] = 1 - counts[cw[first_idx]]
        self.mult_c = mult_c

    def generate_trace(self) -> dict:
        n_rows = len(self.a_wire)
        assert n_rows & (n_rows - 1) == 0 and n_rows >= N_LANES
        assert self.mult_c is not None
        V = np.array(self.variables, dtype=np.uint32)
        aw = np.asarray(self.a_wire, dtype=np.uint32)
        bw = np.asarray(self.b_wire, dtype=np.uint32)
        cw = np.asarray(self.c_wire, dtype=np.uint32)
        cols = {
            "mult_c": np.asarray(self.mult_c % P, dtype=np.uint32),
            "a_wire": aw,
            "b_wire": bw,
            "c_wire": cw,
            "op1": np.asarray(self.op1, dtype=np.uint32),
            "op2": np.asarray(self.op2, dtype=np.uint32),
            "op3": np.asarray(self.op3, dtype=np.uint32),
            "op4": np.asarray(self.op4, dtype=np.uint32),
        }
        for name, w in (("a", aw), ("b", bw), ("c", cw)):
            for k in range(4):
                cols[f"{name}_val_{k}"] = V[w, k]
        return cols


def _m4_vec(x):
    """Vectorized M4 butterfly on a core-SoA QM31 of M31 lanes."""
    from ..core import m31_host as m

    t0 = m.add(x.a, x.b)
    t1 = m.add(x.c, x.d)
    t2 = m.add(m.double(x.b), t1)
    t3 = m.add(m.double(x.d), t0)
    t4 = m.add(m.double(m.double(t1)), t3)
    t5 = m.add(m.double(m.double(t0)), t2)
    from ..core.qm31_host import QM31

    return QM31(m.add(t3, t5), t5, m.add(t2, t4), t4)
