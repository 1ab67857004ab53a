"""Field gadget variables: M31Var / CM31Var / QM31Var.

Each Var holds a concrete scalar value (python ints, `cs.scalar` layout) and
a wire index into a shared constraint system; executing ordinary arithmetic
eagerly computes the witness AND appends Plonk gates.

Gate-emission semantics mirror the reference exactly:
/root/reference/primitives/fields/src/{m31,cm31,qm31}.rs.  A CM31 is
embedded in one QM31 wire as re + i*im via the pinned wire 2 (= i); a QM31
occupies one wire.

One deliberate strengthening vs the reference: `CM31Var.inv` constrains
x * x^-1 = 1 (the reference allocates the inverse unconstrained,
cm31.rs:240-245 — see SURVEY.md soundness notes).  This adds 2 gates per
CM31 inversion.
"""

from __future__ import annotations

from ..cs import scalar
from ..cs.scalar import P
from ..cs.system import Mode


class M31Var:
    __slots__ = ("cs", "value", "variable")

    def __init__(self, cs, value: int, variable: int):
        self.cs = cs
        self.value = value % P
        self.variable = variable

    # -- allocation --------------------------------------------------------
    @classmethod
    def new_witness(cls, cs, value: int) -> "M31Var":
        return cls(cs, value, cs.new_m31(value % P, Mode.WITNESS))

    @classmethod
    def new_public_input(cls, cs, value: int) -> "M31Var":
        return cls(cs, value, cs.new_m31(value % P, Mode.PUBLIC_INPUT))

    @classmethod
    def new_constant(cls, cs, value: int) -> "M31Var":
        value = value % P
        if value == 0:
            return cls.zero(cs)
        if value == 1:
            return cls.one(cs)
        key = f"m31 {value}"
        idx = cs.get_cache(key)
        if idx is None:
            idx = cs.new_m31(value, Mode.CONSTANT)
            cs.set_cache(key, idx)
        return cls(cs, value, idx)

    @classmethod
    def zero(cls, cs) -> "M31Var":
        return cls(cs, 0, 0)

    @classmethod
    def one(cls, cs) -> "M31Var":
        return cls(cs, 1, 1)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, rhs):
        if not isinstance(rhs, M31Var):  # CM31Var / QM31Var: delegate
            return rhs + self
        return M31Var(
            self.cs,
            self.value + rhs.value,
            self.cs.add(self.variable, rhs.variable),
        )

    def __neg__(self) -> "M31Var":
        return M31Var(
            self.cs, -self.value, self.cs.mul_constant(self.variable, P - 1)
        )

    def __sub__(self, rhs):
        if not isinstance(rhs, M31Var):
            return (-rhs) + self
        return self + (-rhs)

    def __mul__(self, rhs):
        if not isinstance(rhs, M31Var):  # CM31Var / QM31Var: delegate
            return rhs * self
        return M31Var(
            self.cs,
            self.value * rhs.value,
            self.cs.mul(self.variable, rhs.variable),
        )

    def mul_constant(self, constant: int) -> "M31Var":
        return M31Var(
            self.cs,
            self.value * constant,
            self.cs.mul_constant(self.variable, constant % P),
        )

    def equalverify(self, rhs: "M31Var") -> None:
        assert self.value == rhs.value
        self.cs.insert_gate(self.variable, 0, rhs.variable, 1)

    def inv(self) -> "M31Var":
        res = M31Var.new_witness(self.cs, scalar.m_inv(self.value))
        self.cs.insert_gate(self.variable, res.variable, 1, 0)
        return res

    def is_zero(self) -> "M31Var":
        """1 if self == 0 else 0, with gate x * out = 0 and out = 1 - x*inv
        (m31.rs:166-179)."""
        inv = M31Var.new_witness(
            self.cs, 0 if self.value == 0 else scalar.m_inv(self.value)
        )
        out = -(self * inv) + M31Var.one(self.cs)
        self.cs.insert_gate(self.variable, out.variable, 0, 0)
        return out

    def is_eq(self, rhs: "M31Var") -> "M31Var":
        return (self - rhs).is_zero()


class CM31Var:
    __slots__ = ("cs", "value", "variable")

    def __init__(self, cs, value, variable: int):
        self.cs = cs
        self.value = (value[0] % P, value[1] % P)
        self.variable = variable

    @classmethod
    def new_witness(cls, cs, value) -> "CM31Var":
        real = M31Var.new_witness(cs, value[0])
        imag = M31Var.new_witness(cs, value[1])
        v = cs.add(real.variable, cs.mul(imag.variable, 2))
        return cls(cs, value, v)

    @classmethod
    def new_public_input(cls, cs, value) -> "CM31Var":
        real = M31Var.new_public_input(cs, value[0])
        imag = M31Var.new_public_input(cs, value[1])
        v = cs.add(real.variable, cs.mul(imag.variable, 2))
        return cls(cs, value, v)

    @classmethod
    def new_constant(cls, cs, value) -> "CM31Var":
        value = (value[0] % P, value[1] % P)
        if value == (0, 0):
            return cls.zero(cs)
        if value == (1, 0):
            return cls.one(cs)
        if value == (0, 1):
            return cls.i(cs)
        key = f"cm31 {value[0]},{value[1]}"
        idx = cs.get_cache(key)
        if idx is None:
            real = M31Var.new_constant(cs, value[0])
            imag = M31Var.new_constant(cs, value[1])
            idx = cs.add(real.variable, cs.mul(imag.variable, 2))
            cs.set_cache(key, idx)
        return cls(cs, value, idx)

    @classmethod
    def zero(cls, cs) -> "CM31Var":
        return cls(cs, (0, 0), 0)

    @classmethod
    def one(cls, cs) -> "CM31Var":
        return cls(cs, (1, 0), 1)

    @classmethod
    def i(cls, cs) -> "CM31Var":
        return cls(cs, (0, 1), 2)

    @classmethod
    def from_m31(cls, real: M31Var, imag: M31Var) -> "CM31Var":
        cs = real.cs
        v = cs.add(real.variable, cs.mul(imag.variable, 2))
        return cls(cs, (real.value, imag.value), v)

    @classmethod
    def from_single_m31(cls, x: M31Var) -> "CM31Var":
        return cls(x.cs, (x.value, 0), x.variable)

    def _c(self, other):
        ov = (
            (other.value, 0) if isinstance(other, M31Var) else other.value
        )
        return ov

    def __add__(self, rhs) -> "CM31Var":
        ov = self._c(rhs)
        return CM31Var(
            self.cs,
            (self.value[0] + ov[0], self.value[1] + ov[1]),
            self.cs.add(self.variable, rhs.variable),
        )

    def __neg__(self) -> "CM31Var":
        return CM31Var(
            self.cs,
            (-self.value[0], -self.value[1]),
            self.cs.mul_constant(self.variable, P - 1),
        )

    def __sub__(self, rhs) -> "CM31Var":
        if isinstance(rhs, M31Var):
            rhs = CM31Var.from_single_m31(rhs)
        return self + (-rhs)

    def __mul__(self, rhs) -> "CM31Var":
        ov = self._c(rhs)
        return CM31Var(
            self.cs,
            scalar.c_mul(self.value[0], self.value[1], ov[0], ov[1]),
            self.cs.mul(self.variable, rhs.variable),
        )

    def mul_constant_m31(self, constant: int) -> "CM31Var":
        return CM31Var(
            self.cs,
            (self.value[0] * constant, self.value[1] * constant),
            self.cs.mul_constant(self.variable, constant % P),
        )

    def mul_constant_cm31(self, constant) -> "CM31Var":
        a = self.mul_constant_m31(constant[0])
        b = self.mul_constant_m31(constant[1])
        v = self.cs.add(a.variable, self.cs.mul(b.variable, 2))
        return CM31Var(
            self.cs,
            scalar.c_mul(self.value[0], self.value[1], constant[0], constant[1]),
            v,
        )

    def shift_by_i(self) -> "CM31Var":
        return CM31Var(
            self.cs,
            (-self.value[1], self.value[0]),
            self.cs.mul(self.variable, 2),
        )

    def equalverify(self, rhs: "CM31Var") -> None:
        assert self.value == rhs.value
        self.cs.insert_gate(self.variable, 0, rhs.variable, 1)

    def inv(self) -> "CM31Var":
        nr, ni = self.value
        norm = (nr * nr + ni * ni) % P
        w = scalar.m_inv(norm)
        val = (nr * w % P, (-ni) * w % P)
        res = CM31Var.new_witness(self.cs, val)
        # strengthened vs reference: constrain x * x^-1 = 1 (module docstring)
        prod = self.cs.mul(self.variable, res.variable)
        self.cs.insert_gate(prod, 0, 1, 1)
        return res


class QM31Var:
    __slots__ = ("cs", "value", "variable")

    def __init__(self, cs, value, variable: int):
        self.cs = cs
        self.value = tuple(v % P for v in value)
        self.variable = variable

    @classmethod
    def new_witness(cls, cs, value) -> "QM31Var":
        return cls(cs, value, cs.new_qm31(tuple(value), Mode.WITNESS))

    @classmethod
    def new_public_input(cls, cs, value) -> "QM31Var":
        return cls(cs, value, cs.new_qm31(tuple(value), Mode.PUBLIC_INPUT))

    @classmethod
    def new_constant(cls, cs, value) -> "QM31Var":
        value = tuple(v % P for v in value)
        if value == scalar.QZERO:
            return cls.zero(cs)
        if value == scalar.QONE:
            return cls.one(cs)
        if value == scalar.QI:
            return cls.i(cs)
        if value == scalar.QJ:
            return cls.j(cs)
        key = f"qm31 {value[0]},{value[1]},{value[2]},{value[3]}"
        idx = cs.get_cache(key)
        if idx is None:
            idx = cs.new_qm31(value, Mode.CONSTANT)
            cs.set_cache(key, idx)
        return cls(cs, value, idx)

    @classmethod
    def zero(cls, cs) -> "QM31Var":
        return cls(cs, scalar.QZERO, 0)

    @classmethod
    def one(cls, cs) -> "QM31Var":
        return cls(cs, scalar.QONE, 1)

    @classmethod
    def i(cls, cs) -> "QM31Var":
        return cls(cs, scalar.QI, 2)

    @classmethod
    def j(cls, cs) -> "QM31Var":
        return cls(cs, scalar.QJ, 3)

    @classmethod
    def from_m31var(cls, x: M31Var) -> "QM31Var":
        return cls(x.cs, scalar.q_from_m31(x.value), x.variable)

    @classmethod
    def from_cm31var(cls, x: CM31Var) -> "QM31Var":
        return cls(x.cs, (x.value[0], x.value[1], 0, 0), x.variable)

    @classmethod
    def from_m31(cls, a0: M31Var, a1: M31Var, a2: M31Var, a3: M31Var):
        """1,i,j-basis composition gates (qm31.rs:256-270):
        wire = (a0 + i*a1) + j*(a2 + i*a3)."""
        cs = a0.cs
        v = cs.add(
            cs.add(a0.variable, cs.mul(a1.variable, 2)),
            cs.mul(cs.add(a2.variable, cs.mul(a3.variable, 2)), 3),
        )
        return cls(cs, (a0.value, a1.value, a2.value, a3.value), v)

    @classmethod
    def from_cm31(cls, a: CM31Var, b: CM31Var) -> "QM31Var":
        cs = a.cs
        v = cs.add(a.variable, cs.mul(b.variable, 3))
        return cls(cs, (a.value[0], a.value[1], b.value[0], b.value[1]), v)

    def _q(self, other):
        if isinstance(other, M31Var):
            return scalar.q_from_m31(other.value)
        if isinstance(other, CM31Var):
            return (other.value[0], other.value[1], 0, 0)
        return other.value

    def __add__(self, rhs) -> "QM31Var":
        return QM31Var(
            self.cs,
            scalar.q_add(self.value, self._q(rhs)),
            self.cs.add(self.variable, rhs.variable),
        )

    def __radd__(self, lhs) -> "QM31Var":
        return self + lhs

    def __neg__(self) -> "QM31Var":
        return QM31Var(
            self.cs,
            scalar.q_neg(self.value),
            self.cs.mul_constant(self.variable, P - 1),
        )

    def __sub__(self, rhs) -> "QM31Var":
        if not isinstance(rhs, QM31Var):
            rhs = (
                QM31Var.from_m31var(rhs)
                if isinstance(rhs, M31Var)
                else QM31Var.from_cm31var(rhs)
            )
        return self + (-rhs)

    def __rsub__(self, lhs) -> "QM31Var":
        return (-self) + lhs

    def __mul__(self, rhs) -> "QM31Var":
        return QM31Var(
            self.cs,
            scalar.q_mul(self.value, self._q(rhs)),
            self.cs.mul(self.variable, rhs.variable),
        )

    def __rmul__(self, lhs) -> "QM31Var":
        return self * lhs

    def decompose_m31(self) -> list:
        """4 limb witnesses + recomposition gate (qm31.rs:272-290)."""
        cs = self.cs
        limbs = [M31Var.new_witness(cs, v) for v in self.value]
        l = cs.add(limbs[0].variable, cs.mul(limbs[1].variable, 2))
        r = cs.mul(cs.add(limbs[2].variable, cs.mul(limbs[3].variable, 2)), 3)
        cs.insert_gate(l, r, self.variable, 1)
        return limbs

    def decompose_cm31(self) -> list:
        v = self.decompose_m31()
        a0 = CM31Var.from_single_m31(v[1]).shift_by_i() + v[0]
        a1 = CM31Var.from_single_m31(v[3]).shift_by_i() + v[2]
        return [a0, a1]

    def pow(self, exp: int) -> "QM31Var":
        bools = []
        e = exp
        while e > 0:
            bools.append(e & 1 != 0)
            e >>= 1
        cur = QM31Var.one(self.cs)
        for i in reversed(range(len(bools))):
            if bools[i]:
                cur = cur * self
            if i != 0:
                cur = cur * cur
        return cur

    def equalverify(self, rhs: "QM31Var") -> None:
        assert self.value == rhs.value, (self.value, rhs.value)
        self.cs.insert_gate(self.variable, 0, rhs.variable, 1)

    def inv(self) -> "QM31Var":
        res = QM31Var.new_witness(self.cs, scalar.q_inv(self.value))
        self.cs.insert_gate(self.variable, res.variable, 1, 0)
        return res

    def mul_constant_m31(self, constant: int) -> "QM31Var":
        return QM31Var(
            self.cs,
            scalar.q_mul_m31(self.value, constant % P),
            self.cs.mul_constant(self.variable, constant % P),
        )

    def mul_constant_cm31(self, constant) -> "QM31Var":
        a = self.mul_constant_m31(constant[0])
        b = self.mul_constant_m31(constant[1])
        v = self.cs.add(a.variable, self.cs.mul(b.variable, 2))
        return QM31Var(
            self.cs,
            scalar.q_mul(self.value, (constant[0], constant[1], 0, 0)),
            v,
        )

    def mul_constant_qm31(self, constant) -> "QM31Var":
        cs = self.cs
        cvar = cs.new_qm31(tuple(constant), Mode.CONSTANT)
        return QM31Var(
            cs, scalar.q_mul(self.value, tuple(constant)), cs.mul(self.variable, cvar)
        )

    def shift_by_i(self) -> "QM31Var":
        return QM31Var(
            self.cs,
            scalar.q_mul(self.value, scalar.QI),
            self.cs.mul(self.variable, 2),
        )

    def shift_by_j(self) -> "QM31Var":
        return QM31Var(
            self.cs,
            scalar.q_mul(self.value, scalar.QJ),
            self.cs.mul(self.variable, 3),
        )

    def shift_by_ij(self) -> "QM31Var":
        return self.shift_by_i().shift_by_j()

    @staticmethod
    def select(a: "QM31Var", b: "QM31Var", bit_value, bit_variable: int):
        """a + (b - a) * bit (qm31.rs:420-437)."""
        cs = a.cs
        value = b.value if bit_value else a.value
        b_minus_a = b - a
        v = cs.add(a.variable, cs.mul(b_minus_a.variable, bit_variable))
        return QM31Var(cs, value, v)

    @staticmethod
    def swap(a: "QM31Var", b: "QM31Var", bit_value, bit_variable: int):
        """(a,b) if bit==0 else (b,a) (qm31.rs:439-464)."""
        cs = a.cs
        lv, rv = (b.value, a.value) if bit_value else (a.value, b.value)
        b_minus_a = b - a
        left = cs.mul(b_minus_a.variable, bit_variable)
        right = cs.mul_constant(left, P - 1)
        left = cs.add(a.variable, left)
        right = cs.add(b.variable, right)
        return QM31Var(cs, lv, left), QM31Var(cs, rv, right)
