"""Circle-point gadgets (reference: /root/reference/primitives/circle/src/lib.rs).

`CirclePointM31` — a point with M31 coordinates (query-addressed domain
points); `CirclePointQM31` — a point over the extension field (the OODS
point), built from a channel draw via the stereographic map
t -> ((1-t^2)/(1+t^2), 2t/(1+t^2)).
"""

from __future__ import annotations

from ..core import circle_host as ccircle
from .bits import BitsVar
from .fields import M31Var, QM31Var


class CirclePointM31:
    __slots__ = ("x", "y")

    def __init__(self, x: M31Var, y: M31Var):
        self.x = x
        self.y = y

    @property
    def cs(self):
        return self.x.cs

    def value(self):
        return (self.x.value, self.y.value)

    @classmethod
    def new_constant(cls, cs, point) -> "CirclePointM31":
        return cls(
            M31Var.new_constant(cs, point[0]), M31Var.new_constant(cs, point[1])
        )

    @classmethod
    def new_witness(cls, cs, point) -> "CirclePointM31":
        return cls(
            M31Var.new_witness(cs, point[0]), M31Var.new_witness(cs, point[1])
        )

    def __add__(self, rhs: "CirclePointM31") -> "CirclePointM31":
        x1x2 = self.x * rhs.x
        y1y2 = self.y * rhs.y
        x1y2 = self.x * rhs.y
        y1x2 = self.y * rhs.x
        return CirclePointM31(x1x2 - y1y2, x1y2 + y1x2)

    def double(self) -> "CirclePointM31":
        xx = self.x * self.x
        yy = self.y * self.y
        xy = self.x * self.y
        return CirclePointM31(xx - yy, xy.mul_constant(2))

    @staticmethod
    def select(cs, point, bit_value, bit_variable) -> "CirclePointM31":
        """bit ? point : identity(1,0), by constant-affine wires
        (circle lib.rs:74-106)."""
        value = point if bit_value else (1, 0)
        new_x = cs.mul_constant(bit_variable, (point[0] - 1) % ccircle.P)
        new_x = cs.add(new_x, 1)
        new_y = cs.mul_constant(bit_variable, point[1])
        return CirclePointM31(
            M31Var(cs, value[0], new_x), M31Var(cs, value[1], new_y)
        )

    def conditional_negate(self, bit_value, bit_variable) -> "CirclePointM31":
        cs = self.cs
        y_value = -self.y.value if bit_value else self.y.value
        mult = cs.add(1, cs.mul_constant(bit_variable, ccircle.P - 2))
        y_var = cs.mul(mult, self.y.variable)
        return CirclePointM31(self.x, M31Var(cs, y_value, y_var))

    @staticmethod
    def bit_reverse_at(coset, bits: BitsVar, log_size: int) -> "CirclePointM31":
        """Coset point addressed by bit-reversed query bits
        (circle lib.rs:135-169)."""
        assert len(bits.value) == log_size
        cs = bits.cs

        steps = []
        cur = coset.step
        for _ in range(log_size - 1):
            steps.append(cur)
            cur = ccircle.point_double(cur)

        total = CirclePointM31.new_constant(cs, coset.initial)
        rev = list(zip(bits.value[1:], bits.variables[1:]))[::-1]
        for step, (bv, bvar) in zip(steps, rev):
            total = total + CirclePointM31.select(cs, step, bv, bvar)
        return total.conditional_negate(bits.value[0], bits.variables[0])


class CirclePointQM31:
    __slots__ = ("x", "y")

    def __init__(self, x: QM31Var, y: QM31Var):
        self.x = x
        self.y = y

    @property
    def cs(self):
        return self.x.cs

    def value(self):
        return (self.x.value, self.y.value)

    @classmethod
    def new_witness(cls, cs, point) -> "CirclePointQM31":
        return cls(
            QM31Var.new_witness(cs, point[0]), QM31Var.new_witness(cs, point[1])
        )

    @classmethod
    def from_t(cls, t: QM31Var) -> "CirclePointQM31":
        cs = t.cs
        one = M31Var.one(cs)
        t_doubled = t + t
        t_squared = t * t
        t2p1_inv = (t_squared + one).inv()
        one_minus_t2 = (-t_squared) + one
        return cls(one_minus_t2 * t2p1_inv, t_doubled * t2p1_inv)

    @classmethod
    def from_channel(cls, channel) -> "CirclePointQM31":
        t, _ = channel.draw_felts()
        return cls.from_t(t)

    def repeated_double_x_only(self, log_size: int) -> QM31Var:
        x = self.x
        one = M31Var.one(self.cs)
        for _ in range(log_size):
            xsq = x * x
            x = (xsq + xsq) - one
        return x

    def add_constant_point(self, rhs) -> "CirclePointQM31":
        """self + constant M31 point (circle lib.rs:236-250)."""
        x1x2 = self.x.mul_constant_m31(rhs[0])
        y1y2 = self.y.mul_constant_m31(rhs[1])
        x1y2 = self.x.mul_constant_m31(rhs[1])
        y1x2 = self.y.mul_constant_m31(rhs[0])
        return CirclePointQM31(x1x2 - y1y2, x1y2 + y1x2)
