"""FRI last-layer line-polynomial gadget
(reference: /root/reference/primitives/line/src/lib.rs)."""

from __future__ import annotations

from .fields import M31Var, QM31Var


class LinePolyVar:
    __slots__ = ("cs", "coeffs")

    def __init__(self, cs, coeffs):
        self.cs = cs
        self.coeffs = list(coeffs)

    @classmethod
    def new_witness(cls, cs, coeffs) -> "LinePolyVar":
        return cls(cs, [QM31Var.new_witness(cs, c) for c in coeffs])

    def eval_at_point(self, x: M31Var) -> QM31Var:
        cs = self.cs
        log_size = len(self.coeffs).bit_length() - 1
        assert 1 << log_size == len(self.coeffs)

        doublings = [x]
        for _ in range(1, log_size):
            xsq = x * x
            x = (xsq + xsq) + M31Var.new_constant(cs, -1)
            doublings.append(x)

        def fold(values, factors):
            n = len(values)
            if n == 1:
                return values[0]
            lhs = fold(values[: n // 2], factors[1:])
            rhs = fold(values[n // 2 :], factors[1:])
            return lhs + (rhs * factors[0])

        return fold(self.coeffs, doublings)
