"""Query-position gadgets
(reference: /root/reference/primitives/query/src/lib.rs).

A `PointCarryingQueryVar` holds the query's bit decomposition plus the
circle-domain point it addresses, built with a 2-bits-at-a-time
constant-point-lookup MUX chain; `next()` halves the query and doubles the
point (FRI folding).  `QueryPositionsPerLogSizeVar` derives one query set
per log_size by successive folding.
"""

from __future__ import annotations

from ..core import circle_host as ccircle
from ..cs.scalar import P
from .bits import BitsVar
from .circle import CirclePointM31
from .fields import M31Var


class PointCarryingQueryVar:
    __slots__ = ("bits", "last_step", "point")

    def __init__(self, bits: BitsVar, last_step=None, point=None):
        if last_step is not None:
            self.bits, self.last_step, self.point = bits, last_step, point
            return
        cs = bits.cs
        log_size = len(bits.value)
        coset = ccircle.CanonicCoset(log_size + 1).circle_domain().half_coset

        steps = []
        cur = coset.step
        for _ in range(log_size - 1):
            steps.append(cur)
            cur = ccircle.point_double(cur)

        rev = list(zip(bits.value[1:], bits.variables[1:]))[::-1]
        combs = list(zip(steps, rev))

        total = CirclePointM31.new_constant(cs, coset.initial)
        for k in range(0, len(combs), 2):
            chunk = combs[k : k + 2]
            if len(chunk) == 1:
                step, (bv, bvar) = chunk[0]
                total = CirclePointM31.select(cs, step, bv, bvar) + total
            else:
                # 4-way constant lookup on two bits (query lib.rs:87-135)
                p01 = chunk[0][0]
                p10 = chunk[1][0]
                p00 = (1, 0)
                p11 = ccircle.point_add(p01, p10)
                a_bv, a_var = chunk[0][1]
                b_bv, b_var = chunk[1][1]
                value = {
                    (False, False): p00,
                    (True, False): p01,
                    (False, True): p10,
                    (True, True): p11,
                }[(a_bv, b_bv)]

                one_minus_a = cs.add(1, cs.mul_constant(a_var, P - 1))
                one_minus_b = cs.add(1, cs.mul_constant(b_var, P - 1))
                b00 = cs.mul(one_minus_a, one_minus_b)
                b01 = cs.mul(a_var, one_minus_b)
                b10 = cs.mul(one_minus_a, b_var)
                b11 = cs.mul(a_var, b_var)

                x = cs.mul_constant(b00, p00[0])
                x = cs.add(x, cs.mul_constant(b01, p01[0]))
                x = cs.add(x, cs.mul_constant(b10, p10[0]))
                x = cs.add(x, cs.mul_constant(b11, p11[0]))
                y = cs.mul_constant(b00, p00[1])
                y = cs.add(y, cs.mul_constant(b01, p01[1]))
                y = cs.add(y, cs.mul_constant(b10, p10[1]))
                y = cs.add(y, cs.mul_constant(b11, p11[1]))

                point = CirclePointM31(
                    M31Var(cs, value[0], x), M31Var(cs, value[1], y)
                )
                total = point + total

        self.bits = bits
        self.last_step = ccircle.point_neg(steps[-1])
        self.point = total

    def clone(self) -> "PointCarryingQueryVar":
        return PointCarryingQueryVar(self.bits, self.last_step, self.point)

    def get_next_point(self) -> CirclePointM31:
        return self.point.double().conditional_negate(
            self.bits.value[0], self.bits.variables[0]
        )

    def get_next_point_x(self) -> M31Var:
        xx = self.point.x * self.point.x
        yy = self.point.y * self.point.y
        return xx - yy

    def next(self) -> None:
        assert len(self.bits.value) > 1
        cs = self.bits.cs
        t = CirclePointM31.select(
            cs, self.last_step, self.bits.value[1], self.bits.variables[1]
        )
        self.bits = self.bits.index_range(1)
        self.point = (self.point + t).double()

    def get_absolute_point(self) -> CirclePointM31:
        return self.point


class QueryPositionsPerLogSizeVar:
    """One query-point set per log_size in [min_degree, max_degree]
    (query lib.rs:13-39)."""

    def __init__(self, min_degree: int, max_degree: int, raw_queries):
        elems = [
            PointCarryingQueryVar(
                BitsVar.from_m31(rq, 31).index_range(0, max_degree)
            )
            for rq in raw_queries
        ]
        self.points = {max_degree: [e.clone() for e in elems]}
        for log_size in range(max_degree - 1, min_degree - 1, -1):
            for e in elems:
                e.next()
            self.points[log_size] = [e.clone() for e in elems]

    def __getitem__(self, log_size: int):
        return self.points[log_size]
