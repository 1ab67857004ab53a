"""Bit-decomposition gadget (reference: /root/reference/primitives/bits/src/lib.rs).

A BitsVar is a little-endian list of boolean wires, each constrained by
b * (b - 1) = 0 at witness allocation; `from_m31` additionally ties the
recomposition to the source wire and, for l=31, excludes the all-ones
(2^31 - 1 == 0) encoding.
"""

from __future__ import annotations

from .fields import M31Var
from ..cs.system import Mode


class BitsVar:
    __slots__ = ("cs", "value", "variables")

    def __init__(self, cs, value, variables):
        self.cs = cs
        self.value = list(value)
        self.variables = list(variables)

    @classmethod
    def new_witness(cls, cs, bools) -> "BitsVar":
        variables = []
        for b in bools:
            bit = cs.new_qm31((1, 0, 0, 0) if b else (0, 0, 0, 0), Mode.WITNESS)
            variables.append(bit)
            # b * (b - 1) = 0 (lib.rs:30-40)
            minus_one = M31Var.new_constant(cs, -1)
            bit_minus_one = cs.add(bit, minus_one.variable)
            cs.insert_gate(bit, bit_minus_one, 0, 0)
        return cls(cs, bools, variables)

    @classmethod
    def from_m31(cls, v: M31Var, l: int) -> "BitsVar":
        cs = v.cs
        bools = [(v.value >> k) & 1 != 0 for k in range(l)]
        res = cls.new_witness(cs, bools)

        def as_m31(k):
            return M31Var(cs, 1 if res.value[k] else 0, res.variables[k])

        recon = as_m31(0)
        for k in range(1, l):
            recon = recon + as_m31(k).mul_constant(1 << k)
        recon.equalverify(v)

        if l == 31:  # not-all-ones (lib.rs:74-80)
            product = cs.mul(res.variables[0], res.variables[1])
            for k in range(2, l):
                product = cs.mul(product, res.variables[k])
            cs.enforce_zero(product)
        return res

    def get_value(self) -> int:
        return sum(1 << k for k, b in enumerate(self.value) if b)

    def compose_range(self, start: int, end: int) -> M31Var:
        cs = self.cs
        sum_value = 1 if self.value[start] else 0
        sum_variable = self.variables[start]
        for shift, k in enumerate(range(start + 1, end)):
            if self.value[k]:
                sum_value += 1 << (shift + 1)
            shifted = cs.mul_constant(self.variables[k], 1 << (shift + 1))
            sum_variable = cs.add(sum_variable, shifted)
        return M31Var(cs, sum_value, sum_variable)

    def index_range(self, start: int, end=None) -> "BitsVar":
        sl = slice(start, end)
        return BitsVar(self.cs, self.value[sl], self.variables[sl])
