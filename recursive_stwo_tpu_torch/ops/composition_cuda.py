"""ctypes wrappers of the composition kernels (csrc/composition.cu).

  check(spec, samples_flat, sums, lookup, random_coeff, oods_x)
      -> ((B,) bool, (B, 4) int64): the composition check at the OODS point
      of a batch, a warp a proof; the twin of what XLA compiled from
      recursive_stwo_tpu/verifier/composition.py `composition_check`
      (:533-582) and `composition_check_np` (:280-317).  The with-Poseidon
      pair (plonk then poseidon) or the without-Poseidon AIR, told apart by
      the spec's class.
  domain(evaluate_fn, pre, tr, inter, perm, denom_inv, acc, first, total,
         lookup, random_coeff, log_size)
      one AIR table's constraints folded into the (4, N) accumulator over
      the 2**bound domain, one thread a point; the twin of
      recursive_stwo_tpu/prover/device_prove.py `_ProverEval` (:202-274)
      in `_stage_composition_jit` (:417-474).  Horner's fold of the
      table's n constraints is the weighted sum acc rc^n + sum of c_i
      rc^(n-1-i) / vanishing, from a table of rc's powers built here once a
      launch (`domain_powers`).

They take CUDA int64 tensors of canonical residues and raise on anything
else; the plain versions are verifier/composition.composition_value_plain
and prover/composition.composition_evals_plain.  A kernel launches on the
current stream of its tensors' device and does not synchronise.
`LAUNCHES` counts the launches of each kernel.

The check kernel reads samples through an index table, built here on the
host from `spec.sample_offsets` and cached per spec: entry k is the sample
index of the k-th mask the eager evaluators read (`_Eval._gather`'s order:
each component's preprocessed masks, trace masks, interaction masks, the
last interaction mask's previous and current row column by column), then
the 8 composition samples.  The lane table follows it in the same device
tensor (`lane_table`, `lane_words`): for each of the kernel's stages and
lanes, the constraint the lane computes there, which fixes its power of
random_coeff in the weighted sum that replaces the Horner fold.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..core import qm31_host as qh
from ..verifier.spec import (
    N_INTERACTION_PLONK,
    N_PREPROCESSED_PLONK,
    N_TRACE_PLONK,
    NoPoseidonVerifierSpec,
)
from . import build
from .poseidon_cuda import H100_BYTES_PER_S, H100_INT_OPS_PER_S, _raise_on

P = 2**31 - 1
LAUNCHES = {"composition_check": 0, "composition_domain": 0}

# csrc/composition.cu's ids
WITH_POSEIDON, WITHOUT_POSEIDON = 0, 1
PLONK, POSEIDON, PLONK_NP = 0, 1, 2
# an AIR's reads (csrc/composition_air.cuh): preprocessed masks, trace
# masks, logup fractions and their batch size
AIR_SHAPES = {PLONK: (10, 12, 4, 2), POSEIDON: (40, 48, 5, 3), PLONK_NP: (8, 12, 3, 2)}
# each flavour's components: (AIR, tree column bases)
FLAVOUR_AIRS = {
    WITH_POSEIDON: ((PLONK, (0, 0, 0)), (POSEIDON, (N_PREPROCESSED_PLONK, N_TRACE_PLONK, N_INTERACTION_PLONK))),
    WITHOUT_POSEIDON: ((PLONK_NP, (0, 0, 0)),),
}
N_COMPOSITION_SAMPLES = 8
# csrc/composition_air.cuh's constraint kinds (its enum Kind, in order), and
# each AIR's constraints in emission (Horner) order as (kind, count) blocks,
# the twins of its kPlonkConstraints, kPoseidonConstraints, kNpConstraints
KINDS = ("enforce_c_m31", "gate", "logup", "first round", "full round", "full round out", "partial round",
         "partial out", "a^4 - b")
AIR_CONSTRAINTS = {
    PLONK: (("enforce_c_m31", 3), ("gate", 1), ("logup", 2)),
    POSEIDON: (("first round", 16), ("full round", 16), ("full round out", 16), ("partial round", 14),
               ("partial out", 16), ("logup", 2)),
    PLONK_NP: (("a^4 - b", 4), ("gate", 1), ("logup", 2)),
}
LANES = 32  # the check kernel's warp, one proof
# the check kernel's lanes, the twin of csrc/composition_air.cuh's
# kPoseidonLanes and kNpLanes: (stage, first lane, component, kind, count),
# each block a component's constraints of one kind in emission order on
# consecutive lanes of one stage
LANE_BLOCKS = {
    WITH_POSEIDON: ((0, 0, 1, "first round", 16), (1, 0, 1, "full round", 16), (2, 0, 0, "enforce_c_m31", 3),
                    (2, 3, 0, "gate", 1), (2, 4, 0, "logup", 2), (2, 6, 1, "logup", 2),
                    (2, 16, 1, "full round out", 16), (3, 0, 1, "partial round", 14), (3, 16, 1, "partial out", 16)),
    WITHOUT_POSEIDON: ((0, 0, 0, "a^4 - b", 4), (0, 4, 0, "gate", 1), (0, 5, 0, "logup", 2)),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flavour_of(spec) -> int:
    return WITHOUT_POSEIDON if isinstance(spec, NoPoseidonVerifierSpec) else WITH_POSEIDON


def air_id(evaluate_fn) -> int:
    """The domain kernel's AIR for an evaluator of verifier/composition.py;
    any other function raises."""
    from ..verifier import composition as vcomp

    ids = {vcomp.evaluate_plonk: PLONK, vcomp.evaluate_poseidon: POSEIDON, vcomp.evaluate_plonk_np: PLONK_NP}
    if evaluate_fn not in ids:
        raise ValueError(f"no composition kernel evaluates {evaluate_fn!r}")
    return ids[evaluate_fn]


def _batches(air: int) -> int:
    _, _, n_fracs, batch = AIR_SHAPES[air]
    return -(-n_fracs // batch)


@lru_cache(maxsize=None)
def index_table(spec) -> tuple:
    """The check kernel's index table of `spec` (see the module docstring)."""
    off = spec.sample_offsets
    table = []
    for air, (b_pre, b_tr, b_int) in FLAVOUR_AIRS[flavour_of(spec)]:
        n_pre, n_tr, _, _ = AIR_SHAPES[air]
        table += [off[0][b_pre + i] for i in range(n_pre)]
        table += [off[1][b_tr + i] for i in range(n_tr)]
        n_batches = _batches(air)
        for m in range(n_batches):
            cols = [off[2][b_int + 4 * m + j] for j in range(4)]
            table += cols if m < n_batches - 1 else [c + k for c in cols for k in (0, 1)]
    table += [off[3][i] for i in range(N_COMPOSITION_SAMPLES)]
    return tuple(table)


def constraint_order(flavour: int) -> list:
    """Every constraint of a flavour in Horner order: (component, kind, k),
    the k-th constraint of its kind in the component's AIR."""
    order = []
    for comp, (air, _) in enumerate(FLAVOUR_AIRS[flavour]):
        order += [(comp, kind, k) for kind, count in AIR_CONSTRAINTS[air] for k in range(count)]
    return order


def _lane_stages(flavour: int) -> list:
    """The check kernel's stages (LANE_BLOCKS): for each, what each of the
    32 lanes computes, (component, kind, k) or None."""
    blocks = LANE_BLOCKS[flavour]
    stages = [[None] * LANES for _ in range(1 + max(b[0] for b in blocks))]
    for stage, lane0, comp, kind, count in blocks:
        for k in range(count):
            if stages[stage][lane0 + k] is not None:
                raise ValueError(f"two constraints on lane {lane0 + k} of stage {stage}")
            stages[stage][lane0 + k] = (comp, kind, k)
    return stages


@lru_cache(maxsize=None)
def lane_table(spec) -> tuple:
    """The check kernel's lane table of `spec`: a stage, a tuple of 32 lanes,
    each (component, i) of the constraint the lane computes there (i its
    place in the Horner order, weighted by rc^(n-1-i)), or None.  Every
    constraint is on exactly one (stage, lane)."""
    flavour = flavour_of(spec)
    place = {c: i for i, c in enumerate(constraint_order(flavour))}
    table = tuple(tuple(None if e is None else (e[0], place[e]) for e in stage) for stage in _lane_stages(flavour))
    placed = sorted(i for stage in table for e in stage if e is not None for i in e[1:])
    if placed != list(range(len(place))):
        raise ValueError("the lane table does not place every constraint exactly once")
    return table


def lane_words(spec) -> tuple:
    """The lane table as the kernel reads it: component << 16 | (n - 1 - i),
    or -1."""
    n = len(constraint_order(flavour_of(spec)))
    return tuple(-1 if e is None else e[0] << 16 | (n - 1 - e[1]) for stage in lane_table(spec) for e in stage)


@lru_cache(maxsize=None)
def _device_table(spec, device) -> torch.Tensor:
    """The index table, then the lane table."""
    return torch.tensor(index_table(spec) + lane_words(spec), dtype=torch.int32, device=device)


def _inv_pow2(log_size: int) -> int:
    return pow(1 << log_size, P - 2, P)


def _log_sizes(spec) -> tuple:
    if flavour_of(spec) == WITHOUT_POSEIDON:
        return (spec.log_size,)
    return (spec.log_size_plonk, spec.log_size_poseidon)


def _check_tensor(x: torch.Tensor, name: str, shape: tuple, device=None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor for {name}, got one on {x.device}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != torch.int64:
        raise TypeError(f"expected torch.int64 for {name}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"expected {name} of shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"expected a contiguous tensor for {name}")


def check(spec, samples_flat: torch.Tensor, sums, lookup, random_coeff, oods_x) -> tuple:
    """The composition check of a batch on the card: `sums` is the
    components' total sums ((plonk, poseidon), or (total,) for the
    without-Poseidon AIR), `lookup` (z, alpha); every QM31 a tuple of four
    (B,) limbs.  Returns the (B,) bool and the (B, 4) Horner value."""
    flavour = flavour_of(spec)
    logs = _log_sizes(spec)
    if len(sums) != len(logs):
        raise ValueError(f"expected {len(logs)} total sums for this spec, got {len(sums)}")
    batch = samples_flat.shape[0]
    dev = samples_flat.device
    _check_tensor(samples_flat, "samples_flat", (batch, spec.total_samples, 4))
    qms = (*sums, *lookup, random_coeff, oods_x)
    params = torch.stack([torch.as_tensor(c, device=dev).expand(batch) for v in qms for c in v], dim=-1)
    _check_tensor(params, "the QM31 parameters", (batch, 4 * len(qms)), dev)
    bound = spec.composition_log_degree_bound
    steps = [L - 1 for L in logs] + [0] * (2 - len(logs)) + [bound - 2]
    if not all(0 <= s <= bound - 2 for s in steps):
        raise ValueError(f"log sizes {logs} do not fit the composition bound {bound}")
    inv2n = [_inv_pow2(L) for L in logs] + [0] * (2 - len(logs))
    table = _device_table(spec, dev)
    ok = torch.empty(batch, dtype=torch.bool, device=dev)
    value = torch.empty((batch, 4), dtype=torch.int64, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.composition_check(
            flavour, samples_flat.data_ptr(), spec.total_samples, table.data_ptr(), params.data_ptr(),
            len(qms), batch, (ctypes.c_int64 * 3)(*steps), (ctypes.c_int64 * 2)(*inv2n),
            ok.data_ptr(), value.data_ptr(), stream,
        )
    _raise_on(err, "composition_check")
    if batch:
        LAUNCHES["composition_check"] += 1
    return ok, value


def _canonical(v, name: str) -> list:
    limbs = [int(x) for x in v]
    if len(limbs) != 4 or not all(0 <= x < P for x in limbs):
        raise ValueError(f"expected four canonical M31 limbs for {name}, got {limbs}")
    return limbs


def domain_constraints(air: int) -> int:
    """The constraints an AIR emits (AIR_CONSTRAINTS)."""
    return sum(count for _, count in AIR_CONSTRAINTS[air])


def domain_powers(random_coeff, n: int) -> list:
    """rc^0 .. rc^n, each four python ints: the domain kernel's power table,
    the same at every point of a launch."""
    rc = qh.q_scalar(*_canonical(random_coeff, "random_coeff"))
    table = [qh.q_scalar(1, 0, 0, 0)]
    for _ in range(n):
        table.append(qh.q_mul(table[-1], rc))
    return [list(qh.q_to_tuple(v)) for v in table]


def domain(evaluate_fn, pre, tr, inter, perm, denom_inv, acc, first: bool, total, lookup, random_coeff,
           log_size: int) -> None:
    """Fold one AIR table's constraints over the domain into `acc` (4, N)
    in place (read unless `first`): pre / tr / inter are the table's (rows,
    N) LDE blocks, perm (N,) the previous-row point of each point, denom_inv
    (N,) M31 1/vanishing; total, lookup's (z, alpha) and random_coeff are
    QM31s of python ints."""
    air = air_id(evaluate_fn)
    n_pre, n_tr, _, _ = AIR_SHAPES[air]
    n = acc.shape[-1]
    dev = acc.device
    _check_tensor(acc, "acc", (4, n))
    for x, name, shape in ((pre, "pre", (n_pre, n)), (tr, "tr", (n_tr, n)), (inter, "inter", (4 * _batches(air), n)),
                           (perm, "perm", (n,)), (denom_inv, "denom_inv", (n,))):
        _check_tensor(x, name, shape, dev)
    consts = _canonical(total, "total") + _canonical(lookup[0], "z") + _canonical(lookup[1], "alpha")
    consts += [_inv_pow2(log_size)] + [x for v in domain_powers(random_coeff, domain_constraints(air)) for x in v]
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.composition_domain(
            air, pre.data_ptr(), tr.data_ptr(), inter.data_ptr(), perm.data_ptr(), denom_inv.data_ptr(),
            acc.data_ptr(), int(first), n, (ctypes.c_int64 * len(consts))(*consts), stream,
        )
    _raise_on(err, "composition_domain")
    if n:
        LAUNCHES["composition_domain"] += 1


# ---------------------------------------------------------------------------
# bounds: the int32 operations of csrc/composition_air.cuh and the kernels'
# bodies as the compiler is left with them, at the rate of ops/poseidon_cuda
# (132 SMs x 128 lanes x 1.98 GHz): a modular add, sub or neg 3, a widening
# multiply with its 2**31 fold 6 (as ops/poseidon_cuda counts them), a
# rotation 4.  `_Ops` runs the same field operations on limb flags (True:
# the limb may be nonzero) instead of residues: an operation with a limb
# known to be zero (an M31 mask's b, c and d limbs, q_zero) folds away at
# compile time and is not counted, so the domain kernel's M31 masks cost
# what an M31 specialisation would.
# ---------------------------------------------------------------------------

ADD, MUL, ROT = 3, 6, 4
# limb flags of an M31 value (or the constant one), a QM31 value, and zero
_M, _Q, _Z = (True, False, False, False), (True,) * 4, (False,) * 4


class _Ops:
    def __init__(self):
        self.adds = self.muls = self.rots = 0

    @property
    def int_ops(self) -> int:
        return self.adds * ADD + self.muls * MUL + self.rots * ROT

    # limbs (m31.cuh)
    def add(self, x, y):
        if x and y:
            self.adds += 1
        return x or y

    def sub(self, x, y):
        if y:
            self.adds += 1
        return x or y

    def neg(self, x):
        self.adds += x
        return x

    def mul(self, x, y):
        self.muls += x and y
        return x and y

    def inv(self, x):
        self.muls += 37 * x  # a^(p-2): 30 squarings and 7 products
        return x

    # QM31 (qm31.cuh, composition_air.cuh)
    def q_add(self, x, y):
        return tuple(self.add(u, v) for u, v in zip(x, y))

    def q_sub(self, x, y):
        return tuple(self.sub(u, v) for u, v in zip(x, y))

    def q_neg(self, x):
        return tuple(self.neg(u) for u in x)

    def q_mul_m31(self, x, s=True):
        return tuple(self.mul(u, s) for u in x)

    def _cmul(self, x0, x1, y0, y1):
        return (self.sub(self.mul(x0, y0), self.mul(x1, y1)), self.add(self.mul(x0, y1), self.mul(x1, y0)))

    # CM31 (qm31.cuh): a pair of limb flags
    def c_mul(self, x, y):
        return self._cmul(x[0], x[1], y[0], y[1])

    def c_inv(self, x):
        n = self.inv(self.add(self.mul(x[0], x[0]), self.mul(x[1], x[1])))
        return (self.mul(x[0], n), self.mul(self.neg(x[1]), n))

    def q_mul_cm31(self, x, s):
        return self.c_mul(x[:2], s) + self.c_mul(x[2:], s)

    def q_mul(self, x, y):
        a, b, c, d = x
        e, f, g, h = y
        pr, qs, ps, qr = self._cmul(a, b, e, f), self._cmul(c, d, g, h), self._cmul(a, b, g, h), self._cmul(c, d, e, f)
        t = (self.sub(self.add(qs[0], qs[0]), qs[1]), self.add(self.add(qs[1], qs[1]), qs[0]))
        return (self.add(pr[0], t[0]), self.add(pr[1], t[1]), self.add(ps[0], qr[0]), self.add(ps[1], qr[1]))

    def q_inv(self, x):
        a, b, c, d = x
        pp, qq = self._cmul(a, b, a, b), self._cmul(c, d, c, d)
        n_re = self.sub(pp[0], self.sub(self.add(qq[0], qq[0]), qq[1]))
        n_im = self.sub(pp[1], self.add(self.add(qq[1], qq[1]), qq[0]))
        ninv = self.inv(self.add(self.mul(n_re, n_re), self.mul(n_im, n_im)))
        i_re, i_im = self.mul(n_re, ninv), self.mul(self.neg(n_im), ninv)
        nc, nd = self.neg(c), self.neg(d)
        return (self.sub(self.mul(a, i_re), self.mul(b, i_im)), self.add(self.mul(a, i_im), self.mul(b, i_re)),
                self.sub(self.mul(nc, i_re), self.mul(nd, i_im)), self.add(self.mul(nc, i_im), self.mul(nd, i_re)))

    def q_double_x(self, x):
        sq = self.q_mul(x, x)
        return self.q_sub(self.q_add(sq, sq), _M)

    def q_pow5(self, x):
        x2 = self.q_mul(x, x)
        return self.q_mul(self.q_mul(x2, x2), x)

    def q_combine4(self, v0, v1, v2, v3):
        s_i = (self.neg(v1[1]), v1[0], self.neg(v1[3]), v1[2])
        s_j = (self.sub(self.add(v2[2], v2[2]), v2[3]), self.add(self.add(v2[3], v2[3]), v2[2]), v2[0], v2[1])
        v3i = (self.neg(v3[1]), v3[0], self.neg(v3[3]), v3[2])
        s_ij = (self.sub(self.add(v3i[2], v3i[2]), v3i[3]), self.add(self.add(v3i[3], v3i[3]), v3i[2]), v3i[0],
                v3i[1])
        return self.q_add(self.q_add(v0, s_i), self.q_add(s_j, s_ij))

    def mds16(self, state):
        """The external matrix on 16 values: 84 adds a limb that is nonzero
        anywhere in the state."""
        limbs = [any(v[k] for v in state) for k in range(4)]
        self.adds += 84 * sum(limbs)
        return [tuple(limbs)] * 16

    def internal16(self, state):
        limbs = [any(v[k] for v in state) for k in range(4)]
        self.adds += 33 * sum(limbs)
        self.rots += 15 * sum(limbs)
        return [tuple(limbs)] * 16


class _Component:
    """Component<Src, N, BS> of composition_air.cuh on flags: `mask` is the
    type of a preprocessed or trace mask (QM31 samples, or the prover's M31
    rows), `ext_combines` whether an interaction row is four samples
    combined (the verifier) or four limb rows (the prover), `scale` the
    1/vanishing (QM31 or M31).  Each constraint goes into a Horner fold
    (acc rc + c scale), or with `weighted` into the least form of the same
    sum: c times its power of rc, added (an M31 x QM31 multiply-add for an
    M31 constraint), then once the sum times `scale` and acc rc^n added."""

    def __init__(self, o: _Ops, acc, mask, ext_combines: bool, scale, air: int, weighted: bool = False):
        self.o, self.acc, self.mask, self.ext_combines, self.scale = o, acc, mask, ext_combines, scale
        self.n_fracs, self.batch = AIR_SHAPES[air][2:]
        self.alpha2 = None  # alpha^2, computed where a relation of three values needs it
        self.shift = o.q_mul_m31(_Q)
        self.fracs = []
        self.weighted, self.sum = weighted, _Z

    def emit(self, v):
        o = self.o
        if self.weighted:
            self.sum = o.q_add(self.sum, o.q_mul(v, _Q))
        else:
            self.acc = o.q_add(o.q_mul(self.acc, _Q), o.q_mul(v, self.scale))

    def relation(self, mult, *values):
        o = self.o
        den = o.q_add(values[0], o.q_mul(_Q, values[1]))
        if len(values) == 3:
            self.alpha2 = self.alpha2 or o.q_mul(_Q, _Q)
            den = o.q_add(den, o.q_mul(self.alpha2, values[2]))
        self.fracs.append((mult, o.q_sub(den, _Q)))

    def ext(self):
        return self.o.q_combine4(_Q, _Q, _Q, _Q) if self.ext_combines else _Q

    def finalize(self):
        o = self.o
        n_batches = -(-self.n_fracs // self.batch)
        prev = _Z
        for b in range(n_batches):
            chunk = self.fracs[b * self.batch:(b + 1) * self.batch]
            p, q = chunk[0]
            for num, den in chunk[1:]:
                p = o.q_add(o.q_mul(p, den), o.q_mul(num, q))
                q = o.q_mul(q, den)
            if b < n_batches - 1:
                cur = self.ext()
                diff = o.q_sub(cur, prev)
                prev = cur
                self.emit(o.q_sub(o.q_mul(diff, q), p))
            else:
                prev_row, cur = self.ext(), self.ext()
                fixed = o.q_add(o.q_sub(o.q_sub(cur, prev_row), prev), self.shift)
                self.emit(o.q_sub(o.q_mul(fixed, q), p))
        if self.weighted:
            return o.q_add(o.q_mul(self.acc, _Q), o.q_mul(self.sum, self.scale))
        return self.acc


def _plonk(c: _Component):
    o, m = c.o, c.mask
    for _ in range(3):
        c.emit(o.q_mul(m, m))
    a_val, b_val, c_val = (o.q_combine4(m, m, m, m) for _ in range(3))
    gate = o.q_sub(o.q_sub(c_val, o.q_mul(m, o.q_add(a_val, b_val))),
                   o.q_mul(o.q_mul(o.q_sub(_M, m), a_val), b_val))
    c.emit(gate)
    for val in (a_val, b_val, c_val):
        c.relation(m, val, m)
    c.relation(o.q_neg(m), m, a_val, b_val)


def _plonk_np(c: _Component):
    o, m = c.o, c.mask
    for _ in range(4):
        a2 = o.q_mul(m, m)
        c.emit(o.q_mul(m, o.q_sub(o.q_mul(a2, a2), m)))
    hh = [o.q_mul(m, m) for _ in range(4)]
    t0, t1 = o.q_add(hh[0], hh[1]), o.q_add(hh[2], hh[3])
    t2, t3 = o.q_add(o.q_add(hh[1], hh[1]), t1), o.q_add(o.q_add(hh[3], hh[3]), t0)
    t02, t12 = o.q_add(t0, t0), o.q_add(t1, t1)
    t4, t5 = o.q_add(o.q_add(t12, t12), t3), o.q_add(o.q_add(t02, t02), t2)
    m4 = o.q_combine4(o.q_add(t3, t5), t5, o.q_add(t2, t4), t4)
    gs = o.q_add(o.q_add(o.q_add(m, m), o.q_add(m, m)), o.q_add(o.q_add(m, m), o.q_add(m, m)))
    a_val, b_val, c_val = (o.q_combine4(m, m, m, m) for _ in range(3))
    one_m_op3, one_m_op4 = o.q_sub(_M, m), o.q_sub(_M, m)
    is_arith, is_m4 = o.q_mul(one_m_op3, one_m_op4), o.q_mul(m, one_m_op4)
    is_hadamard, is_grandsum = o.q_mul(one_m_op3, m), o.q_mul(m, m)
    expected = o.q_add(
        o.q_add(o.q_add(o.q_mul(is_arith, o.q_mul(m, o.q_add(a_val, b_val))),
                        o.q_mul(o.q_mul(o.q_sub(_M, m), a_val), b_val)),
                o.q_mul(is_m4, m4)),
        o.q_add(o.q_mul(is_hadamard, o.q_combine4(*hh)), o.q_mul(is_grandsum, o.q_combine4(gs, gs, gs, gs))))
    c.emit(o.q_sub(c_val, expected))
    for val, mult in ((a_val, _M), (b_val, _M), (c_val, m)):
        c.relation(mult, val, m)


def _poseidon(c: _Component):
    o, m = c.o, c.mask
    is_first = is_last = is_full = m
    is_not_first, is_not_last = o.q_sub(_M, is_first), o.q_sub(_M, is_last)
    is_partial = o.q_sub(is_not_first, is_full)
    nsw = o.q_sub(_M, m)
    state = o.mds16([o.q_add(o.q_mul(m, nsw), o.q_mul(m, m)) for _ in range(16)])
    for v in state:
        c.emit(o.q_mul(is_first, o.q_sub(v, m)))
    for _ in range(16):
        c.emit(o.q_mul(is_full, o.q_sub(m, o.q_pow5(o.q_add(m, m)))))
    state = o.mds16([o.q_pow5(o.q_add(v, m)) for v in o.mds16([m] * 16)])
    for v in state:
        c.emit(o.q_mul(is_full, o.q_sub(m, v)))
    state = [m] * 16
    for _ in range(14):
        c.emit(o.q_mul(is_partial, o.q_sub(m, o.q_pow5(o.q_add(state[0], m)))))
        state = o.internal16([m] + state[1:])
    for v in state:
        c.emit(o.q_mul(is_partial, o.q_sub(m, v)))
    _poseidon_logup(c, is_not_first, is_not_last)


def _poseidon_logup(c: _Component, is_not_first=None, is_not_last=None):
    """The poseidon AIR's relations (composition_air.cuh `poseidon_logup`);
    1 - is_first and 1 - is_last computed here unless the rounds have (the
    compiler computes each once)."""
    o, m = c.o, c.mask
    is_first = is_last = m
    if is_not_first is None:
        is_not_first, is_not_last = o.q_sub(_M, is_first), o.q_sub(_M, is_last)
    in_left = o.q_add(m, m)
    in_right = o.q_add(in_left, _M)
    out_left = o.q_add(in_right, _M)
    out_right = o.q_add(out_left, _M)
    for sel, not_sel, ids, sign in ((is_first, is_not_first, in_left, o.q_sub),
                                    (is_first, is_not_first, in_right, o.q_sub),
                                    (is_last, is_not_last, out_left, o.q_add),
                                    (is_last, is_not_last, out_right, o.q_add)):
        mult = sign(o.q_mul(m, sel), not_sel)
        rid = o.q_add(o.q_mul(sel, m), o.q_mul(not_sel, ids))
        c.relation(mult, rid, o.q_combine4(m, m, m, m), o.q_combine4(m, m, m, m))
    c.relation(o.q_mul(is_first, is_not_last), m, m)


_AIR_BODIES = {PLONK: _plonk, POSEIDON: _poseidon, PLONK_NP: _plonk_np}


def _component_ops(o: _Ops, air: int, acc, mask, ext_combines: bool, scale, weighted: bool = False):
    c = _Component(o, acc, mask, ext_combines, scale, air, weighted)
    _AIR_BODIES[air](c)
    return c.finalize()


@lru_cache(maxsize=None)
def check_ops(spec) -> int:
    """int32 operations of one proof's check: the doubling chain, an
    inverse and an AIR a component, and the compare."""
    o = _Ops()
    x = _Q
    for _ in range(spec.composition_log_degree_bound - 2):
        x = o.q_double_x(x)
    acc = _Z
    for air, _ in FLAVOUR_AIRS[flavour_of(spec)]:
        acc = _component_ops(o, air, acc, _Q, True, o.q_inv(_Q))
    o.q_add(o.q_combine4(_Q, _Q, _Q, _Q), o.q_mul(o.q_combine4(_Q, _Q, _Q, _Q), x))
    return o.int_ops


@lru_cache(maxsize=None)
def domain_ops(air: int, first: bool) -> int:
    """int32 operations of one point of the domain kernel: an AIR on M31
    masks and four-limb interaction rows, its constraints combined at the
    least form the inputs need (each times its power of rc and added: an
    M31 x QM31 multiply-add for an M31-valued constraint, a QM31 product
    and add for a logup one; once a point the M31 1/vanishing and, unless
    `first`, acc rc^n)."""
    o = _Ops()
    _component_ops(o, air, _Z if first else _Q, _M, False, _M, weighted=True)
    return o.int_ops


def check_bound_ms(spec, batch: int) -> tuple:
    """(milliseconds, "operations" or "bytes") for one check launch: the
    int32 operations against the int64 samples and parameters read once and
    the bool and four limbs written once."""
    n_params = len(_log_sizes(spec)) + 4
    ops = batch * check_ops(spec) / H100_INT_OPS_PER_S
    mem = batch * ((spec.total_samples + n_params) * 4 * 8 + 1 + 4 * 8) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")


def domain_bound_ms(evaluate_fn, n: int, first: bool) -> tuple:
    """(milliseconds, "operations" or "bytes") for one domain launch over n
    points: the AIR's int32 operations against its int64 rows, perm,
    denom_inv and the accumulator (unless `first`) read once and the
    accumulator written once."""
    air = air_id(evaluate_fn)
    n_pre, n_tr, _, _ = AIR_SHAPES[air]
    ops = n * domain_ops(air, first) / H100_INT_OPS_PER_S
    words = n_pre + n_tr + 4 * _batches(air) + 2 + (0 if first else 4) + 4
    mem = n * words * 8 / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")


# ---------------------------------------------------------------------------
# latency floor of the check kernel: a proof's longest dependent chain, read
# off csrc/composition.cu `check_warp` in steps of each kind (`lat`:
# ops/latency_cuda.step_latencies, cycles a step of m31.cuh's add and mul, a
# shuffle, a rotation, and "ghz").  A q_mul is a product and 4 adds deep, a
# q_double_x a q_mul and 2 adds, a q_inv 41 products and 6 adds (the 37 of
# inv among them).  Two chains meet at the end: the serial part (the
# doublings to each vanishing value and its inverse), and the poseidon
# lanes' (the partial rounds' linear chain, 14 rounds of a 4-level shuffle
# sum and an add, then an S-box or the output's difference, the selector
# and the weight); then the product by 1/vanishing, the 5-level shuffle
# reduction and lane 0's compare against left + right x^(2^(bound-2)).
# ---------------------------------------------------------------------------


def check_cycles(spec, lat: dict) -> float:
    """Cycles of one proof's longest chain in the check kernel."""
    a, m, s = lat["add"], lat["mul"], lat["shfl"]
    q_mul, q_double = m + 4 * a, m + 6 * a
    bound = spec.composition_log_degree_bound
    logs = _log_sizes(spec)
    serial = max((L - 1) * q_double + 41 * m + 6 * a for L in logs)
    if flavour_of(spec) == WITH_POSEIDON:
        round_ = 4 * (s + a) + a
        sbox = 13 * round_ + a + 3 * q_mul + a + 2 * q_mul + a
        out = 14 * round_ + a + 2 * q_mul + a
        lanes = max(sbox, out)
    else:
        lanes = 0  # the without-Poseidon AIR runs on every lane, off the serial chain's length
    reduced = max(serial, lanes) + q_mul + a + 5 * (s + a)
    return max(reduced, (bound - 2) * q_double + q_mul + a) + 4 * a


def latency_floor_ms(spec, lat: dict) -> float:
    """The check kernel's latency floor: check_cycles at lat["ghz"]."""
    return check_cycles(spec, lat) / (lat["ghz"] * 1e6)
