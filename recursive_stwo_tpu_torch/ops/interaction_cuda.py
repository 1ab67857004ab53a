"""ctypes wrapper of the provers' interaction kernel (csrc/interaction.cu).

  interaction_rows(air, pre, tr, lookup) -> (4 k, N) int64
      one AIR table's logup batches over its N base-trace rows, one thread a
      row: rows 0 .. 4 k - 5 the running sums of the batches before the last
      (the interaction columns as they stand), the last four S, the sum of
      all k batches.  The twin of the generation mode of
      recursive_stwo_tpu/prover/device_prove.py `_InteractionEval`
      (:277-331) in `_interaction_traced` (:342-352) up to its last column;
      prover/interaction.py turns S into that column (its total, shift and
      prefix sum).

It takes CUDA int64 tensors of canonical residues and raises on anything
else; the plain version is prover/interaction.py `interaction_rows_plain`.
A call launches the kernel once on the current stream of its tensors'
device, without synchronising.  `LAUNCHES` counts the launches.  `air` is
ops/composition_cuda.py's id (`air_id` maps an evaluator of
verifier/composition.py to it).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import build
from .composition_cuda import (AIR_SHAPES, PLONK, PLONK_NP, POSEIDON, _batches, _canonical, _Component, _M, _Ops,
                               _poseidon_logup)
from .poseidon_cuda import H100_BYTES_PER_S, H100_INT_OPS_PER_S, _raise_on

LAUNCHES = {"interaction": 0}
# the preprocessed and trace rows each AIR's relations read (csrc/
# composition_air.cuh; the constraints' other rows are not read in
# generation mode): plonk's wires, multiplicities and poseidon wire, the
# poseidon AIR's selectors, round id, external ids and nonzero flags, rc0[0],
# its in and out states and swap bit, the without-Poseidon AIR's wires and
# mult_c; every AIR's a, b, c values (trace rows 0-11)
READS = {
    PLONK: ((0, 1, 2, 4, 5, 6, 7, 8), tuple(range(12))),
    POSEIDON: ((0, 1, 3, 4, 36, 37, 38, 39), tuple(range(17)) + tuple(range(32, 48))),
    PLONK_NP: ((0, 1, 2, 7), tuple(range(12))),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def interaction_rows(air: int, pre: torch.Tensor, tr: torch.Tensor, lookup) -> torch.Tensor:
    """The (4 k, N) batch rows of one table on the card (see the module
    docstring): pre and tr its (rows, N) row-order columns, each of unit
    stride along a row; lookup (z, alpha), QM31s of python ints."""
    if air not in AIR_SHAPES:
        raise ValueError(f"no interaction kernel for AIR {air}")
    n_pre, n_tr, _, _ = AIR_SHAPES[air]
    n = pre.shape[-1]
    dev = pre.device
    for x, name, rows in ((pre, "pre", n_pre), (tr, "tr", n_tr)):
        if x.device != dev or x.dtype != torch.int64 or x.dim() != 2 or tuple(x.shape) != (rows, n):
            raise ValueError(f"expected {name} as ({rows}, {n}) int64 on {dev}, got {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}")
        if n > 1 and x.stride(1) != 1:
            raise ValueError(f"expected {name} contiguous along a row")
    if dev.type != "cuda":
        raise ValueError(f"expected the table on a CUDA device, got {dev}")
    out = torch.empty((4 * _batches(air), n), dtype=torch.int64, device=dev)
    zalpha = _canonical(lookup[0], "z") + _canonical(lookup[1], "alpha")
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.interaction_columns(air, pre.data_ptr(), pre.stride(0), tr.data_ptr(), tr.stride(0),
                                      out.data_ptr(), out.stride(0), n, (ctypes.c_int64 * 8)(*zalpha), stream)
    _raise_on(err, "interaction_columns")
    if n:
        LAUNCHES["interaction"] += 1
    return out


# ---------------------------------------------------------------------------
# bound: the int32 operations of a row, counted as ops/composition_cuda
# counts them (a modular add 3, a multiply 6, an inverse's 37 products) on
# M31 masks: the relations' denominators, each batch's fraction folded, its
# inverse and product, the running sum; against the bytes of the rows the
# relations read (READS) and the batch rows written, each once.
# ---------------------------------------------------------------------------


class _Generate(_Component):
    """composition_cuda._Component in generation mode: no constraint, each
    batch's fraction p q^-1 added to a running sum."""

    def finalize(self):
        o, acc = self.o, None
        for b in range(-(-self.n_fracs // self.batch)):
            chunk = self.fracs[b * self.batch:(b + 1) * self.batch]
            p, q = chunk[0]
            for num, den in chunk[1:]:
                p = o.q_add(o.q_mul(p, den), o.q_mul(num, q))
                q = o.q_mul(q, den)
            f = o.q_mul(p, o.q_inv(q))
            acc = f if acc is None else o.q_add(acc, f)
        return acc


def _relations(c: _Generate, air: int) -> None:
    """The relations of composition_cuda's AIR bodies alone, on M31 masks:
    generation mode computes no constraint."""
    o, m = c.o, c.mask
    if air == POSEIDON:
        _poseidon_logup(c)
        return
    a_val, b_val, c_val = (o.q_combine4(m, m, m, m) for _ in range(3))
    if air == PLONK:
        for val in (a_val, b_val, c_val):
            c.relation(m, val, m)
        c.relation(o.q_neg(m), m, a_val, b_val)
    else:
        for val, mult in ((a_val, _M), (b_val, _M), (c_val, m)):
            c.relation(mult, val, m)


@lru_cache(maxsize=None)
def row_ops(air: int) -> int:
    """int32 operations of one row: the relations' denominators, each
    batch's fraction, its inverse and product, and the running sum."""
    c = _Generate(_Ops(), None, _M, False, _M, air)
    c.o = o = _Ops()  # the constructor's cumsum shift is not computed in generation mode
    _relations(c, air)
    c.finalize()
    return o.int_ops


def row_bytes(air: int) -> int:
    """Bytes of one row: the rows its relations read and the batch rows
    written, int64 each."""
    pre, tr = READS[air]
    return 8 * (len(pre) + len(tr) + 4 * _batches(air))


def bound_ms(air: int, n: int) -> tuple:
    """(milliseconds, "operations" or "bytes") for one launch over n rows."""
    ops = n * row_ops(air) / H100_INT_OPS_PER_S
    mem = n * row_bytes(air) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")

