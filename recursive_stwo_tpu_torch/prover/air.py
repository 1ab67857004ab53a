"""AIR trace generation: committed columns for the PlonkWithPoseidon AIRs.

Layouts are pinned by the in-circuit composition gadget
(recursion/composition.py, fixture-validated against stwo proofs):

* plonk: 10 preprocessed + 12 trace + 8 interaction columns.
* poseidon: 6 rows per accelerator invocation —
  row 0: swap + external matrix ("first round"),
  rows 1-2: full rounds 1..4 (two per row),
  row 3: all 14 partial rounds,
  rows 4-5: full rounds 5..8; padding rows set is_first = is_last = 1
  (all logup multiplicities vanish, the zero state satisfies the
  first-round constraint).  State chaining across rows rides the logup
  argument via round_id = 6*invocation + row.

Row i of a table lives at CanonicCoset coset index i; committed
evaluations are that column permuted into bit-reversed circle-domain
order (`coset_to_domain_perm`).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np

from ..core import circle_host as ccircle
from ..core import m31_host as m31, poseidon2_host as poseidon2
from ..core import qm31_host as q
from .eval_vars import ArrayEvalAtRow, EvalArray

ROWS_PER_INV = 6


@lru_cache(maxsize=None)
def coset_to_domain_perm(log_size: int) -> np.ndarray:
    """perm[j] = coset index whose point sits at bit-reversed circle-domain
    position j (committed_evals = row_values[perm])."""
    coset = ccircle.Coset.odds(log_size)
    dom = ccircle.CanonicCoset(log_size).circle_domain()
    n = 1 << log_size
    by_index = {coset.index_at(i): i for i in range(n)}
    perm = np.empty(n, np.int64)
    for j in range(n):
        pos = ccircle.bit_reverse_index(j, log_size)
        perm[j] = by_index[dom.index_at(pos)]
    return perm


def to_domain_order(rows: np.ndarray) -> np.ndarray:
    """(..., N) row-order columns -> bit-reversed domain evaluations."""
    n = rows.shape[-1]
    perm = coset_to_domain_perm(n.bit_length() - 1)
    return rows[..., perm]


def from_domain_order(evals: np.ndarray) -> np.ndarray:
    n = evals.shape[-1]
    perm = coset_to_domain_perm(n.bit_length() - 1)
    out = np.empty_like(evals)
    out[..., perm] = evals
    return out


# ---------------------------------------------------------------------------
# Plonk columns (row order)
# ---------------------------------------------------------------------------

PLONK_PRE_ORDER = (
    "a_wire", "b_wire", "c_wire", "op", "mult_a", "mult_b", "mult_c",
    "poseidon_wire", "mult_poseidon", "enforce_c_m31",
)
PLONK_TRACE_ORDER = tuple(
    f"{t}_val_{k}" for t in ("a", "b", "c") for k in range(4)
)


def plonk_columns(trace: dict) -> Tuple[np.ndarray, np.ndarray]:
    pre = np.stack([trace[name] for name in PLONK_PRE_ORDER])
    tr = np.stack([trace[name] for name in PLONK_TRACE_ORDER])
    return pre.astype(np.uint32), tr.astype(np.uint32)


NP_PRE_ORDER = (
    "a_wire", "b_wire", "c_wire", "op1", "op2", "op3", "op4", "mult_c",
)


def np_columns(trace: dict) -> Tuple[np.ndarray, np.ndarray]:
    """PlonkWithoutPoseidon columns: 8 preprocessed + 12 value limbs
    (read order fixed by recursion.composition.evaluate_plonk_np)."""
    pre = np.stack([trace[name] for name in NP_PRE_ORDER])
    tr = np.stack([trace[name] for name in PLONK_TRACE_ORDER])
    return pre.astype(np.uint32), tr.astype(np.uint32)


# ---------------------------------------------------------------------------
# Poseidon columns (row order)
# ---------------------------------------------------------------------------

def poseidon_columns(trace: dict) -> Tuple[np.ndarray, np.ndarray, int]:
    """(preprocessed (40, R), trace (48, R), log_rows) from the flow."""
    wires = np.asarray(trace["flow_wires"], np.uint32)  # (I, 4)
    hashes = np.asarray(trace["flow_hashes"], np.uint32)  # (I, 4, 8)
    swap_addr = np.asarray(trace["flow_swap_addr"], np.uint32)
    swap_bit = np.asarray(trace["flow_swap_bit"], np.uint32)
    I = wires.shape[0]
    R = 1 << max(4, (ROWS_PER_INV * I - 1).bit_length())

    pre = np.zeros((40, R), np.uint32)
    tr = np.zeros((48, R), np.uint32)

    (IS_FIRST, IS_LAST, IS_FULL, ROUND_ID) = (0, 1, 2, 3)
    RC0, RC1 = 4, 20
    EXT1, EXT2, EXT1_NZ, EXT2_NZ = 36, 37, 38, 39

    r = np.arange(I)
    rows = lambda k: ROWS_PER_INV * r + k  # noqa: E731

    # selectors / ids
    pre[IS_FIRST, rows(0)] = 1
    pre[IS_LAST, rows(5)] = 1
    for k in (1, 2, 4, 5):
        pre[IS_FULL, rows(k)] = 1
    for k in range(ROWS_PER_INV):
        pre[ROUND_ID, rows(k)] = (ROWS_PER_INV * r + k).astype(np.uint32)
    # padding rows: first & last (degenerate)
    pad = np.arange(ROWS_PER_INV * I, R)
    pre[IS_FIRST, pad] = 1
    pre[IS_LAST, pad] = 1

    # round constants
    frc = poseidon2.FIRST_FOUR_ROUND_RC
    lrc = poseidon2.LAST_FOUR_ROUNDS_RC
    prc = poseidon2.PARTIAL_ROUNDS_RC
    for i in range(16):
        pre[RC0 + i, rows(1)] = frc[0][i]
        pre[RC1 + i, rows(1)] = frc[1][i]
        pre[RC0 + i, rows(2)] = frc[2][i]
        pre[RC1 + i, rows(2)] = frc[3][i]
        pre[RC0 + i, rows(4)] = lrc[0][i]
        pre[RC1 + i, rows(4)] = lrc[1][i]
        pre[RC0 + i, rows(5)] = lrc[2][i]
        pre[RC1 + i, rows(5)] = lrc[3][i]
    for rr in range(14):
        pre[RC0 + rr, rows(3)] = prc[rr]
    # row 0: rc0[0] doubles as the swap-bit wire address
    pre[RC0 + 0, rows(0)] = swap_addr

    # external wire ids
    pre[EXT1, rows(0)] = wires[:, 0]
    pre[EXT2, rows(0)] = wires[:, 1]
    pre[EXT1, rows(5)] = wires[:, 2]
    pre[EXT2, rows(5)] = wires[:, 3]
    pre[EXT1_NZ, rows(0)] = (wires[:, 0] != 0).astype(np.uint32)
    pre[EXT2_NZ, rows(0)] = (wires[:, 1] != 0).astype(np.uint32)
    pre[EXT1_NZ, rows(5)] = (wires[:, 2] != 0).astype(np.uint32)
    pre[EXT2_NZ, rows(5)] = (wires[:, 3] != 0).astype(np.uint32)

    # --- state evolution (vectorized over invocations) ---
    def pow5(x):
        x2 = m31.mul(x, x)
        return m31.mul(m31.mul(x2, x2), x)

    in0 = np.concatenate([hashes[:, 0], hashes[:, 1]], axis=1)  # (I, 16)
    swapped = np.where(
        swap_bit[:, None].astype(bool),
        np.concatenate([hashes[:, 1], hashes[:, 0]], axis=1),
        in0,
    )
    out0 = poseidon2.mds16(swapped)

    def set_row(k, in_s, inter, out_s):
        tr[0:16, rows(k)] = in_s.T
        tr[16:32, rows(k)] = inter.T
        tr[32:48, rows(k)] = out_s.T

    inter0 = np.zeros((I, 16), np.uint32)
    inter0[:, 0] = swap_bit
    set_row(0, in0, inter0, out0)

    state = out0
    for k, (rc_a, rc_b) in (
        (1, (frc[0], frc[1])),
        (2, (frc[2], frc[3])),
    ):
        inter = pow5(m31.add(state, rc_a))
        out = poseidon2.mds16(
            pow5(m31.add(poseidon2.mds16(inter), rc_b))
        )
        set_row(k, state, inter, out)
        state = out

    # partial row
    in3 = state
    inter3 = np.zeros((I, 16), np.uint32)
    s = state.copy()
    diag = poseidon2.MAT_DIAG16_M_1
    for rr in range(14):
        s0 = pow5(m31.add(s[:, 0], prc[rr]))
        inter3[:, rr] = s0
        s = np.concatenate([s0[:, None], s[:, 1:]], axis=1)
        total = s[:, 0]
        for i in range(1, 16):
            total = m31.add(total, s[:, i])
        s = m31.add(total[:, None], m31.mul(s, diag))
    set_row(3, in3, inter3, s)
    state = s

    for k, (rc_a, rc_b) in (
        (4, (lrc[0], lrc[1])),
        (5, (lrc[2], lrc[3])),
    ):
        inter = pow5(m31.add(state, rc_a))
        out = poseidon2.mds16(
            pow5(m31.add(poseidon2.mds16(inter), rc_b))
        )
        set_row(k, state, inter, out)
        state = out

    expected = np.concatenate([hashes[:, 2], hashes[:, 3]], axis=1)
    assert np.array_equal(state, expected), "poseidon trace replay mismatch"

    return pre, tr, R.bit_length() - 1


# ---------------------------------------------------------------------------
# Interaction (logup) trace generation — reuses the AIR definitions
# ---------------------------------------------------------------------------

def _modsum(limb):
    """Modular sum of a 1-D M31 limb array -> scalar (numpy or traced)."""
    return np.uint32(np.sum(np.asarray(limb, np.int64)) % ((1 << 31) - 1))


def _modcumsum(limb):
    """Inclusive modular prefix sum of a 1-D M31 limb array."""
    return (np.cumsum(np.asarray(limb, np.int64)) % ((1 << 31) - 1)).astype(
        np.uint32
    )


class InteractionBuilder(ArrayEvalAtRow):
    """Runs evaluate_plonk/evaluate_poseidon in 'generation mode': collects
    the relation fractions and synthesizes the interaction columns instead
    of reading them back as masks."""

    def __init__(self, mask_pre, mask_trace, lookup, n: int):
        self.col_index = [0, 0, 0, 0]
        self.mask = [mask_pre, mask_trace, None]
        self.n = n
        self.fracs = []
        self.columns: List[np.ndarray] = []  # 8 limb columns (row order)
        self.total_sum = None
        self.denom_inverse = self.one()  # constraints unused in generation
        self.accumulator = _NullAccumulator()
        self.cumsum_shift = None

    def finalize_logup(self, batch_size: int) -> None:
        batched = []
        for k in range(0, len(self.fracs), batch_size):
            chunk = self.fracs[k : k + batch_size]
            p_, q_ = chunk[0]
            for mlt, d in chunk[1:]:
                p_ = (p_ * d) + (mlt * q_)
                q_ = q_ * d
            batched.append((p_, q_))
        fracs = [num * denom.inv() for num, denom in batched]

        cols: List[EvalArray] = []
        acc = self.zero()
        for f in fracs[:-1]:
            acc = acc + f
            cols.append(acc)
        prev_col = acc
        S = prev_col + fracs[-1]
        total = q.QM31(*(_modsum(limb) for limb in S.v))
        self.total_sum = total
        from ..cs import scalar

        shift = q.q_mul_m31(total, np.uint32(scalar.m_inv(self.n)))
        adj = q.q_sub(S.v, shift)
        last = q.QM31(*(_modcumsum(limb) for limb in adj))
        cols.append(EvalArray(last))

        for col in cols:
            for limb in col.v:
                self.columns.append(np.asarray(limb, np.uint32))
        self.fracs = []


class _NullAccumulator:
    def accumulate(self, _):
        pass


def interaction_columns(pre, trace_cols, z4, alpha4, evaluate_fn):
    """(8, N) interaction limb columns (row order) + total_sum 4-tuple."""
    from .eval_vars import LookupElementsArray

    n = pre.shape[1]
    lookup = LookupElementsArray(z4, alpha4, n)
    mask_pre = [[EvalArray.from_limbs(c)] for c in pre]
    mask_tr = [[EvalArray.from_limbs(c)] for c in trace_cols]
    ev = InteractionBuilder(mask_pre, mask_tr, lookup, n)
    evaluate_fn(lookup, ev)
    return np.stack(ev.columns), ev.total_sum
