"""Whether a proof is the proof of its trace: the reference verifier
(verifier/stark.py), under the configuration's own PcsConfig, accepts its
bytes, and the trace columns it commits to are the trace's own at the
out-of-domain point.

The second part ties the proof to its witness, in both tables: the
reference builds the plonk table's twelve value columns and some of the
poseidon table's trace columns from the trace it was given, interpolates
them and evaluates them at the OODS point its own transcript draws; a proof
of another trace, or a stale one, samples other values there.
"""

from __future__ import annotations

import numpy as np

from . import config as config_mod
from .core import circle_host as circle
from .core import poseidon2_host as poseidon2
from .core import qm31_host as q
from .proof.parse import parse_plonk_with_poseidon_proof
from .prover.circle_fft_host import interpolate
from .verifier import stark
from .verifier.spec import N_TRACE_PLONK

PLONK_VALUE_COLUMNS = tuple(f"{t}_val_{k}" for t in ("a", "b", "c") for k in range(4))
# the poseidon table's trace columns held to the trace: a row's input state,
# intermediate and output, word 0 of each, and the output's last word
POSEIDON_COLUMNS = (0, 16, 32, 47)
ROWS_PER_PERMUTATION = 6
P = np.uint64((1 << 31) - 1)


def domain_order(rows: np.ndarray) -> np.ndarray:
    """Row-order columns (row i at the canonic coset's i-th point) -> the
    circle domain's bit-reversed order."""
    log = rows.shape[-1].bit_length() - 1
    coset = circle.Coset.odds(log)
    dom = circle.CanonicCoset(log).circle_domain()
    by_index = {coset.index_at(i): i for i in range(1 << log)}
    perm = np.array([by_index[dom.index_at(circle.bit_reverse_index(j, log))] for j in range(1 << log)])
    return rows[..., perm]


def eval_at(coeffs: np.ndarray, px: q.QM31, py: q.QM31) -> np.ndarray:
    """(n_cols, 4) values at (px, py) of M31-coefficient circle polynomials
    (n_cols, 2**log) in the stwo basis: bit k of a coefficient's index
    multiplies by y, x, pi(x), pi(pi(x)), ... in turn."""
    factors, x = [py, px], px
    log = coeffs.shape[-1].bit_length() - 1
    while len(factors) < log:
        sq = q.q_mul(x, x)
        x = q.q_sub(q.q_add(sq, sq), q.q_one(x.a))
        factors.append(x)
    c = coeffs.astype(np.uint32)
    v = q.q_from_m31(c, np.zeros_like(c), np.zeros_like(c), np.zeros_like(c))
    for f in factors[:log]:
        even = q.QM31(*(a[..., 0::2] for a in v))
        odd = q.QM31(*(a[..., 1::2] for a in v))
        fb = q.QM31(*(np.broadcast_to(np.asarray(a, np.uint32), odd.a.shape) for a in f))
        v = q.q_add(even, q.q_mul(odd, fb))
    return np.stack([np.asarray(a, np.uint32)[..., 0] for a in v], axis=-1)


def poseidon_trace(trace: dict, log_rows: int) -> np.ndarray:
    """The poseidon table's 48 trace columns (2**log_rows rows) from the
    trace's permutation flow: six rows a permutation (the initial matrix,
    two rows of two full rounds, the fourteen partial rounds, two rows of
    two full rounds), each row its input state, its intermediate values
    (the S-box outputs; row 0 the swap bit) and its output; padding rows 0."""
    hashes = np.asarray(trace["flow_hashes"], np.uint64)  # (I, 4, 8): left, right in; left, right out
    swap = np.asarray(trace["flow_swap_bit"], np.uint64)
    n = hashes.shape[0]
    if ROWS_PER_PERMUTATION * n > 1 << log_rows:
        raise ValueError(f"{n} permutations do not fit 2**{log_rows} rows")
    cols = np.zeros((48, 1 << log_rows), np.uint64)

    def put(row, state_in, inter, state_out):
        at = ROWS_PER_PERMUTATION * np.arange(n) + row
        cols[0:16, at], cols[16:32, at], cols[32:48, at] = state_in.T, inter.T, state_out.T

    state_in = np.concatenate([hashes[:, 0], hashes[:, 1]], axis=1)
    swapped = np.where(swap[:, None] != 0, np.concatenate([hashes[:, 1], hashes[:, 0]], axis=1), state_in)
    inter = np.zeros_like(state_in)
    inter[:, 0] = swap
    state = poseidon2.mds16(swapped)
    put(0, state_in, inter, state)

    def full(row, state, a, b):
        inter = poseidon2.pow5((state + a) % P)
        out = poseidon2.mds16(poseidon2.pow5((poseidon2.mds16(inter) + b) % P))
        put(row, state, inter, out)
        return out

    def partial(row, state):
        s, inter = state.copy(), np.zeros_like(state)
        for r, c in enumerate(poseidon2.PARTIAL_ROUNDS_RC.astype(np.uint64)):
            inter[:, r] = poseidon2.pow5((s[:, 0] + c) % P)
            s = np.concatenate([inter[:, r:r + 1], s[:, 1:]], axis=1)
            s = (s.sum(axis=1, keepdims=True) + s * poseidon2.MAT_DIAG16_M_1.astype(np.uint64)) % P
        put(row, state, inter, s)
        return s

    first = poseidon2.FIRST_FOUR_ROUND_RC.astype(np.uint64)
    last = poseidon2.LAST_FOUR_ROUNDS_RC.astype(np.uint64)
    state = full(2, full(1, state, first[0], first[1]), first[2], first[3])
    state = full(5, full(4, partial(3, state), last[0], last[1]), last[2], last[3])
    if not np.array_equal(state, np.concatenate([hashes[:, 2], hashes[:, 3]], axis=1)):
        raise ValueError("the trace's permutation flow does not hash to its outputs")
    return cols.astype(np.uint32)


def check(proof_bytes: bytes, config: dict, trace: dict) -> dict:
    """{'failed_checks': named checks the proof fails (all of them where it
    cannot be parsed, claims another PcsConfig or has another shape),
    'trace_samples_off': trace columns whose OODS sample is not the
    trace's}."""
    spec = config_mod.spec(config)
    names = [n for n in stark.check_names(spec) if n != "ok"]
    n_tied = len(PLONK_VALUE_COLUMNS) + len(POSEIDON_COLUMNS)
    try:
        proof = parse_plonk_with_poseidon_proof(proof_bytes)
        if proof.config != config_mod.pcs_config(config):
            raise ValueError(f"the proof claims {proof.config}, the configuration states another")
        if (proof.log_size_plonk, proof.log_size_poseidon) != (spec.log_size_plonk, spec.log_size_poseidon):
            raise ValueError("the proof's log sizes are not the configuration's")
        checks, fs = stark.verify_proof(spec, proof, config_mod.public_inputs(config))
    except (AssertionError, ValueError, IndexError, KeyError) as exc:
        return {"failed_checks": len(names), "trace_samples_off": n_tied, "error": repr(exc)}
    failed = sum(not checks[n] for n in names)

    px, py = (q.QM31(*(np.array([c], np.uint32) for c in v)) for v in fs.oods)
    plonk = np.stack([np.asarray(trace[name], np.uint32) for name in PLONK_VALUE_COLUMNS])
    pos = poseidon_trace(trace, spec.log_size_poseidon)[list(POSEIDON_COLUMNS)]
    want = np.concatenate([eval_at(interpolate(domain_order(cols)), px, py) for cols in (plonk, pos)])
    trace_samples = proof.stark_proof.sampled_values[1]
    got = np.stack([np.asarray(trace_samples[c][0], np.uint32) for c in range(len(PLONK_VALUE_COLUMNS))]
                   + [np.asarray(trace_samples[N_TRACE_PLONK + c][0], np.uint32) for c in POSEIDON_COLUMNS])
    return {"failed_checks": failed, "trace_samples_off": int((want != got).any(axis=1).sum())}
