"""Host copy of recursive_stwo_tpu/verifier/transcript.py (numpy only; its jax branches are
removed).  The torch twin is transcript.py beside it.

Fiat-Shamir transcript replay as one scan + one batched draw kernel.

TPU-first design: every value mixed into the Poseidon31 channel is proof
data (draws never modify the digest), so the digest chain is a `lax.scan`
of length T over a statically-assembled (B, T, 8) operand tensor, and ALL
draws are then computed in a single batched Poseidon2 call against the
gathered digest states.  The sequential critical path is exactly T
permutations regardless of batch size; everything else is data-parallel.

Channel semantics (digest = capacity half, rate = first 8 lanes) mirror
/root/reference/primitives/channel/src/lib.rs:23-59; op order mirrors
/root/reference/components/recursive/fiat_shamir/src/lib.rs:44-131 and
hints/fiat_shamir.rs:74-256.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from ..core import m31_host as m31, poseidon2_host as poseidon2
from ..core.qm31_host import QM31
from .spec import VerifierSpec


def _xp(arr):
    return np


class FSOutput(NamedTuple):
    z: QM31
    alpha: QM31
    random_coeff: QM31
    oods_t: QM31
    after_sampled_values_random_coeff: QM31
    fri_alphas: tuple  # (n_inner+1) QM31s
    raw_queries: object  # (B, n_queries) uint32
    pow_digest0: object  # (B,) uint32, limb 0 of post-nonce digest


def n_sample_rows(spec: VerifierSpec) -> int:
    return (spec.total_samples + 1) // 2


def n_last_poly_rows(spec: VerifierSpec) -> int:
    return ((1 << spec.log_last_layer_degree_bound) + 1) // 2


def n_rows(spec: VerifierSpec) -> int:
    return 9 + n_sample_rows(spec) + spec.n_inner_layers + n_last_poly_rows(spec)


def build_operands(spec: VerifierSpec, pa) -> object:
    """Assemble the (B, T, 8) mix-operand tensor from proof arrays."""
    xp = _xp(pa.commitments)
    B = pa.commitments.shape[0]
    zeros = xp.zeros

    def const_row(vals):
        row = np.zeros((1, 1, 8), np.uint32)
        for i, v in enumerate(vals):
            row[0, 0, i] = v
        return xp.broadcast_to(xp.asarray(row), (B, 1, 8))

    def pad_pairs(flat):  # (B, S, 4) -> (B, ceil(S/2), 8)
        S = flat.shape[1]
        if S % 2:
            flat = xp.concatenate([flat, zeros((B, 1, 4), xp.uint32)], axis=1)
        return flat.reshape(B, (S + 1) // 2, 8)

    rows = [
        pa.commitments[:, 0:1],
        const_row([spec.log_size_plonk]),
        const_row([spec.log_size_poseidon]),
        pa.commitments[:, 1:2],
        xp.concatenate([pa.plonk_total_sum, pa.poseidon_total_sum], axis=-1)[:, None],
        pa.commitments[:, 2:3],
        pa.commitments[:, 3:4],
        pad_pairs(pa.samples_flat),
        pa.first_layer_commitment[:, None],
        pa.inner_commitments,
        pad_pairs(pa.last_poly),
        xp.concatenate([pa.nonce_limbs, zeros((B, 5), xp.uint32)], axis=-1)[:, None],
    ]
    ops = xp.concatenate(rows, axis=1)
    assert ops.shape[1] == n_rows(spec), (ops.shape, n_rows(spec))
    return ops


def digest_chain(operands):
    """Sequential digest evolution; returns (T, B, 8) post-mix digests."""
    xp = _xp(operands)
    B, T, _ = operands.shape
    ops_t = xp.swapaxes(operands, 0, 1)  # (T, B, 8)

    digest = np.zeros((B, 8), np.uint32)
    out = np.empty((T, B, 8), np.uint32)
    for t in range(T):
        state = np.concatenate([ops_t[t], digest], axis=-1)
        digest = poseidon2.permute(state)[..., 8:]
        out[t] = digest
    return out


def _draw_schedule(spec: VerifierSpec) -> List[tuple]:
    """(row_index, n_sent) pairs; digest state is AFTER processing the row."""
    ns = n_sample_rows(spec)
    T = n_rows(spec)
    sched = [(3, 0), (5, 0), (6, 0), (6 + ns, 0), (7 + ns, 0)]
    for i in range(spec.n_inner_layers):
        sched.append((8 + ns + i, 0))
    # The native channel pulls 8 raw u32s per draw and truncates to
    # n_queries (hints/fiat_shamir.rs:229-255), so ceil(n_queries/8) draws
    # with n_sent = 0,1,... supply every consumed value.
    n_query_draws = (spec.n_queries + 7) // 8
    for k in range(n_query_draws):
        sched.append((T - 1, k))
    return sched


def run_transcript(spec: VerifierSpec, pa) -> FSOutput:
    operands = build_operands(spec, pa)
    xp = _xp(operands)
    B = operands.shape[0]
    digests = digest_chain(operands)  # (T, B, 8)

    sched = _draw_schedule(spec)
    rows = np.array([r for r, _ in sched], np.int32)
    nsent = np.array([[n] for _, n in sched], np.uint32)

    sel = digests[xp.asarray(rows)]  # (D, B, 8)
    D = len(sched)
    left = xp.zeros((D, B, 8), xp.uint32)
    left[:, :, 0] = nsent
    state = xp.concatenate([left, sel], axis=-1)  # (D, B, 16)
    rate = poseidon2.permute(state)[..., :8]  # (D, B, 8)

    def felt(d, half):
        s = rate[d, :, 4 * half : 4 * half + 4]
        return QM31(s[:, 0], s[:, 1], s[:, 2], s[:, 3])

    n_inner = spec.n_inner_layers
    fri_alphas = tuple(felt(4 + i, 0) for i in range(n_inner + 1))

    n_query_draws = (spec.n_queries + 7) // 8
    qrate = rate[5 + n_inner : 5 + n_inner + n_query_draws]  # (k, B, 8)
    raw = xp.swapaxes(qrate, 0, 1).reshape(B, n_query_draws * 8)[:, : spec.n_queries]

    T = operands.shape[1]
    pow_digest0 = digests[T - 1, :, 0]

    return FSOutput(
        z=felt(0, 0),
        alpha=felt(0, 1),
        random_coeff=felt(1, 0),
        oods_t=felt(2, 0),
        after_sampled_values_random_coeff=felt(3, 0),
        fri_alphas=fri_alphas,
        raw_queries=raw,
        pow_digest0=pow_digest0,
    )


# ---------------------------------------------------------------------------
# PlonkWithoutPoseidon transcript (single statement log size / total sum)
# ---------------------------------------------------------------------------

def n_rows_np(spec) -> int:
    return 8 + n_sample_rows(spec) + spec.n_inner_layers + n_last_poly_rows(spec)


def build_operands_np(spec, pa) -> object:
    """(B, T, 8) mix operands: c0, log_size, c1, total_sum, c2, c3,
    samples (pairs), first-layer root, inner roots, last poly, nonce."""
    xp = _xp(pa.commitments)
    B = pa.commitments.shape[0]
    zeros = xp.zeros

    def const_row(vals):
        row = np.zeros((1, 1, 8), np.uint32)
        for i, v in enumerate(vals):
            row[0, 0, i] = v
        return xp.broadcast_to(xp.asarray(row), (B, 1, 8))

    def pad_pairs(flat):
        S = flat.shape[1]
        if S % 2:
            flat = xp.concatenate([flat, zeros((B, 1, 4), xp.uint32)], axis=1)
        return flat.reshape(B, (S + 1) // 2, 8)

    rows = [
        pa.commitments[:, 0:1],
        const_row([spec.log_size]),
        pa.commitments[:, 1:2],
        xp.concatenate(
            [pa.plonk_total_sum, zeros((B, 4), xp.uint32)], axis=-1
        )[:, None],
        pa.commitments[:, 2:3],
        pa.commitments[:, 3:4],
        pad_pairs(pa.samples_flat),
        pa.first_layer_commitment[:, None],
        pa.inner_commitments,
        pad_pairs(pa.last_poly),
        xp.concatenate([pa.nonce_limbs, zeros((B, 5), xp.uint32)], axis=-1)[:, None],
    ]
    ops = xp.concatenate(rows, axis=1)
    assert ops.shape[1] == n_rows_np(spec), (ops.shape, n_rows_np(spec))
    return ops


def _draw_schedule_np(spec) -> List[tuple]:
    ns = n_sample_rows(spec)
    T = n_rows_np(spec)
    sched = [(2, 0), (4, 0), (5, 0), (5 + ns, 0), (6 + ns, 0)]
    for i in range(spec.n_inner_layers):
        sched.append((7 + ns + i, 0))
    n_query_draws = (spec.n_queries + 7) // 8
    for k in range(n_query_draws):
        sched.append((T - 1, k))
    return sched


def run_transcript_np(spec, pa) -> FSOutput:
    operands = build_operands_np(spec, pa)
    xp = _xp(operands)
    B = operands.shape[0]
    digests = digest_chain(operands)

    sched = _draw_schedule_np(spec)
    rows = np.array([r for r, _ in sched], np.int32)
    nsent = np.array([[n] for _, n in sched], np.uint32)

    sel = digests[xp.asarray(rows)]
    D = len(sched)
    left = xp.zeros((D, B, 8), xp.uint32)
    left[:, :, 0] = nsent
    state = xp.concatenate([left, sel], axis=-1)
    rate = poseidon2.permute(state)[..., :8]

    def felt(d, half):
        s = rate[d, :, 4 * half : 4 * half + 4]
        return QM31(s[:, 0], s[:, 1], s[:, 2], s[:, 3])

    n_inner = spec.n_inner_layers
    fri_alphas = tuple(felt(4 + i, 0) for i in range(n_inner + 1))

    n_query_draws = (spec.n_queries + 7) // 8
    qrate = rate[5 + n_inner : 5 + n_inner + n_query_draws]
    raw = xp.swapaxes(qrate, 0, 1).reshape(B, n_query_draws * 8)[:, : spec.n_queries]

    T = operands.shape[1]
    pow_digest0 = digests[T - 1, :, 0]

    return FSOutput(
        z=felt(0, 0),
        alpha=felt(0, 1),
        random_coeff=felt(1, 0),
        oods_t=felt(2, 0),
        after_sampled_values_random_coeff=felt(3, 0),
        fri_alphas=fri_alphas,
        raw_queries=raw,
        pow_digest0=pow_digest0,
    )


def pow_check(spec: VerifierSpec, fs: FSOutput):
    """Low pow_bits of the post-nonce digest limb 0 must be zero."""
    mask = np.uint32((1 << spec.pow_bits) - 1)
    return (fs.pow_digest0 & mask) == 0


def queries_at_log_size(spec: VerifierSpec, raw_queries, log_size: int):
    """Query positions at a given domain log size (masked + shifted)."""
    masked = raw_queries & np.uint32((1 << spec.max_first_layer_log) - 1)
    return masked >> np.uint32(spec.max_first_layer_log - log_size)
