"""Fiat-Shamir transcript replay: one digest chain plus one batched draw.

Twin of recursive_stwo_tpu/verifier/transcript.py, for both proof flavours
on the Poseidon31 channel: PlonkWithPoseidon (`run_transcript`) and
PlonkWithoutPoseidon (`run_transcript_np`).  Every value mixed into the
channel is proof data, so the digest chain is T sequential permutations over
a (B, T, 8) operand tensor, one batched permutation launch per step, and all
draws are then one batched permutation of the gathered digest states.  The
draw schedules and FSOutput container are the reference's own.

`replay(spec, pa, inputs)` is what the verifiers call: the transcript with
the per-proof scalars beside it (the OODS point, the public inputs' logup
sum, the PoW and total-sum checks).  A CPU batch takes the plain version
(`replay_plain`: `run_transcript[_np]`, `points.oods_point_from_t`,
`input_sum`), a CUDA one the transcript kernel (ops/transcript_cuda.py: one
launch for the whole batch).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..core import m31, poseidon2
from ..core import qm31 as q
from ..core.qm31 import QM31
from . import points
from .spec import NoPoseidonVerifierSpec, VerifierSpec
from .transcript_host import FSOutput, _draw_schedule, _draw_schedule_np, n_rows, n_rows_np

__all__ = [
    "FSOutput", "Replay", "build_operands", "build_operands_np", "digest_chain", "input_sum", "is_zero",
    "pow_check", "queries_at_log_size", "replay", "replay_plain", "run_transcript", "run_transcript_np",
]


def _const_row(like: torch.Tensor, vals) -> torch.Tensor:
    row = like.new_zeros((like.shape[0], 1, 8))
    for i, v in enumerate(vals):
        row[:, :, i] = v
    return row


def _pad_pairs(flat: torch.Tensor) -> torch.Tensor:
    """(B, S, 4) -> (B, ceil(S/2), 8)."""
    B, S, _ = flat.shape
    if S % 2:
        flat = torch.cat([flat, flat.new_zeros((B, 1, 4))], dim=1)
    return flat.reshape(B, (S + 1) // 2, 8)


def _fri_and_nonce_rows(pa) -> list:
    """The operand rows after the sampled values: first-layer root, inner
    roots, last-layer polynomial, nonce."""
    return [
        pa.first_layer_commitment[:, None],
        pa.inner_commitments,
        _pad_pairs(pa.last_poly),
        torch.cat([pa.nonce_limbs, pa.nonce_limbs.new_zeros((pa.nonce_limbs.shape[0], 5))], dim=-1)[:, None],
    ]


def _stack_rows(rows: list, expected: int) -> torch.Tensor:
    ops = torch.cat(rows, dim=1)
    if ops.shape[1] != expected:
        raise ValueError(f"operand rows {ops.shape[1]} != spec rows {expected}")
    return ops


def build_operands(spec: VerifierSpec, pa) -> torch.Tensor:
    """Assemble the (B, T, 8) mix-operand tensor from proof arrays."""
    like = pa.commitments
    rows = [
        pa.commitments[:, 0:1],
        _const_row(like, [spec.log_size_plonk]),
        _const_row(like, [spec.log_size_poseidon]),
        pa.commitments[:, 1:2],
        torch.cat([pa.plonk_total_sum, pa.poseidon_total_sum], dim=-1)[:, None],
        pa.commitments[:, 2:3],
        pa.commitments[:, 3:4],
        _pad_pairs(pa.samples_flat),
    ]
    return _stack_rows(rows + _fri_and_nonce_rows(pa), n_rows(spec))


def build_operands_np(spec, pa) -> torch.Tensor:
    """(B, T, 8) mix operands of the without-Poseidon transcript: c0,
    log_size, c1, total_sum, c2, c3, samples (pairs), first-layer root,
    inner roots, last poly, nonce.  Only `plonk_total_sum` is read: the
    flavour has one statement sum."""
    like = pa.commitments
    rows = [
        pa.commitments[:, 0:1],
        _const_row(like, [spec.log_size]),
        pa.commitments[:, 1:2],
        torch.cat([pa.plonk_total_sum, torch.zeros_like(pa.plonk_total_sum)], dim=-1)[:, None],
        pa.commitments[:, 2:3],
        pa.commitments[:, 3:4],
        _pad_pairs(pa.samples_flat),
    ]
    return _stack_rows(rows + _fri_and_nonce_rows(pa), n_rows_np(spec))


def digest_chain(operands: torch.Tensor) -> torch.Tensor:
    """Sequential digest evolution; returns (T, B, 8) post-mix digests."""
    B, T, _ = operands.shape
    out = operands.new_empty((T, B, 8))
    digest = operands.new_zeros((B, 8))
    for t in range(T):
        digest = poseidon2.permute(torch.cat([operands[:, t], digest], dim=-1))[:, 8:]
        out[t] = digest
    return out


def _replay(spec, operands: torch.Tensor, sched) -> FSOutput:
    """The digest chain over `operands`, then every draw of `sched` in one
    batched permutation."""
    B, T, _ = operands.shape
    digests = digest_chain(operands)  # (T, B, 8)

    rows = torch.tensor([r for r, _ in sched], device=operands.device)
    nsent = torch.tensor([n for _, n in sched], device=operands.device)

    sel = digests[rows]  # (D, B, 8)
    left = torch.zeros_like(sel)
    left[:, :, 0] = nsent[:, None]
    rate = poseidon2.permute(torch.cat([left, sel], dim=-1))[..., :8]  # (D, B, 8)

    def felt(d, half):
        s = rate[d, :, 4 * half : 4 * half + 4]
        return QM31(s[:, 0], s[:, 1], s[:, 2], s[:, 3])

    n_inner = spec.n_inner_layers
    n_query_draws = (spec.n_queries + 7) // 8
    qrate = rate[5 + n_inner : 5 + n_inner + n_query_draws]  # (k, B, 8)
    raw = qrate.transpose(0, 1).reshape(B, n_query_draws * 8)[:, : spec.n_queries]

    return FSOutput(
        z=felt(0, 0),
        alpha=felt(0, 1),
        random_coeff=felt(1, 0),
        oods_t=felt(2, 0),
        after_sampled_values_random_coeff=felt(3, 0),
        fri_alphas=tuple(felt(4 + i, 0) for i in range(n_inner + 1)),
        raw_queries=raw,
        pow_digest0=digests[T - 1, :, 0],
    )


def run_transcript(spec: VerifierSpec, pa) -> FSOutput:
    return _replay(spec, build_operands(spec, pa), _draw_schedule(spec))


def run_transcript_np(spec, pa) -> FSOutput:
    """The PlonkWithoutPoseidon transcript (one statement log size and total
    sum), on the same digest chain and draw launch."""
    return _replay(spec, build_operands_np(spec, pa), _draw_schedule_np(spec))


def pow_check(spec: VerifierSpec, fs: FSOutput) -> torch.Tensor:
    """Low pow_bits of the post-nonce digest limb 0 must be zero."""
    return (fs.pow_digest0 & ((1 << spec.pow_bits) - 1)) == 0


def queries_at_log_size(spec: VerifierSpec, raw_queries, log_size: int):
    """Query positions at a given domain log size (masked + shifted)."""
    masked = raw_queries & ((1 << spec.max_first_layer_log) - 1)
    return masked >> (spec.max_first_layer_log - log_size)


def _q_cols(arr: torch.Tensor) -> QM31:
    return QM31(*(arr[:, i] for i in range(4)))


def is_zero(x: QM31) -> torch.Tensor:
    return (x.a == 0) & (x.b == 0) & (x.c == 0) & (x.d == 0)


def input_sum(fs, inputs) -> QM31:
    """sum_i 1/((val_i + alpha*idx_i) - z), batched: one q_inv over the
    stacked (n_inputs, B) terms instead of one per input (the bitcoin proof
    has 264 public inputs), then the pairwise sum of the JAX package's
    verify_sha256._input_sum.  The sum is exact over M31, so every
    verifier gets the value of the per-input loop."""
    like = fs.z.a
    if not inputs:
        return q.q_zero(like)
    idxs = torch.tensor([i for i, _ in inputs], dtype=torch.int64, device=like.device)[:, None]
    vals = torch.tensor([v for _, v in inputs], dtype=torch.int64, device=like.device)
    term = QM31(
        *(
            m31.sub(m31.add(vals[:, k : k + 1], m31.mul(fs.alpha[k][None, :], idxs)), fs.z[k][None, :])
            for k in range(4)
        )
    )
    inv = q.q_inv(term)  # (n, B)
    comps = []
    for c in inv:
        acc = c
        while acc.shape[0] > 1:
            half = acc.shape[0] // 2
            lo = m31.add(acc[:half], acc[half : 2 * half])
            if acc.shape[0] % 2:
                lo = torch.cat([lo, acc[-1:]], dim=0)
            acc = lo
        comps.append(acc[0])
    return QM31(*comps)


class Replay(NamedTuple):
    """A batch's transcript and the per-proof scalars the verifiers take
    from it."""

    fs: FSOutput
    oods: Tuple[QM31, QM31]  # the OODS point (x, y)
    input_sum: QM31  # sum_i 1/(val_i + alpha*idx_i - z)
    pow: torch.Tensor  # (B,) bool: the PoW check
    total_sum: torch.Tensor  # (B,) bool: input sum + the total sums == 0


def replay_plain(spec, pa, inputs: Sequence[Tuple[int, Tuple[int, int, int, int]]]) -> Replay:
    """The plain version of the transcript kernel, in eager torch on pa's
    device: the flavour's transcript, the OODS point, the input sum and the
    two checks (the without-Poseidon flavour has one total sum)."""
    without_poseidon = isinstance(spec, NoPoseidonVerifierSpec)
    fs = run_transcript_np(spec, pa) if without_poseidon else run_transcript(spec, pa)
    inputs_term = input_sum(fs, inputs)
    sums = (pa.plonk_total_sum,) if without_poseidon else (pa.plonk_total_sum, pa.poseidon_total_sum)
    total = inputs_term
    for s in sums:
        total = q.q_add(total, _q_cols(s))
    return Replay(fs, points.oods_point_from_t(fs.oods_t), inputs_term, pow_check(spec, fs), is_zero(total))


def replay(spec, pa, inputs: Sequence[Tuple[int, Tuple[int, int, int, int]]]) -> Replay:
    """The transcript of a batch and its per-proof scalars: a CPU batch
    takes the plain version, a CUDA one the transcript kernel (one launch)."""
    if pa.commitments.device.type == "cpu":
        return replay_plain(spec, pa, inputs)
    from ..ops import transcript_cuda

    return transcript_cuda.replay(spec, pa, inputs)
