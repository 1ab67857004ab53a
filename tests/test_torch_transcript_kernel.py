"""The transcript kernel's plain route and its host-side tables on the CPU,
at tolerance 0 (bit-exact over M31):

- `transcript.replay` on CPU tensors (the plain version: run_transcript[_np],
  the OODS point, the input sum and the PoW and total-sum checks) against
  the JAX package's run_transcript[_np], points.oods_point_from_t and the
  input loop of verifier/verify.py:50-63 / verify_np.py:37-47, on numpy and
  on jax.numpy inputs, clean, corrupted, with a wrong public input and with
  none;
- the kernel's row table, read as the kernel reads it (a numpy emulation),
  against the JAX package's build_operands[_np], and its draw table, draw
  schedule (each draw beside the row after its own, the draws after the
  last row two at a time) and output layout against run_transcript[_np];
- a numpy model of the kernel's permutation (csrc/poseidon2.cuh's quad
  form: word 0 replicated over the quad's partial rounds, the other words'
  sum taken before the S-box joins it, m31.cuh's adds and one-fold products
  with their bounds asserted) against the JAX package's poseidon2.permute;
- the wrapper's refusals.
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3)."""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recursive_stwo_tpu.core import poseidon2 as r_p2
from recursive_stwo_tpu.core import qm31 as rq
from recursive_stwo_tpu.core.qm31 import QM31 as RQM31
from recursive_stwo_tpu.verifier import points as r_points
from recursive_stwo_tpu.verifier import transcript as r_tr
from recursive_stwo_tpu.verifier.verify import _q_const
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.ops import transcript_cuda
from recursive_stwo_tpu_torch.tools import transcript_cases as cases
from recursive_stwo_tpu_torch.verifier import transcript as t_tr
from recursive_stwo_tpu_torch.verifier.arrays import ProofArrays, map_arrays
from recursive_stwo_tpu_torch.verifier.spec import NoPoseidonVerifierSpec, VerifierSpec

P = 2**31 - 1
# each case's batch and public inputs (None: the fixture's own)
CASES = {
    "clean": (1, None, False),
    "corrupted": (4, None, True),
    "wrong input": (2, ((1, (2, 0, 0, 0)),), False),
    "no inputs": (3, (), False),
}
# (rows T, draws D) of each fixture's transcript
SHAPES = {"small_proof": (89, 14), "recursive_proof_16_15": (216, 15), "np_small": (38, 14)}


def _host(pa):
    """The case's ProofArrays as numpy uint32 (the JAX package's input)."""
    return map_arrays(lambda x: x.numpy().astype(np.uint32), pa)


def _reference(spec, pa, inputs):
    """The JAX package's transcript, OODS point, input sum and checks
    (verifier/verify.py:43-66, verify_np.py:32-50), as a Replay."""
    without = isinstance(spec, NoPoseidonVerifierSpec)
    fs = (r_tr.run_transcript_np if without else r_tr.run_transcript)(spec, pa)
    like = fs.z.a
    total = rq.q_zero(like)
    for idx, val in inputs:
        term = rq.q_sub(rq.q_add(_q_const(val, like), rq.q_mul_m31(fs.alpha, np.uint32(idx))), fs.z)
        total = rq.q_add(total, rq.q_inv(term))
    checked = rq.q_add(total, RQM31(*(pa.plonk_total_sum[:, i] for i in range(4))))
    if not without:
        checked = rq.q_add(checked, RQM31(*(pa.poseidon_total_sum[:, i] for i in range(4))))
    zero = (checked.a == 0) & (checked.b == 0) & (checked.c == 0) & (checked.d == 0)
    return t_tr.Replay(fs, r_points.oods_point_from_t(fs.oods_t), total, r_tr.pow_check(spec, fs), zero)


def _same(ref: dict, got: dict) -> None:
    assert list(ref) == list(got)
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]).astype(np.int64), got[k].numpy().astype(np.int64)), k


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("backend", ["np", "jnp"])
@pytest.mark.parametrize("name", cases.TRANSCRIPT_FIXTURES)
def test_replay_plain_matches_reference(name, backend, case):
    batch, inputs, corrupt = CASES[case]
    c = cases.transcript_case(name, batch, "cpu", corrupt=corrupt, inputs=inputs)
    host = _host(c.pa)
    ref = _reference(c.spec, host if backend == "np" else map_arrays(jnp.asarray, host), c.inputs)
    got = cases.fields(t_tr.replay(c.spec, c.pa, c.inputs))
    _same(cases.fields(ref), got)
    if case == "corrupted":
        # the nonce is the last row mixed: it moves the PoW digest, not z or
        # alpha; a commitment word moves every draw after it
        nonce, commitment = cases.CORRUPT_SLOTS
        assert [b for b in range(batch) if not got["pow"][b]] == [nonce, commitment]
        assert [b for b in range(batch) if not got["total_sum"][b]] == [commitment]
    else:
        assert bool(got["pow"].all())
        assert bool(got["total_sum"].all()) == (case == "clean")


@pytest.mark.parametrize("name", cases.TRANSCRIPT_FIXTURES)
def test_replay_plain_on_random_inputs_with_a_zero_term(name):
    """Random canonical proof arrays and public inputs, one input planted so
    that its term is zero in slot 0 (inv(0) = 0 in both packages)."""
    c = cases.random_transcript_case(name, 3, 11, "cpu")
    _same(cases.fields(_reference(c.spec, _host(c.pa), c.inputs)), cases.fields(t_tr.replay(c.spec, c.pa, c.inputs)))


@dataclass(frozen=True)
class _OddSamples(VerifierSpec):
    """A with-Poseidon spec with an odd sample count (every real one has
    142), which pads the last sample row with a zero half."""

    @property
    def total_samples(self) -> int:
        return 141


@dataclass(frozen=True)
class _OddSamplesNp(NoPoseidonVerifierSpec):
    @property
    def total_samples(self) -> int:
        return 39


# each spec the row table is held to: the fixtures', the SHA-256 artifacts'
# (bitcoin's degree-0 last layer is one coefficient, one padded row) and two
# with odd sample counts
SPECS = {
    "small_proof": lambda: flagship.prepared_arrays("small_proof")[0],
    "recursive_proof_16_15": lambda: flagship.prepared_arrays("recursive_proof_16_15")[0],
    "np_small": lambda: flagship.prepared_arrays_np("np_small")[0],
    "level14": lambda: flagship.sha_prepared("level14")[0],
    "bitcoin": lambda: flagship.sha_prepared("bitcoin")[0],
    "odd samples": lambda: _OddSamples(16, 15, 20, 0, 1, 16, 5),
    "odd samples, without Poseidon": lambda: _OddSamplesNp(10, 5, 3, 1, 8, 6),
}


def _random_arrays(spec, batch, seed):
    """Random canonical arrays of the fields the transcript reads."""
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return rng.integers(0, P, (batch,) + shape).astype(np.uint32)

    return ProofArrays(rand(4, 8), rand(4), rand(4), rand(spec.total_samples, 4), rand(8),
                       rand(spec.n_inner_layers, 8), rand(1 << spec.log_last_layer_degree_bound, 4),
                       rng.integers(0, 1 << 21, (batch, 3)).astype(np.uint32))


def _emulated_operands(spec, pa) -> np.ndarray:
    """The (B, T, 8) operands as the kernel reads them through its row
    table (csrc/transcript.cu load_half)."""
    t = transcript_cuda.row_table(spec)
    batch = pa.commitments.shape[0]
    flat = [np.asarray(getattr(pa, name)).reshape(batch, -1) for name in transcript_cuda.SOURCES]
    ops = np.zeros((batch, len(t.rows), 8), np.uint32)
    for r, row in enumerate(t.rows):
        for h, (src, off, n) in enumerate(row):
            if src == transcript_cuda.CONST:
                ops[:, r, 4 * h] = off
            else:
                ops[:, r, 4 * h:4 * h + n] = flat[src][:, off:off + n]
    return ops


@pytest.mark.parametrize("name", list(SPECS))
def test_row_table_reads_build_operands(name):
    """The kernel's reads reproduce the JAX package's operand tensor, row for
    row: odd and even sample counts, last layers of 1 to 256 coefficients."""
    spec = SPECS[name]()
    pa = _random_arrays(spec, 3, 5)
    build = r_tr.build_operands_np if isinstance(spec, NoPoseidonVerifierSpec) else r_tr.build_operands
    assert np.array_equal(_emulated_operands(spec, pa), build(spec, pa))


def test_row_table_specs_cover_odd_and_even_shapes():
    specs = [make() for make in SPECS.values()]
    assert {s.total_samples % 2 for s in specs} == {0, 1}
    assert {s.log_last_layer_degree_bound for s in specs} >= {0, 8}


# ---------------------------------------------------------------------------
# numpy model of csrc/poseidon2.cuh's quad form: (B, 4 lanes, 4 words)
# uint32, lane q holding words 4q..4q+3
# ---------------------------------------------------------------------------

U32P = np.uint32(P)


def _add(a, b):
    """m31.cuh add: canonical a, b; s = a + b < 2p fits 32 bits, and of s and s - p
    (wrapping) the unsigned minimum is the residue."""
    assert (a < P).all() and (b < P).all()
    s = a.astype(np.uint64) + b.astype(np.uint64)
    assert (s < 2 * P).all()
    s = s.astype(np.uint32)
    return np.minimum(s, s - U32P)


def _mul(a, b):
    """m31.cuh mul: canonical a, b; one fold leaves r = (x & p) + (x >> 31) < 2p."""
    assert (a < P).all() and (b < P).all()
    x = a.astype(np.uint64) * b.astype(np.uint64)
    r = (x & np.uint64(P)) + (x >> np.uint64(31))
    assert (r < 2 * P).all()
    r = r.astype(np.uint32)
    return np.minimum(r, r - U32P)


def _pow5(a):
    b = _mul(a, a)
    return _mul(_mul(b, b), a)


def _rot(a, k):
    """mul_pow2: a 31-bit rotation, canonical in, canonical out."""
    assert (a < P).all()
    a = a.astype(np.uint64)
    r = (((a << np.uint64(k)) & np.uint64(P)) + (a >> np.uint64(31 - k))).astype(np.uint32)
    assert (r < P).all()
    return r


def _quad_sum(v):
    """quad_sum over the lane axis (xor-shuffles by 1, then 2)."""
    v = _add(v, v[:, [1, 0, 3, 2]])
    return _add(v, v[:, [2, 3, 0, 1]])


def _quad_mds16(s):
    x0, x1, x2, x3 = (s[..., k] for k in range(4))
    t0, t1 = _add(x0, x1), _add(x2, x3)
    t2, t3 = _add(_add(x1, x1), t1), _add(_add(x3, x3), t0)
    t4, t5 = _add(_rot(t1, 2), t3), _add(_rot(t0, 2), t2)
    t = np.stack([_add(t3, t5), t5, _add(t2, t4), t4], axis=-1)
    return np.stack([_add(t[..., pos], _quad_sum(t[..., pos])) for pos in range(4)], axis=-1)


def _quad_partial_rounds(s):
    """Word 0 replicated on the four lanes: each round's S-box y, the sum
    S15 of the other words (lane 0 leaves out its word 0), word 0 becomes
    S15 + 4 y and the next S-box input (S15 + rc) + 4 y."""
    s = s.copy()
    q = np.arange(4)
    rc = r_p2.PARTIAL_ROUNDS_RC.astype(np.uint32)
    w0 = s[:, 0, 0]
    x = _add(w0, np.full_like(w0, rc[0]))
    for r in range(14):
        y = _pow5(x)
        own0 = np.where(q == 0, np.uint32(0), s[..., 0])
        s15 = _quad_sum(_add(_add(s[..., 1], s[..., 2]), _add(s[..., 3], own0)))
        assert (s15 == s15[:, :1]).all()  # the same on every lane
        total = _add(s15, y[:, None])
        y4 = _rot(y, 2)
        w0 = _add(s15[:, 0], y4)
        for k in range(4):
            s[..., k] = np.stack([_add(total[:, l], _rot(s[:, l, k], 4 * l + k + 1)) for l in range(4)], axis=-1)
        if r < 13:
            x = _add(_add(s15[:, 0], np.full_like(w0, rc[r + 1])), y4)
    s[:, 0, 0] = w0
    return s


def _permute_quad(states):
    """The quad-form permutation of (B, 16) canonical states."""
    s = states.astype(np.uint32).reshape(-1, 4, 4)
    s = _quad_mds16(s)
    for rc in (*r_p2.FIRST_FOUR_ROUND_RC, None, *r_p2.LAST_FOUR_ROUNDS_RC):
        if rc is None:
            s = _quad_partial_rounds(s)
            continue
        s = _quad_mds16(_pow5(_add(s, rc.astype(np.uint32).reshape(4, 4)[None])))
    return s.reshape(-1, 16)


def test_latency_form_permutation_model_matches_reference():
    """The model of the transcript kernel's permutation equals the JAX
    package's Poseidon2-16 on random states, states of p - 1 and of 0, and
    mixed rows."""
    rng = np.random.default_rng(2026)
    x = rng.integers(0, P, (256, 16)).astype(np.uint32)
    x[0], x[1], x[2] = P - 1, 0, np.arange(16)
    x[3, ::2] = P - 1
    x[4, rng.integers(0, 16, 8)] = P - 1
    assert np.array_equal(_permute_quad(x), np.asarray(r_p2.permute(x)))


@pytest.mark.parametrize("name", cases.TRANSCRIPT_FIXTURES)
def test_draw_table_and_layout_rebuild_the_transcript(name):
    """A numpy emulation of the kernel's draw schedule: at step t the
    chain's quad permutes row t and the draws' quad the draw after row
    t - 1, with the digest the chain holds then; the draws after the last
    row go two at a time, one a quad.  Each draw is the permutation (the
    quad-form model) of (n_sent, 0, ..., 0 ‖ digest), its rate words
    stored from its first column; with the post-nonce digest's word, read
    back through `views`, it equals the plain transcript field for field."""
    c = cases.random_transcript_case(name, 2, 3, "cpu")
    spec, host = c.spec, _host(c.pa)
    t = transcript_cuda.row_table(spec)
    n_rows = len(t.rows)
    digests = r_tr.digest_chain(_emulated_operands(spec, host))  # (T, B, 8)
    lay = t.layout
    out = np.zeros((2, lay.width), np.int64)
    steps = transcript_cuda.draw_steps(spec)
    assert transcript_cuda.chain_steps(spec) == n_rows + 1
    for step in range(transcript_cuda.chain_steps(spec)):
        jobs = [d for d, at in enumerate(steps) if at == step]
        assert len(jobs) <= (1 if step < n_rows else 2)  # the draws' quad beside a row; both quads after
        held = min(step, n_rows) - 1  # the row whose digest the chain holds at this step
        for d in jobs:
            row, n_sent, col, words = t.draws[d]
            assert row == held
            state = np.concatenate([np.zeros_like(digests[row]), digests[row]], axis=-1)
            state[:, 0] = n_sent
            out[:, col:col + words] = _permute_quad(state)[:, :words]
    out[:, lay.pow] = digests[-1][:, 0]
    want = t_tr.replay_plain(spec, c.pa, c.inputs)
    for k, v in enumerate((*want.oods, want.input_sum)):
        out[:, lay.tail + 4 * k:lay.tail + 4 * k + 4] = torch.stack(list(v), dim=-1).numpy()
    ok = torch.stack([want.pow, want.total_sum], dim=-1)
    _same(cases.fields(want), cases.fields(transcript_cuda.views(spec, torch.from_numpy(out), ok)))


@pytest.mark.parametrize("name", cases.TRANSCRIPT_FIXTURES)
def test_transcript_shapes_and_bound(name):
    """T rows and D draws a proof; the bound at B=1024 is the operations'."""
    spec = cases.transcript_case(name, 1, "cpu").spec
    t = transcript_cuda.row_table(spec)
    assert (len(t.rows), len(t.draws)) == SHAPES[name]
    assert transcript_cuda.chain_steps(spec) == SHAPES[name][0] + 1  # the draws off the chain
    ms, by = transcript_cuda.transcript_bound_ms(spec, 1024, 3)
    assert by == "operations"
    assert ms == pytest.approx(1024 * transcript_cuda.transcript_ops(spec, 3) / transcript_cuda.H100_INT_OPS_PER_S * 1e3)


def test_row_table_refuses_draws_sharing_an_inner_row(monkeypatch):
    """Each draw before the last row must follow a row of its own (the
    kernel runs it beside the next row's permutation)."""
    spec = cases.transcript_case("small_proof", 1, "cpu").spec
    sched = transcript_cuda._draw_schedule(spec)
    monkeypatch.setattr(transcript_cuda, "_draw_schedule", lambda s: [sched[0], sched[0]] + sched[2:])
    with pytest.raises(ValueError, match="row after its own"):
        transcript_cuda.row_table.__wrapped__(spec)


def test_wrapper_refuses_cpu_tensors():
    """The wrapper raises on a CPU tensor: the plain version is taken by the
    dispatch, never by the wrapper falling back."""
    c = cases.transcript_case("small_proof", 1, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        transcript_cuda.transcript(c.spec, c.pa, c.inputs)


def test_cpu_batch_never_reaches_the_wrapper(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel's wrapper ran on a CPU batch")

    monkeypatch.setattr(transcript_cuda, "replay", refuse)
    c = cases.transcript_case("np_small", 2, "cpu")
    assert bool(t_tr.replay(c.spec, c.pa, c.inputs).total_sum.all())
