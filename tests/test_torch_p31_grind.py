"""The Poseidon31 channel's proof-of-work grind on the CPU: where
`prover/channel.py::PoseidonChannel.grind_pow` sends it, the limits of its
kernel's wrapper (`ops/poseidon_cuda.py::p31_grind`), and the kernel's two
linear layers (`csrc/poseidon2_grind.cu`: the initial mds16 with the digest's
terms hoisted and the zero words folded, the final one's word 8 alone)
replayed in Python against mds16, with their operation counts.  The kernel
itself runs in tests/test_torch_cuda.py, on a card.

    python -m pytest tests/test_torch_p31_grind.py -q
"""

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.core import poseidon2 as r_p2
from recursive_stwo_tpu.prover.channel import PoseidonChannel as RChannel
from recursive_stwo_tpu_torch.core import poseidon2 as t_p2
from recursive_stwo_tpu_torch.ops import build, poseidon_cuda
from recursive_stwo_tpu_torch.prover import channel as t_channel
from recursive_stwo_tpu_torch.prover.channel import PoseidonChannel
from recursive_stwo_tpu_torch.utils import native

P = 2**31 - 1


def _mixed(ch, seed):
    ch.mix_root(np.random.default_rng(seed).integers(0, P, 8).astype(np.uint32))
    ch.mix_one_felt([seed, 1, 2, 3])
    return ch


def _no_kernel(*args, **kwargs):
    raise AssertionError("the grind kernel's wrapper was called")


@pytest.mark.parametrize("pow_bits", [5, 12, 20])
def test_cpu_channel_grinds_on_the_host(monkeypatch, pow_bits):
    """A channel on the CPU grinds on the host even where CUDA is available:
    native's nonce, the JAX package's channel's, and one that passes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(poseidon_cuda, "p31_grind", _no_kernel)
    ch = _mixed(PoseidonChannel("cpu"), pow_bits)
    nonce = ch.grind_pow(pow_bits)
    assert nonce == native.grind(ch.digest, pow_bits)
    assert nonce == _mixed(RChannel(), pow_bits).grind_pow(pow_bits)
    ch.mix_u64(nonce)
    assert int(ch.digest[0]) % (1 << pow_bits) == 0


def test_cuda_channel_grinds_zero_bits_on_the_host(monkeypatch):
    """At 0 bits, outside the kernel's limits, a CUDA channel returns the
    first nonce from the host."""
    monkeypatch.setattr(poseidon_cuda, "p31_grind", _no_kernel)
    assert _mixed(PoseidonChannel("cuda"), 0).grind_pow(0) == 0


@pytest.mark.parametrize("pow_bits", [1, 20, 28, 31])
@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cuda:1"])
def test_cuda_channel_calls_the_kernel(monkeypatch, device, pow_bits):
    """On a CUDA channel the grind, at any bits (20 as at chain level 1, 28
    as at level 12), is one call of the kernel's wrapper with the channel's
    digest and device, and its nonce is the channel's; K1's block grind and
    the host scan never run."""
    calls = []

    def fake(digest_words, bits, start=0, device="cuda"):
        calls.append((list(digest_words), bits, start, device))
        return 123_456_789

    monkeypatch.setattr(poseidon_cuda, "p31_grind", fake)
    monkeypatch.setattr(t_channel, "grind_device", _no_kernel)
    monkeypatch.setattr(t_channel, "grind_host", _no_kernel)
    ch = _mixed(PoseidonChannel(device), pow_bits)
    assert ch.grind_pow(pow_bits) == 123_456_789
    assert calls == [(list(ch.digest), pow_bits, 0, torch.device(device))]


@pytest.mark.parametrize("prover", ["prove", "prove_np", "prove_streamed", "prove_np_streamed"])
def test_cpu_proof_grinds_on_the_host(monkeypatch, prover):
    """A Poseidon31 proof with device='cpu', resident or streamed, grinds
    once, on the host, and never calls the kernel's wrapper."""
    from test_torch_chain import T_NP_CONFIG, _np_trace

    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.prover.prove import prove
    from recursive_stwo_tpu_torch.prover.prove_np import prove_np
    from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed, prove_streamed

    seen = []
    grind_host = t_channel.grind_host

    def spy(digest, pow_bits):
        seen.append(pow_bits)
        return grind_host(digest, pow_bits)

    monkeypatch.setattr(t_channel, "grind_host", spy)
    monkeypatch.setattr(poseidon_cuda, "p31_grind", _no_kernel)
    trace, config, fn = {"prove": (flagship.demo_trace(), flagship.DEMO_CONFIG, prove),
                         "prove_np": (_np_trace(), T_NP_CONFIG, prove_np),
                         "prove_streamed": (flagship.demo_trace(), flagship.DEMO_CONFIG, prove_streamed),
                         "prove_np_streamed": (_np_trace(), T_NP_CONFIG, prove_np_streamed)}[prover]
    fn(trace, config, device="cpu")
    assert seen == [config.pow_bits]


LIMITS = {
    "pow_bits 0": dict(pow_bits=0),
    "pow_bits 32": dict(pow_bits=32),
    "7 words": dict(digest_words=np.arange(7, dtype=np.uint32)),
    "9 words": dict(digest_words=np.arange(9, dtype=np.uint32)),
    "a word of p": dict(digest_words=[0] * 7 + [P]),
    "a negative word": dict(digest_words=[-1] + [0] * 7),
    "start -1": dict(start=-1),
    "start 2**64": dict(start=2**64),
    "the CPU": dict(device="cpu"),
    "a CPU tensor's device": dict(digest_words=torch.arange(8), device=torch.arange(8).device),
}


@pytest.mark.parametrize("case", list(LIMITS))
def test_grind_refuses_outside_its_limits(monkeypatch, case):
    """Each limit raises ValueError before the library is loaded or a device
    is asked for."""
    monkeypatch.setattr(build, "load", lambda: pytest.fail("the library was loaded"))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: pytest.fail("a CUDA device was asked for"))
    args = dict(digest_words=np.arange(8, dtype=np.uint32), pow_bits=20, start=0, device="cuda:0")
    args.update(LIMITS[case])
    with pytest.raises(ValueError):
        poseidon_cuda.p31_grind(**args)


class _Adds:
    """m31.cuh's add on canonical residues, counted."""

    def __init__(self):
        self.n = 0

    def __call__(self, a, b):
        self.n += 1
        assert 0 <= a < P and 0 <= b < P
        return (a + b) % P


def _m4(add, x0, x1, x2, x3):
    """csrc/poseidon2_grind.cu `m4`: mds16's M4 of one block."""
    t0, t1 = add(x0, x1), add(x2, x3)
    t2, t3 = add(add(x1, x1), t1), add(add(x3, x3), t0)
    t1d, t0d = add(t1, t1), add(t0, t0)
    t4, t5 = add(add(t1d, t1d), t3), add(add(t0d, t0d), t2)
    return [add(t3, t5), t5, add(t2, t4), t4]


def _limbs(n):
    """The kernel's limbs of a 64-bit nonce."""
    return n & ((1 << 22) - 1), (n >> 22) & ((1 << 21) - 1), (n >> 43) & ((1 << 21) - 1)


def _first_layer(add, n, tail, inv):
    """csrc/poseidon2_grind.cu `first_layer` on the kernel's limbs of n."""
    l0, l1, l2 = _limbs(n)
    t0, t2 = add(l0, l1), add(add(l1, l1), l2)
    t1d, t0d = add(l2, l2), add(t0, t0)
    t4, t5 = add(add(t1d, t1d), t0), add(add(t0d, t0d), t2)
    b = [add(t0, t5), t5, add(t2, t4), t4]
    s = [0] * 16
    for pos in range(4):
        total = add(b[pos], inv[pos])
        s[pos], s[4 + pos] = add(b[pos], total), total
        s[8 + pos], s[12 + pos] = add(tail[pos], total), add(tail[4 + pos], total)
    return s


def _invariants(digest):
    add = _Adds()
    tail = _m4(add, *map(int, digest[:4])) + _m4(add, *map(int, digest[4:]))
    return tail, [add(tail[pos], tail[4 + pos]) for pos in range(4)]


def _m4_word0(add, x0, x1, x2, x3):
    """_m4's first output alone (t4 and its doubling are dead)."""
    t0, t1 = add(x0, x1), add(x2, x3)
    t2, t3 = add(add(x1, x1), t1), add(add(x3, x3), t0)
    t0d = add(t0, t0)
    return add(t3, add(add(t0d, t0d), t2))


def _word8(add, x):
    """Word 8 of mds16(x), as the compiler keeps it when only word 8 is read:
    each block's position-0 output, their sum, and block 2's output."""
    t = [_m4_word0(add, *x[4 * g:4 * g + 4]) for g in range(4)]
    return add(t[2], add(add(t[0], t[1]), add(t[2], t[3])))


NONCES = [0, 1, 5, (1 << 22) - 1, 1 << 22, (1 << 43) - 1, 1 << 43, 2**32 - 1, 2**32, 2**64 - 1,
          0x123456789ABCDEF0]
DIGESTS = {"seeded": np.random.default_rng(7).integers(0, P, 8), "p - 1": np.full(8, P - 1), "zero": np.zeros(8)}


@pytest.mark.parametrize("digest", list(DIGESTS))
def test_grind_first_layer_is_mds16(digest):
    """The kernel's initial layer (27 adds a nonce, the digest's M4s and
    their sums once a thread) equals mds16 of the absorbed state, the port's
    and the JAX package's, at every limb's edges and the largest nonce."""
    words = DIGESTS[digest].astype(np.int64)
    tail, inv = _invariants(words)
    for n in NONCES:
        add = _Adds()
        got = _first_layer(add, n, tail, inv)
        assert add.n == 27
        state = np.concatenate([_limbs(n), np.zeros(5, np.int64), words])
        assert got == t_p2.mds16(torch.from_numpy(state)).tolist()
        assert got == r_p2.mds16(state.astype(np.uint32)).astype(np.int64).tolist()


def test_grind_last_layer_word8_is_mds16s():
    """Word 8 of the final mds16 from its position-0 outputs takes 44 adds,
    and is mds16's word 8, on random and edge states."""
    rng = np.random.default_rng(3)
    states = [rng.integers(0, P, 16) for _ in range(20)] + [np.full(16, P - 1), np.zeros(16, np.int64)]
    for x in states:
        add = _Adds()
        assert _word8(add, [int(v) for v in x]) == int(t_p2.mds16(torch.from_numpy(x.astype(np.int64)))[8])
        assert add.n == 44


def test_grind_ops_per_nonce_count_the_kernel():
    """GRIND_INT_OPS_PER_NONCE is a permutation's count less the adds the two
    replayed layers save, plus the limbs and the mask: 7,191."""
    first, last = _Adds(), _Adds()
    tail, inv = _invariants(np.arange(8))
    _first_layer(first, 12345, tail, inv)
    _word8(last, list(range(16)))
    saved = (84 - first.n) * 3 + (84 - last.n) * 3
    assert poseidon_cuda.GRIND_INT_OPS_PER_NONCE == poseidon_cuda.INT_OPS_PER_PERMUTATION - saved + 5 + 1 == 7_191


def test_grind_bound_ms():
    """GRIND_INT_OPS_PER_NONCE a nonce: 2**28 nonces in 57.701 ms."""
    assert poseidon_cuda.grind_bound_ms(1 << 28) == pytest.approx(57.701, abs=1e-3)
    assert poseidon_cuda.grind_bound_ms(3) == pytest.approx(3 * poseidon_cuda.grind_bound_ms(1))


# (start, seed): the seeded digest's 6-bit nonce from each start lies 96, 42
# and 88 past it, across 2**22, 2**43 and 2**32
LIMB_EDGES = {"0": (0, 0), "across 2**22": ((1 << 22) - 40, 4), "across 2**43": ((1 << 43) - 40, 1),
              "across 2**32": (2**32 - 40, 1)}


@pytest.mark.parametrize("case", list(LIMB_EDGES))
def test_kernel_limbs_find_the_native_nonce(case):
    """A scan over states built from the kernel's limbs, permuted, finds the
    native scan's nonce from starts just below 2**22, 2**43 and 2**32, where
    the answer lies across a limb or word boundary."""
    start, seed = LIMB_EDGES[case]
    digest = np.random.default_rng(seed).integers(0, P, 8).astype(np.uint32)
    bits = 6
    want = native.grind(digest, bits, start)
    n = np.arange(start, start + 256, dtype=np.uint64)
    states = np.zeros((256, 16), np.int64)
    states[:, :3] = np.stack([_limbs(int(v)) for v in n])
    states[:, 8:] = digest
    hits = np.nonzero((t_p2.permute_plain(torch.from_numpy(states))[:, 8] & ((1 << bits) - 1)).numpy() == 0)[0]
    assert start + int(hits[0]) == want
    assert start == 0 or want >= start + 40
