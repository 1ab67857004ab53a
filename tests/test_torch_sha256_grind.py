"""The SHA-256 channel's proof-of-work grind on the CPU: where
`prover/prove_sha256.py::Sha256ProverChannel.grind_pow` sends it, the limits of
its kernel's wrapper (`ops/sha256_cuda.py::sha256_grind`), and the kernel's
constants and arithmetic (`csrc/sha256_grind.cu`, read from the source) against
hashlib.  The kernel itself runs in tests/test_torch_cuda.py, on a card.

    python -m pytest tests/test_torch_sha256_grind.py -q
"""

import hashlib
import os
import re
import struct

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.prover.prove_sha256 import Sha256ProverChannel as RChannel
from recursive_stwo_tpu_torch.core import sha256 as t_sha
from recursive_stwo_tpu_torch.ops import build, sha256_cuda
from recursive_stwo_tpu_torch.prover.commit import Sha256DeviceTree
from recursive_stwo_tpu_torch.prover.prove import flavour
from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel
from recursive_stwo_tpu_torch.prover.stream import _stream_flavour
from recursive_stwo_tpu_torch.utils import native

SOURCE = os.path.join(build.CSRC_DIR, "sha256_grind.cu")
M32 = 2**32


def _mixed(make, seed):
    ch = make()
    ch.mix_root(np.random.default_rng(seed).integers(0, M32, 8, dtype=np.uint64).astype(np.uint32))
    ch.mix_one_felt([seed, 1, 2, 3])
    return ch


def _digest_words(ch):
    return np.frombuffer(ch.ch.digest, ">u4").astype(np.uint32)


def _no_kernel(*args, **kwargs):
    raise AssertionError("the grind kernel's wrapper was called")


def _on(device):
    """A mixed channel as a prover on `device` leaves it (None: no prover)."""
    ch = Sha256ProverChannel()
    if device is not None:
        ch, _ = flavour(ch, Sha256DeviceTree, torch.device(device))
    return ch


@pytest.mark.parametrize("pow_bits", [8, 16, 22])
@pytest.mark.parametrize("device", [None, "cpu"])
def test_channel_grinds_on_the_host_without_cuda(monkeypatch, device, pow_bits):
    """A channel no prover set, or one of a prover on the CPU, grinds on the
    host even where CUDA is available: native's nonce, the JAX package's
    channel's, and one that passes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(sha256_cuda, "sha256_grind", _no_kernel)
    ch = _mixed(lambda: _on(device), pow_bits)
    nonce = ch.grind_pow(pow_bits)
    assert nonce == native.sha256_grind(_digest_words(ch), pow_bits)
    assert nonce == _mixed(RChannel, pow_bits).grind_pow(pow_bits)
    assert ch.ch.verify_pow_nonce(pow_bits, nonce)


def test_channel_grinds_zero_bits_on_the_host(monkeypatch):
    """At 0 bits, outside the kernel's limits, a CUDA prover's channel
    returns the first nonce from the host."""
    monkeypatch.setattr(sha256_cuda, "sha256_grind", _no_kernel)
    ch = _mixed(lambda: _on("cuda"), 0)
    assert ch.grind_pow(0) == 0


@pytest.mark.parametrize("pow_bits", [1, 22, 32])
@pytest.mark.parametrize("device", ["cuda", "cuda:0", "cuda:1"])
def test_channel_calls_the_kernel_on_its_provers_cuda_device(monkeypatch, device, pow_bits):
    """On a CUDA prover's channel the grind, at any bits, is one call of the
    kernel's wrapper with the channel's digest words and the prover's
    device, and its nonce is the channel's."""
    calls = []

    def fake(digest_words, bits, start=0, device="cuda"):
        calls.append((list(digest_words), bits, start, device))
        return 123_456_789

    monkeypatch.setattr(sha256_cuda, "sha256_grind", fake)
    ch = _mixed(lambda: _on(device), pow_bits)
    assert ch.grind_pow(pow_bits) == 123_456_789
    assert calls == [(list(_digest_words(ch)), pow_bits, 0, torch.device(device))]


@pytest.mark.parametrize("device", ["cpu", "cuda:1"])
@pytest.mark.parametrize("pick", [flavour, _stream_flavour], ids=["flavour", "stream_flavour"])
def test_flavours_set_the_grind_device(pick, device):
    """The resident and the streamed provers' flavour picks set the SHA-256
    channel's grind device to the prover's."""
    ch, _ = pick(Sha256ProverChannel(), Sha256DeviceTree, torch.device(device))
    assert ch.device == torch.device(device)


@pytest.mark.parametrize("prover", ["prove", "prove_np"])
def test_cpu_proof_grinds_on_the_cpu(monkeypatch, prover):
    """A SHA-256 proof with device='cpu' sets its channel to grind on the
    host, once, and never calls the kernel's wrapper."""
    from test_torch_chain import T_NP_CONFIG, _np_trace

    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.prover.prove import prove
    from recursive_stwo_tpu_torch.prover.prove_np import prove_np

    seen = []
    grind_pow = Sha256ProverChannel.grind_pow

    def spy(self, pow_bits, **kwargs):
        seen.append(self.device)
        return grind_pow(self, pow_bits, **kwargs)

    monkeypatch.setattr(Sha256ProverChannel, "grind_pow", spy)
    monkeypatch.setattr(sha256_cuda, "sha256_grind", _no_kernel)
    trace, config, fn = {"prove": (flagship.demo_trace(), flagship.DEMO_CONFIG, prove),
                         "prove_np": (_np_trace(), T_NP_CONFIG, prove_np)}[prover]
    fn(trace, config, device="cpu", channel=Sha256ProverChannel(), tree_cls=Sha256DeviceTree)
    assert seen == [torch.device("cpu")]


LIMITS = {
    "pow_bits 0": dict(pow_bits=0),
    "pow_bits 33": dict(pow_bits=33),
    "7 words": dict(digest_words=np.arange(7, dtype=np.uint32)),
    "9 words": dict(digest_words=np.arange(9, dtype=np.uint32)),
    "a word of 2**32": dict(digest_words=[0] * 7 + [M32]),
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
    args = dict(digest_words=np.arange(8, dtype=np.uint32), pow_bits=24, start=0, device="cuda:0")
    args.update(LIMITS[case])
    with pytest.raises(ValueError):
        sha256_cuda.sha256_grind(**args)


def _table(name):
    body = re.search(rf"__constant__ uint32_t {name}\[(\d+)\] = \{{(.*?)\}};", open(SOURCE).read(), re.S)
    words = [int(w, 16) for w in re.findall(r"0x[0-9A-Fa-f]+", body.group(2))]
    assert len(words) == int(body.group(1))
    return words


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) % M32


def _pad_schedule():
    w = [0x80000000] + [0] * 14 + [512]
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> 3)
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) % M32)
    return w


def test_grind_kernel_constants():
    """The kernel's round constants and initial state are SHA-256's, and
    kPadKW[i] is K[i] plus the padding block's schedule word W[i]."""
    k, h0 = [int(x) for x in t_sha._K], [int(x) for x in t_sha._H0]
    assert _table("kRound") == k
    assert _table("kInit") == h0
    assert _table("kPadKW") == [(ki + wi) % M32 for ki, wi in zip(k, _pad_schedule())]


def _round(s, kw):
    a, b, c, d, e, f, g, h = s
    t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ (~e & g)) + kw) % M32
    t2 = (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))
    return [(t1 + t2) % M32, a, b, c, (d + t1) % M32, e, f, g]


def _kernel_word0(n, digest):
    """Word 0 of the nonce's new digest as the kernel computes it: the first
    block with its schedule grouped as in first_block, the second on
    kPadKW, its last round `a` alone."""
    k, pad_kw, init = _table("kRound"), _table("kPadKW"), _table("kInit")
    bswap = lambda x: int.from_bytes(x.to_bytes(4, "little"), "big")  # noqa: E731
    w = [bswap(n % M32), bswap(n >> 32)] + [0] * 6 + list(digest)
    s = list(init)
    for i in range(64):
        if i >= 16:
            s1 = _rotr(w[(i - 2) & 15], 17) ^ _rotr(w[(i - 2) & 15], 19) ^ (w[(i - 2) & 15] >> 10)
            s0 = _rotr(w[(i - 15) & 15], 7) ^ _rotr(w[(i - 15) & 15], 18) ^ (w[(i - 15) & 15] >> 3)
            w[i & 15] = ((s1 + w[(i - 7) & 15]) + (s0 + w[i & 15])) % M32
        s = _round(s, (k[i] + w[i & 15]) % M32)
    h = [(x + y) % M32 for x, y in zip(init, s)]
    s = list(h)
    for i in range(63):
        s = _round(s, pad_kw[i])
    a, b, c, _, e, f, g, hh = s
    t1 = hh + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ (~e & g)) + pad_kw[63]
    return (h[0] + t1 + (_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))) % M32


@pytest.mark.parametrize("n", [0, 1, 164_897_690, M32 - 1, M32, 2**40 + 5, 2**64 - 2])
def test_grind_kernel_arithmetic_matches_hashlib(n):
    """The kernel's nonce arithmetic (message words, both blocks, the hit
    test) on the source's constants gives hashlib's digest word and the
    channel's trailing zeros, across the high word's carry."""
    digest = np.random.default_rng(n % 1000).integers(0, M32, 8, dtype=np.uint64).astype(np.uint32)
    new = hashlib.sha256(struct.pack("<Q", n) + bytes(24) + digest.astype(">u4").tobytes()).digest()
    word0 = _kernel_word0(n, [int(x) for x in digest])
    assert word0 == int.from_bytes(new[:4], "big")
    le = int.from_bytes(word0.to_bytes(4, "big"), "little")  # bswap, as the kernel's hit test reads it
    for bits in (1, 8, 28, 32):
        assert (le & ((1 << bits) - 1) == 0) == (int.from_bytes(new[:16], "little") % 2**bits == 0)


class _Ops:
    """A value of the kernel's nonce loop that counts the int32 operations it
    takes: "c" a constant, "d" a term of digest words alone (hoisted out of
    the loop), "n" a term of the nonce; an operation costs 1 when its
    result is a nonce's, as INT_OPS_PER_COMPRESSION counts them."""

    count = 0

    def __init__(self, kind):
        self.kind = kind

    @classmethod
    def op(cls, *args):
        kinds = {a.kind for a in args}
        kind = "n" if "n" in kinds else "d" if "d" in kinds else "c"
        cls.count += kind == "n"
        return cls(kind)

    __add__ = __xor__ = __and__ = lambda a, b: _Ops.op(a, b)  # noqa: E731
    __invert__ = lambda a: _Ops.op(a)  # noqa: E731

    def rotr(self, n):
        return _Ops.op(self)

    __rshift__ = rotr


def _count_nonce_ops():
    """Replay csrc/sha256_grind.cu's first_block, second_block_word0 and
    hit test on counting values; the int32 operations a nonce."""
    c = lambda: _Ops("c")  # noqa: E731
    big0 = lambda a: a.rotr(2) ^ a.rotr(13) ^ a.rotr(22)  # noqa: E731
    big1 = lambda e: e.rotr(6) ^ e.rotr(11) ^ e.rotr(25)  # noqa: E731
    ch = lambda e, f, g: (e & f) ^ (~e & g)  # noqa: E731
    maj = lambda a, b, c: (a & b) ^ (a & c) ^ (b & c)  # noqa: E731

    def rnd(s, kw):
        t1 = s[7] + big1(s[4]) + ch(s[4], s[5], s[6]) + kw
        return [t1 + (big0(s[0]) + maj(s[0], s[1], s[2])), s[0], s[1], s[2], s[3] + t1, s[4], s[5], s[6]]

    _Ops.count = 0
    n = _Ops("n")
    w = [_Ops.op(n), _Ops.op(n)] + [c() for _ in range(6)] + [_Ops("d") for _ in range(8)]  # two bswaps
    s = [c() for _ in range(8)]
    for i in range(64):
        if i >= 16:
            x, y = w[(i - 2) & 15], w[(i - 15) & 15]
            s1 = x.rotr(17) ^ x.rotr(19) ^ (x >> 10)
            s0 = y.rotr(7) ^ y.rotr(18) ^ (y >> 3)
            w[i & 15] = (s1 + w[(i - 7) & 15]) + (s0 + w[i & 15])
        s = rnd(s, c() + w[i & 15])
    h = [c() + x for x in s]
    s = list(h)
    for _ in range(63):
        s = rnd(s, c())
    t1 = s[7] + big1(s[4]) + ch(s[4], s[5], s[6]) + c()
    word0 = h[0] + t1 + big0(s[0]) + maj(s[0], s[1], s[2])
    _Ops.op(_Ops.op(word0), c())  # the hit test: bswap, mask
    return _Ops.count


def test_grind_ops_per_nonce_count_the_kernel():
    """GRIND_INT_OPS_PER_NONCE is the kernel's count, below two general
    compressions'."""
    assert sha256_cuda.GRIND_INT_OPS_PER_NONCE == _count_nonce_ops() == 3_768
    assert sha256_cuda.GRIND_INT_OPS_PER_NONCE < 2 * sha256_cuda.INT_OPS_PER_COMPRESSION


def test_grind_bound_ms():
    """GRIND_INT_OPS_PER_NONCE a nonce: 2**28 nonces in 30.234 ms."""
    assert sha256_cuda.grind_bound_ms(1 << 28) == pytest.approx(30.234, abs=1e-3)
    assert sha256_cuda.grind_bound_ms(3) == pytest.approx(3 * sha256_cuda.grind_bound_ms(1))
