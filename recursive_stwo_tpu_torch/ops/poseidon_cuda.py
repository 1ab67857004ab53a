"""ctypes wrappers of the Poseidon2-16 CUDA kernels (csrc/poseidon2.cu).

  permute_rows       (N, 16) int64 -> (N, 16); twin of the Pallas kernel K1
                     (recursive_stwo_tpu/ops/poseidon_pallas.py::_kernel)
  permute_wordmajor  (L, 16, N) int64 -> (L, 16, N); twin of the Pallas
                     kernel K2 (poseidon_pallas.py::_kernel4)
  wordmajor_scan     a whole pass of the hash phase's scan, K2 and the
                     jax.lax.scan around it (recursive_stwo_tpu/verifier/
                     hashplan.py:206,427), in one launch: an op table of
                     (lanes, steps) micro-ops, each one permutation, whose
                     inputs are read in place through descriptors
  p31_grind          the Poseidon31 channel's proof-of-work grind
                     (csrc/poseidon2_grind.cu): the smallest nonce n >= start
                     whose absorption leaves digest word 0 with `pow_bits`
                     low zero bits (prover/channel.py
                     `PoseidonChannel.grind_pow`), the nonce the native host
                     scan returns: one launch on the device's current stream
                     and one 8-byte read of the result, which waits for it

They take CUDA tensors of canonical M31 residues and raise on anything
else; the plain versions live in core/poseidon2.py, (for the scan)
verifier/hashplan.scan_plain and (for the grind) prover/channel.py
`grind_device`, K1 on 2**22 states a block.  A kernel launches on the
current stream of its tensor's device and does not synchronise.
`LAUNCHES` counts the launches of each kernel.

K1 has two schedules of one arithmetic (csrc/poseidon2.cu): "quad", four
lanes to a state, and "tile", one thread to a state with the block's rows
staged through shared memory.  `permute_rows` takes the quad schedule below
ROWS_TILE_MIN rows and the tile schedule from there up.  The scan runs one
thread to a slot, both carries in its registers.

The scan's op table is an int64 (lanes, steps, FIELDS) CPU tensor.  Per op:
F_FLAGS (A_IN, the 2-bit B selector at B_SEL_SHIFT, WRITE_B, START, SWAP,
ACTIVE), F_OUT (output slot or -1), and the descriptors of in_a (F_A) and
in_b (F_B): source index into the call's `sources` list (-1: none), element
offset, stride_n, stride_w, n_words: word w of slot n is the element
off + n*stride_n + w*stride_w from sources[src]'s first, and words at or
past n_words read as 0.  F_Q describes the query bits: source,
offset, stride_n, level.  A lane's program ends at its first op without
ACTIVE.  An op reads in_a if A_IN or B selects IN_A, in_b if B selects
IN_B, and the query bits if SWAP.  The wrapper checks that every descriptor
an op reads has a source and lies in its storage, then turns (source,
offset) into a device pointer.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.spans import span
from . import build

P = 2**31 - 1

LAUNCHES = {"permute_rows": 0, "permute_wordmajor": 0, "wordmajor_scan": 0, "p31_grind": 0}
ROWS_SCHEDULES = ("quad", "tile")

# the scan's op table (csrc/poseidon2.cu, wordmajor_scan_kernel)
FIELDS = 16
F_FLAGS, F_OUT, F_A, F_B, F_Q = 0, 1, 2, 7, 12
A_IN, WRITE_B, START, SWAP, ACTIVE = 1, 8, 16, 32, 64
B_SEL_SHIFT = 1
B_CARRY_B, B_IN_A, B_IN_B, B_CARRY_S = 0, 1, 2, 3
# the crossover, measured with tools/kernel_times.py on an H100 SXM (700 W):
# quad 8.3 / tile 11.2-11.6 us at 2**14 rows, quad 13.1-13.9 / tile 12.6 us
# at 2**15
ROWS_TILE_MIN = 1 << 15

# The least time an H100 SXM could take for n permutations, either kernel:
# the int32 operations of one permutation (csrc/poseidon2.cuh on m31.cuh:
# 1,360 modular adds at 3 operations (the sum, the sum less p, their
# minimum), 426 widening multiplies with their 2**31 fold at 6 (the product,
# the mask, the shift, the fold's sum, less p, the minimum), 210 rotations
# at 4) at 132 SMs x 128 lanes x 1.98 GHz, against 16 int64 words read and
# 16 written at 3.35 TB/s.
INT_OPS_PER_PERMUTATION = 1360 * 3 + 426 * 6 + 210 * 4
H100_INT_OPS_PER_S = 132 * 128 * 1.98e9
H100_BYTES_PER_S = 3.35e12
BYTES_PER_PERMUTATION = 2 * 16 * 8

# int32 operations of one nonce as csrc/poseidon2_grind.cu writes it, counted
# as INT_OPS_PER_PERMUTATION counts them, less what folds away: the initial
# mds16 at 27 modular adds (the digest's M4s hoisted, the zero words folded;
# 84 in mds16) and the final one at the 44 adds word 8 needs; plus the three
# limbs from the 64-bit nonce (an and, two shifts and two ands) and the hit
# test's mask.  tests/test_torch_p31_grind.py replays both layers to count them.
GRIND_INT_OPS_PER_NONCE = INT_OPS_PER_PERMUTATION - (84 - 27) * 3 - (84 - 44) * 3 + 5 + 1
_NO_HIT = 2**64 - 1  # a grind's result word until a nonce hits
_grind_state = {}  # device -> (2,) int64 tensor: a grind's chunk counter and result


def bound_ms(n_states: int) -> tuple:
    """(milliseconds, "operations" or "bytes"): the larger of the two floors
    for n_states permutations, and which one it is."""
    ops = n_states * INT_OPS_PER_PERMUTATION / H100_INT_OPS_PER_S
    mem = n_states * BYTES_PER_PERMUTATION / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")


def grind_bound_ms(nonces: int) -> float:
    """The least time of `nonces` nonces of the grind at GRIND_INT_OPS_PER_NONCE;
    the grind reads and writes nothing a nonce."""
    return nonces * GRIND_INT_OPS_PER_NONCE / H100_INT_OPS_PER_S * 1e3


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, ndim: int, words_dim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"expected torch.int64, got {x.dtype}")
    if x.dim() != ndim or x.shape[words_dim] != 16:
        raise ValueError(f"expected 16 words on dim {words_dim} of a {ndim}-D tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def permute_rows(x: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of each row of an (N, 16) CUDA tensor, whose
    data must be 16-byte aligned (any tensor that owns its storage is)."""
    return permute_rows_schedule(x, "quad" if x.shape[0] < ROWS_TILE_MIN else "tile")


def permute_rows_schedule(x: torch.Tensor, schedule: str) -> torch.Tensor:
    """permute_rows on the named schedule (the tests and the timing tools
    hold each schedule to the plain version and time it)."""
    if schedule not in ROWS_SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}, expected one of {ROWS_SCHEDULES}")
    _check(x, 2, 1)
    if x.data_ptr() % 16:
        raise ValueError("permute_rows reads 16-byte vectors: the data must be 16-byte aligned")
    out = torch.empty_like(x)
    fn = getattr(build.load(), f"p2_permute_rows_{schedule}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], stream)
    _raise_on(err, "permute_rows")
    if x.shape[0]:
        LAUNCHES["permute_rows"] += 1
    return out


def permute_wordmajor(x: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of the (L, N) states of an (L, 16, N) CUDA tensor."""
    _check(x, 3, 1)
    out = torch.empty_like(x)
    lib = build.load()
    n_lanes, _, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.p2_permute_wordmajor(x.data_ptr(), out.data_ptr(), n_lanes, n, stream)
    _raise_on(err, "permute_wordmajor")
    if n_lanes * n:
        LAUNCHES["permute_wordmajor"] += 1
    return out


def scan_permutations(ops: torch.Tensor, n: int) -> int:
    """Permutations a scan of op table `ops` over n slots computes."""
    return int(((ops[..., F_FLAGS] & ACTIVE) != 0).sum()) * n


def _resolve(ops: torch.Tensor, sources: list, n_out: int, n: int) -> torch.Tensor:
    """The op table with each descriptor's (source, offset) turned into a
    pointer, after checking that every descriptor an op reads has a source,
    that every slot's words lie in the source's storage and every output
    slot in the table (numpy: a few dozen small array operations, cheaper on
    the host than torch's)."""
    table = ops.numpy().copy()
    base = np.array([s.data_ptr() for s in sources], dtype=np.int64)
    room = np.array([s.untyped_storage().nbytes() // 8 - s.storage_offset() for s in sources],
                    dtype=np.int64)
    flags = table[..., F_FLAGS]
    active = (flags & ACTIVE) != 0
    if (active & (table[..., F_OUT] >= n_out)).any():
        raise ValueError(f"an op writes past the {n_out} output slots")
    b_sel = (flags >> B_SEL_SHIFT) & 3
    reads = {F_A: ((flags & A_IN) != 0) | (b_sel == B_IN_A), F_B: b_sel == B_IN_B, F_Q: (flags & SWAP) != 0}
    for f, read in reads.items():
        src, off, sn = table[..., f], table[..., f + 1], table[..., f + 2]
        used = active & (src >= 0)
        idx = src.clip(0, len(sources) - 1)
        if f == F_Q:
            last = off + (n - 1) * sn
            level = table[..., f + 3]
            bad = (sn < 0) | (level < 0) | (level > 62)
        else:
            sw, nw = table[..., f + 3], table[..., f + 4]
            last = off + (n - 1) * sn + (nw - 1).clip(min=0) * sw
            bad = (sn < 0) | (sw < 0) | (nw < 0) | (nw > 8)
            read = read & (nw > 0)
        if (active & read & (src < 0)).any():
            raise ValueError("an op reads a scan descriptor that has no source")
        bad = used & (bad | (src >= len(sources)) | (off < 0) | (last >= room[idx]))
        if bad.any():
            raise ValueError("a scan descriptor reads outside its source tensor")
        table[..., f] = np.where(used, base[idx] + 8 * off, 0)
    return torch.from_numpy(table)


def wordmajor_scan(ops: torch.Tensor, sources: list, n_out: int, n: int,
                   keep_capacity: bool) -> torch.Tensor:
    """Run a scan pass on the card: returns the (n_out, 8, n) int64 table of
    output digests (zero where no op writes).  `ops` is the CPU op table,
    `sources` the CUDA int64 tensors its descriptors read; the rate half of
    each permutation is kept (walks), or the capacity half (absorb)."""
    if ops.device.type != "cpu" or ops.dtype != torch.int64 or ops.dim() != 3 or ops.shape[2] != FIELDS:
        raise ValueError(f"expected an int64 (lanes, steps, {FIELDS}) op table on the CPU")
    if not sources:
        raise ValueError("expected at least one source tensor")
    dev = sources[0].device
    for s in sources:
        if s.device != dev or dev.type != "cuda":
            raise ValueError(f"every source must lie on one CUDA device, got {s.device} and {dev}")
        if s.dtype != torch.int64:
            raise TypeError(f"expected torch.int64 sources, got {s.dtype}")
    lanes, steps, _ = ops.shape
    table = _resolve(ops, sources, n_out, n).pin_memory().to(dev, non_blocking=True)
    out = torch.zeros((n_out, 8, n), dtype=torch.int64, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.p2_wordmajor_scan(table.data_ptr(), lanes, steps, n, int(keep_capacity), out.data_ptr(), stream)
    _raise_on(err, "wordmajor_scan")
    if lanes * steps * n:
        LAUNCHES["wordmajor_scan"] += 1
    return out


def p31_grind(digest_words, pow_bits: int, start: int = 0, device="cuda") -> int:
    """The smallest nonce n >= start whose absorption, the state (n mod 2**22,
    n >> 22 mod 2**21, n >> 43 mod 2**21, 0 x 5, digest) permuted, leaves word
    8 with `pow_bits` low zero bits.  digest_words: the channel digest's 8
    words in [0, p); 1 <= pow_bits <= 31; 0 <= start < 2**64; device: a CUDA
    device.  Nonces up to 2**64 - 2 are scanned; raises if none of them hits."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the grind kernel runs on a CUDA device, got {device}")
    if not 1 <= pow_bits <= 31:
        raise ValueError(f"pow_bits {pow_bits} outside [1, 31]")
    words = [int(w) for w in np.asarray(digest_words).reshape(-1)]
    if len(words) != 8 or not all(0 <= w < P for w in words):
        raise ValueError(f"expected a digest of 8 words in [0, {P}), got {words}")
    if not 0 <= start < 2**64:
        raise ValueError(f"start {start} outside [0, 2**64)")
    return grind(LAUNCHES, "p31_grind", "p2_grind", words, pow_bits, start, device)


def grind(launches: dict, name: str, symbol: str, words: list, pow_bits: int, start: int, device) -> int:
    """One launch of a grind kernel with the C interface of csrc/*_grind.cu
    (`symbol`: 8 digest words, the mask, the start, the 2-word state, the
    stream) on `device`'s current stream, counted in launches[name], and one
    read of its result; raises if no nonce hit.  The caller checks the
    arguments."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    lib = build.load()
    state = _grind_state.get(device)
    if state is None:
        state = _grind_state[device] = torch.empty(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, symbol)((ctypes.c_uint32 * 8)(*words), (1 << pow_bits) - 1, start, state.data_ptr(), stream)
    _raise_on(err, name)
    launches[name] += 1
    with span("to_host"):
        nonce = state[1].item() % 2**64
    if nonce == _NO_HIT:
        raise RuntimeError(f"no nonce in [{start}, 2**64 - 1) leaves {pow_bits} zero bits")
    return nonce
