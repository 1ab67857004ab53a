"""Poseidon2-16 permutation over M31 on int64 tensors.

Twin of recursive_stwo_tpu/core/poseidon2.py.  Round structure: initial
MDS16, 4 full rounds, 14 partial rounds, 4 full rounds, x**5 S-box; the
round constants are the host copy's arrays (poseidon2_host.py).

`permute_plain` is the plain PyTorch version.  `permute` (states on the last
axis) and `permute_wordmajor` ((L, 16, N) states, word-major) dispatch on the
tensor's device: a CPU tensor takes the plain version, a CUDA tensor launches
the hand-written kernel (ops/poseidon_cuda.py) or raises.
"""

from __future__ import annotations

import torch

from . import m31
from .poseidon2_host import (
    FIRST_FOUR_ROUND_RC,
    LAST_FOUR_ROUNDS_RC,
    MAT_DIAG16_M_1,
    PARTIAL_ROUNDS_RC,
)


def mds16(s: torch.Tensor) -> torch.Tensor:
    """circ(2*M4, M4, M4, M4) external matrix on (..., 16) state."""
    g = s.reshape(s.shape[:-1] + (4, 4))
    x0, x1, x2, x3 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    t0 = m31.add(x0, x1)
    t1 = m31.add(x2, x3)
    t2 = m31.add(m31.double(x1), t1)
    t3 = m31.add(m31.double(x3), t0)
    t4 = m31.add(m31.double(m31.double(t1)), t3)
    t5 = m31.add(m31.double(m31.double(t0)), t2)
    t = torch.stack([m31.add(t3, t5), t5, m31.add(t2, t4), t4], dim=-1)
    # out[g][pos] = 2 t[g][pos] + sum_{g' != g} t[g'][pos] = t[g][pos] + sums[pos]
    sums = t.sum(dim=-2, keepdim=True) % m31.P
    return m31.add(t, sums).reshape(s.shape)


def pow5(a):
    b = m31.mul(a, a)
    return m31.mul(m31.mul(b, b), a)


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of a (..., 16) int64 tensor (any device)."""
    dev = state.device
    diag = torch.as_tensor(MAT_DIAG16_M_1.astype("int64"), device=dev)
    first = torch.as_tensor(FIRST_FOUR_ROUND_RC.astype("int64"), device=dev)
    last = torch.as_tensor(LAST_FOUR_ROUNDS_RC.astype("int64"), device=dev)
    s = mds16(state)
    for r in range(4):
        s = mds16(pow5(m31.add(s, first[r])))
    for r in range(14):
        s0 = pow5(m31.add(s[..., :1], int(PARTIAL_ROUNDS_RC[r])))
        s = torch.cat([s0, s[..., 1:]], dim=-1)
        total = s.sum(dim=-1, keepdim=True) % m31.P
        s = m31.add(total, m31.mul(s, diag))
    for r in range(4):
        s = mds16(pow5(m31.add(s, last[r])))
    return s


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of (..., 16) states (kernel K1 on CUDA)."""
    if state.device.type == "cpu":
        return permute_plain(state)
    from ..ops import poseidon_cuda

    flat = state.reshape(-1, 16).contiguous()
    if flat.data_ptr() % 16:  # a view at an odd word: the kernel reads 16-byte vectors
        flat = flat.clone()
    return poseidon_cuda.permute_rows(flat).reshape(state.shape)


def permute_wordmajor_plain(state: torch.Tensor) -> torch.Tensor:
    """(L, 16, N) word-major states -> same layout, plain version."""
    return permute_plain(state.movedim(1, -1)).movedim(-1, 1)


def permute_wordmajor(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of (L, 16, N) word-major states (kernel K2 on CUDA)."""
    if state.device.type == "cpu":
        return permute_wordmajor_plain(state)
    from ..ops import poseidon_cuda

    return poseidon_cuda.permute_wordmajor(state.contiguous())
