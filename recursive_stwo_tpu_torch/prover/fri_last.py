"""The FRI last layer on the layer's device: its coefficients and the degree check.

`last_layer_poly(g, level, bound)` gives what prover/fri.py computed on the
host from the copy: the coefficients of `fri_host.line_interpolate(g, level)`
at positions `arange(2**bound) << (level - bound)`, a (2**bound, 4) uint32
array in the verifier's basis order, and raises ValueError when any other
coefficient is nonzero.  On CUDA it is one launch of the last-layer kernel
(ops/fri_fold_cuda.py `last_layer`) and one copy of the kept coefficients and
the counts back; on the CPU the plain version, `last_layer_poly_plain` (eager
torch on core/m31.py).  Nothing falls back.

The copy's interpolation takes round L's pairs (p, p + 2**L), bit L of p
clear, to ((a + b) / 2, (a - b) t / 2), t the inverse x of the point at
bit-reversed position 2 i 2**L of half_odds(level), i = p >> (L + 1),
doubled L times.  L doublings map half_odds(level) onto half_odds(level - L)
and bit-reversed position 2 i 2**L onto 2 i, so round L's twiddles are
`fri_host.line_fold_xinv(level - L)`: 1/x at the even bit-reversed positions
of half_odds(level - L), the folds' own inverses, vectorised through
`apoints_at_indices` (inv(0) = 0 as `m31_host.inv` gives it).  The halvings
are one product by 2**-level at the end (field arithmetic is exact).  After
the last round coefficient p of this layered order is the copy's coefficient
br_level(p), so its kept ones are p < 2**bound, at row br_bound(p).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core import circle_host, m31
from ..ops import fri_fold_cuda
from . import fri_host as host_fri
from .arrays import to_device, to_numpy

DEGREE_ERROR = "folded evaluations exceed the last-layer degree bound"


@lru_cache(maxsize=None)
def twiddles(level: int, device) -> torch.Tensor:
    """(2**level - 1,) int64 on `device`: round L's 2**(level - L - 1)
    inverses at offset 2**level - 2**(level - L)."""
    return to_device(np.concatenate([host_fri.line_fold_xinv(level - L) for L in range(level)]), device)


def interpolate_plain(g: torch.Tensor, level: int) -> torch.Tensor:
    """(4, 2**level) coefficients in the layered order (see the module
    docstring) of the (4, 2**level) line evaluations g."""
    n = 1 << level
    tw = twiddles(level, g.device)
    v = g
    for L in range(level):
        groups = n >> (L + 1)
        pairs = v.reshape(4, groups, 2, 1 << L)
        a, b = pairs[:, :, 0], pairs[:, :, 1]
        t = tw[n - (n >> L) : n - (n >> L) + groups].reshape(groups, 1)
        v = torch.stack([m31.add(a, b), m31.mul(m31.sub(a, b), t)], dim=2).reshape(4, n)
    return m31.mul(v, pow(2, -level, m31.P))


def last_layer_poly_plain(g: torch.Tensor, level: int, bound: int) -> np.ndarray:
    """The plain version of `last_layer_poly`."""
    v = interpolate_plain(g, level)
    if v[:, 1 << bound :].any():
        raise ValueError(DEGREE_ERROR)
    rows = torch.as_tensor(circle_host.bit_reverse_indices(bound), device=v.device)
    return to_numpy(v[:, rows].T)


def last_layer_poly(g: torch.Tensor, level: int, bound: int) -> np.ndarray:
    """(2**bound, 4) uint32: the last layer's kept coefficients of the
    (4, 2**level) folded layer g (see the module docstring); raises
    ValueError when the layer exceeds the degree bound."""
    if not 0 <= bound <= level or level < 1:
        raise ValueError(f"expected 0 <= bound <= level and level >= 1, got level {level}, bound {bound}")
    if g.device.type == "cpu":
        return last_layer_poly_plain(g, level, bound)
    words = to_numpy(fri_fold_cuda.last_layer(g, twiddles(level, g.device), level, bound))
    if words[4 << bound :].any():
        raise ValueError(DEGREE_ERROR)
    return words[: 4 << bound].reshape(1 << bound, 4)
