"""Tile geometry of the circle and line domains: their points a tile at a time.

Twin of the tile tables of recursive_stwo_tpu/prover/stream.py:89-162.  A
domain of 2**T points in bit-reversed order splits into 2**(T-b) aligned
tiles of 2**b: a position p = j * 2**b + r has br_T(p) = br_b(r) * 2**(T-b)
+ br_{T-b}(j), so every tile's points are one table of 2**b points
(`circle_tile_table`, `line_tile_table`) rotated by the tile's base point
(`circle_tile_bases`, `line_tile_bases`), and circle domains conjugate the
odd r (`odd_mask`).  The host tables are numpy, lru-cached, and only 2**b
and 2**(T-b) long, so a domain of 2**27 needs no host table of its size;
`tile_points` rotates them on the device in eager torch on core/m31.py.
The streamed prover evaluates its columns on these tiles (prover/stream.py;
on CUDA the tile kernel and the quotient kernel take a chunk's tiles as a
`TilePoints` and rotate the table themselves) and the FRI folds take their
1/y and 1/x from them (prover/fri.py; on CUDA the fold-layer kernel reads a
domain's bases and even table points, ops/fri_fold_cuda.point_table).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core import circle_host as ccircle
from ..core import m31
from .arrays import to_device

ORDER = 1 << 31


@lru_cache(maxsize=None)
def circle_tile_table(T: int, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """(tx, ty) uint32 (2^b,): tile-local points (pre-conjugation)."""
    dom = ccircle.CanonicCoset(T).circle_domain()
    S = dom.half_coset.step_index
    brr = ccircle.bit_reverse_indices(b)
    half = 1 << (b - 1)
    local = np.where(brr < half, brr, brr - half).astype(np.uint64)
    step = np.uint64(((1 << (T - b)) * S) % ORDER)
    idx = (local * step) % np.uint64(ORDER)
    return ccircle.apoints_at_indices(idx)


@lru_cache(maxsize=None)
def circle_tile_bases(T: int, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """(bx, by) uint32 (2^(T-b),): base point of every tile."""
    dom = ccircle.CanonicCoset(T).circle_domain()
    I, S = dom.half_coset.initial_index, dom.half_coset.step_index
    j = ccircle.bit_reverse_indices(T - b).astype(np.uint64)
    idx = (np.uint64(I) + j * np.uint64(S)) % np.uint64(ORDER)
    return ccircle.apoints_at_indices(idx)


@lru_cache(maxsize=None)
def line_tile_table(T: int, b: int) -> Tuple[np.ndarray, np.ndarray]:
    """Tile table for the half_odds(T) coset (line-fold domains, no
    conjugation; fri_host.line_fold_xinv indexing)."""
    coset = ccircle.Coset.half_odds(T)
    brr = ccircle.bit_reverse_indices(b).astype(np.uint64)
    step = np.uint64(((1 << (T - b)) * coset.step_index) % ORDER)
    idx = (brr * step) % np.uint64(ORDER)
    return ccircle.apoints_at_indices(idx)


@lru_cache(maxsize=None)
def line_tile_bases(T: int, b: int) -> Tuple[np.ndarray, np.ndarray]:
    coset = ccircle.Coset.half_odds(T)
    j = ccircle.bit_reverse_indices(T - b).astype(np.uint64)
    idx = (np.uint64(coset.initial_index) + j * np.uint64(coset.step_index)) % np.uint64(ORDER)
    return ccircle.apoints_at_indices(idx)


@lru_cache(maxsize=None)
def odd_mask(b: int) -> np.ndarray:
    return (np.arange(1 << b) & 1).astype(bool)


@lru_cache(maxsize=None)
def tile_consts(T: int, b: int, line: bool, device: torch.device):
    """A tile table on `device`: (tx, ty, odd mask or None for line cosets)."""
    tx, ty = (line_tile_table if line else circle_tile_table)(T, b)
    odd = None if line else torch.from_numpy(odd_mask(b)).to(device)
    return to_device(tx, device), to_device(ty, device), odd


def tile_bases(T: int, b: int, t0: int, t1: int, line: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Base points of tiles [t0, t1) on `device`."""
    bx, by = (line_tile_bases if line else circle_tile_bases)(T, b)
    return to_device(bx[t0:t1], device), to_device(by[t0:t1], device)


def tile_points(bx, by, tx, ty, conj):
    """Rotate the tile table by per-tile base points: bx/by (G,), tx/ty
    (2^b,) -> (cx, cy) each (G, 2^b); `conj` is the odd mask for circle
    domains (None for line cosets)."""
    cx = m31.sub(m31.mul(bx[:, None], tx[None, :]), m31.mul(by[:, None], ty[None, :]))
    cy = m31.add(m31.mul(bx[:, None], ty[None, :]), m31.mul(by[:, None], tx[None, :]))
    if conj is not None:
        cy = torch.where(conj[None, :], m31.neg(cy), cy)
    return cx, cy


class TilePoints(NamedTuple):
    """Tiles [t0, t1) of a 2**T circle domain in tiles of 2**b: each tile's
    base point (bx, by) (G,), the tile table (tx, ty) (2**b,) and its odd
    mask, on one device."""

    bx: torch.Tensor
    by: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    odd: torch.Tensor
    b: int

    def points(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cx, cy), each (G, 2**b)."""
        return tile_points(self.bx, self.by, self.tx, self.ty, self.odd)


def circle_tiles(T: int, b: int, t0: int, t1: int, device) -> TilePoints:
    """The TilePoints of tiles [t0, t1) of the 2**T circle domain."""
    device = torch.device(device)
    tx, ty, odd = tile_consts(T, b, False, device)
    return TilePoints(*tile_bases(T, b, t0, t1, False, device), tx, ty, odd, b)
