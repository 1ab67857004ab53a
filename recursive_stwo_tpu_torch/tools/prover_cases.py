"""Cases that hold the provers' circle FFT and quotient kernels to their plain
versions at the chain's shapes, on seeded random canonical inputs.

The shapes are those of a committed chain proof (examples/data/<name>.pkl):
its spec gives every tree's column count at every LDE log size, so
`fft_cases` makes each interpolation, each LDE and the composition's
interpolation that proof's prover ran, `tile_cases` a streamed chunk of
each first-layer group (the group's coefficient blocks, one a tree, on the
tiles of chunk 0) and `quotient_case` a group's columns over its whole domain
(resident) or over a chunk (streamed, tile points).  The values are random:
the kernels compute field operations whatever the values, and the plain
versions are what they are held to.  Used by chip_smoke.py phase 3,
tools/kernel_times.py and tests/test_torch_cuda.py.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..models import flagship
from ..prover import circle_fft, quotients, stream
from ..prover.tiles import circle_tiles
from ..verifier.spec import NoPoseidonVerifierSpec, VerifierSpec

P = 2**31 - 1
STREAM_CHUNK_LOG = stream.CHUNK_LOG


def prover_spec(name: str):
    """The spec of the committed chain proof examples/data/<name>.pkl (the
    spec its prover ran): level1-5, level2-1, level14-1 or bitcoin_proof."""
    proof = flagship.load_artifact(os.path.join(_artifacts(), f"{name}.pkl"))
    if hasattr(proof, "log_size"):
        return NoPoseidonVerifierSpec.for_rows(proof.log_size, proof.config)
    return VerifierSpec.from_proof(proof)


def _artifacts() -> str:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "examples", "data")


def _rand(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(0, P, shape, generator=gen, device=device, dtype=torch.int64)


class FftCase(NamedTuple):
    label: str
    x: torch.Tensor  # evaluations to interpolate, or coefficients to extend
    log_out: int  # None: interpolate


def fft_cases(spec, device, seed: int = 0) -> list:
    """Each tree's base columns interpolated and extended to their LDE log
    size, and the composition's evaluations interpolated, at spec's
    shapes."""
    gen = torch.Generator(device=device).manual_seed(seed)
    blowup = spec.log_blowup_factor
    cases = []
    for t in range(3):
        for L, width in sorted(spec.n_columns_per_log_size[t].items()):
            base = L - blowup
            cases.append(FftCase(f"tree {t} interpolate ({width}, 2**{base})", _rand(gen, (width, 1 << base), device),
                                 None))
            cases.append(FftCase(f"tree {t} LDE ({width}, 2**{base}) to 2**{L}", _rand(gen, (width, 1 << base), device),
                                 L))
    bound = spec.composition_log_degree_bound
    cases.append(FftCase(f"composition interpolate (4, 2**{bound})", _rand(gen, (4, 1 << bound), device), None))
    for L, width in spec.n_columns_per_log_size[3].items():
        cases.append(FftCase(f"tree 3 LDE ({width}, 2**{L - blowup}) to 2**{L}",
                             _rand(gen, (width, 1 << (L - blowup)), device), L))
    return cases


def run_fft(case: FftCase, plain: bool = False) -> torch.Tensor:
    """The case on the kernel (or its plain version, on the same device)."""
    from ..ops import fft_cuda

    if case.log_out is None:
        return circle_fft.interpolate_plain(case.x) if plain else fft_cuda.interpolate(case.x)
    if plain:
        return circle_fft.evaluate_plain(circle_fft.extend(case.x, case.log_out))
    return fft_cuda.evaluate(case.x, case.log_out)


class TileCase(NamedTuple):
    label: str
    blocks: list  # coefficient blocks (width, 2**b), one a tree
    tiles: object  # prover/tiles.TilePoints


def tile_case(spec, g: int, device, seed: int = 0, chunk_log: int = STREAM_CHUNK_LOG, chunk: int = 0) -> TileCase:
    """Group g's coefficient blocks, one a tree of the group's log size, on
    the tiles of streamed chunk `chunk` (stream._streamed_group_evals')."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L = spec.all_log_sizes[g]
    b = L - spec.log_blowup_factor
    widths = [spec.n_columns_per_log_size[t].get(L, 0) for t in range(4)]
    blocks = [_rand(gen, (w, 1 << b), device) for w in widths if w]
    Cq = min(L, max(b, chunk_log))
    G = 1 << (Cq - b)
    return TileCase(f"group at 2**{L}, {sum(widths)} columns of 2**{b}, {G} tiles", blocks,
                    circle_tiles(L, b, chunk * G, (chunk + 1) * G, device))


def run_tiles(case: TileCase, plain: bool = False) -> torch.Tensor:
    from ..ops import fft_cuda

    if plain:
        coeffs = torch.cat(case.blocks)
        cx, cy = case.tiles.points()
        G = cx.shape[0]
        vals = stream._eval_tiles(coeffs, stream._tile_twiddles(cx, cy, case.tiles.b), case.tiles.b, G)
        return vals.reshape(coeffs.shape[0], G << case.tiles.b)
    t = case.tiles
    return fft_cuda.eval_tiles(case.blocks, t.bx, t.by, t.tx, t.ty)


class QuotientCase(NamedTuple):
    label: str
    spec: object
    g: int
    inputs: quotients.AnswerInputs
    blocks: list  # the group's columns' values at the points, one block a tree
    points: object  # (x, y) of the points, or a TilePoints


def quotient_case(spec, g: int, device, seed: int = 0, chunk_log=None) -> QuotientCase:
    """Group g's columns (random, one block a tree) over its whole domain
    with the domain's points, or with `chunk_log` over streamed chunk 0 with
    its tile points; random samples, OODS point and coefficient."""
    gen = torch.Generator(device=device).manual_seed(seed)
    L = spec.all_log_sizes[g]
    if chunk_log is None:
        points, n = circle_fft.domain_points(L, device), 1 << L
        label = f"group at 2**{L}, resident"
    else:
        b = L - spec.log_blowup_factor
        Cq = min(L, max(b, chunk_log))
        points, n = circle_tiles(L, b, 0, 1 << (Cq - b), device), 1 << Cq
        label = f"group at 2**{L}, a streamed chunk of 2**{Cq} in tiles of 2**{b}"
    widths = [spec.n_columns_per_log_size[t].get(L, 0) for t in range(4)]
    blocks = [_rand(gen, (w, n), device) for w in widths if w]
    rng = np.random.default_rng(seed)
    inputs = quotients.AnswerInputs(_rand(gen, (spec.total_samples, 4), device),
                                    tuple(int(v) for v in rng.integers(0, P, 8)),
                                    tuple(int(v) for v in rng.integers(0, P, 4)))
    return QuotientCase(f"{label}, {sum(widths)} columns", spec, g, inputs, blocks, points)


def run_quotients(case: QuotientCase, plain: bool = False) -> torch.Tensor:
    from ..ops import quotients_cuda

    if plain:
        points = case.points
        if not isinstance(points, tuple) or len(points) != 2:
            points = tuple(c.reshape(-1) for c in points.points())
        return quotients.group_answers_plain(case.spec, case.g, case.inputs, case.blocks, *points)
    i = case.inputs
    return quotients_cuda.quotients(case.spec, case.g, i.samples, i.oods, i.rc, case.blocks, case.points)


def n_chunks(spec, chunk_log: int = STREAM_CHUNK_LOG) -> int:
    """The streamed provers' first-layer chunks: one quotient call each."""
    out = 0
    for L in spec.all_log_sizes:
        b = L - spec.log_blowup_factor
        out += 1 << (L - min(L, max(b, chunk_log)))
    return out
