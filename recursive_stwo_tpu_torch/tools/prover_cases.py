"""Cases that hold the provers' circle FFT, quotient, sampling, interaction,
FRI fold-layer and Merkle level kernels to their plain versions at the
chain's shapes, on seeded random canonical inputs.

The shapes are those of a committed chain proof (examples/data/<name>.pkl):
its spec gives every tree's column count at every LDE log size, so
`fft_cases` makes each interpolation, each LDE and the composition's
interpolation that proof's prover ran, `tile_cases` a streamed chunk of
each first-layer group (the group's coefficient blocks, one a tree, on the
tiles of chunk 0) and `quotient_case` a group's columns over its whole domain
(resident) or over a chunk (streamed, tile points), `sample_case` every
coefficient block a proof samples and its points (one launch of the sampling
kernel), `interaction_cases` each AIR table's base-trace rows (one launch
of the interaction kernel a table), `fold_shapes` / `fold_case` each FRI
layer a proof folds (one fold-layer launch each), `merkle_case` a tree's
leaf level, whole or a streamed chunk of it as a view, and `last_layer_case`
a folded last layer within its degree bound (random kept coefficients) or
with planted coefficients past it.  The values are random: the kernels
compute field operations whatever the values, and the plain versions are
what they are held to.  Used by chip_smoke.py phase 3,
tools/kernel_times.py and tests/test_torch_{cuda,fri_last}.py.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..core import circle_host as ccircle
from ..core import m31
from ..core.qm31 import QM31
from ..cs import scalar
from ..models import flagship
from ..ops import composition_cuda
from ..prover import circle_fft, commit, fri, fri_last, interaction, quotients, sample, stream
from ..prover.prove_host import _add_const, _factors_at_point, _oods_point
from ..prover.tiles import circle_tiles
from ..verifier import composition as vcomp
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


class SampleCase(NamedTuple):
    label: str
    jobs: list  # (coefficients (C, 2**n), [factors (n, 4), ...]) of each block


def sample_case(spec, device, seed: int = 0) -> SampleCase:
    """Every block a proof of `spec` samples, as its prover hands them to
    `sample.samples_at`: each component's preprocessed, trace and
    interaction coefficients (the interaction blocks at the OODS point and
    at it shifted back one step of their trace domain) and the composition's
    8 split columns, random, at a random OODS point."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    oods = _oods_point(tuple(int(v) for v in rng.integers(0, P, 4)))
    if isinstance(spec, NoPoseidonVerifierSpec):
        logs = {"": (spec.log_size, 8, 12)}
    else:
        logs = {"plonk ": (spec.log_size_plonk, 10, 12), "poseidon ": (spec.log_size_poseidon, 40, 48)}
    jobs, labels = [], []
    for t in range(3):
        for name, (log, n_pre, n_tr) in logs.items():
            width = (n_pre, n_tr, 8)[t]
            points = [oods]
            if t == 2:
                points.append(_add_const(oods, ccircle.point_neg(ccircle.CanonicCoset(log).step())))
            jobs.append((_rand(gen, (width, 1 << log), device), [_factors_at_point(log, p) for p in points]))
            labels.append(f"{name}tree {t} ({width}, 2**{log}) at {len(points)} point{'s' * (len(points) > 1)}")
    log = spec.composition_log_degree_bound - 1
    jobs.append((_rand(gen, (8, 1 << log), device), [_factors_at_point(log, oods)]))
    labels.append(f"composition (8, 2**{log})")
    return SampleCase("; ".join(labels), jobs)


def run_sample(case: SampleCase, plain: bool = False) -> torch.Tensor:
    """The case's samples as the kernel lays them out, (rows, 4) int64: each
    job's columns at its first point, then at its second."""
    from ..ops import sample_cuda

    if not plain:
        return sample_cuda.sample_columns(case.jobs)[0]
    dev = case.jobs[0][0].device
    return torch.cat([torch.from_numpy(sample.sample(c, f).astype(np.int64)).to(dev)
                      for c, points in case.jobs for f in points])


class InteractionCase(NamedTuple):
    label: str
    evaluate_fn: object
    pre: torch.Tensor
    tr: torch.Tensor
    lookup: tuple  # (z, alpha), QM31s of python ints


def interaction_cases(spec, device, seed: int = 0, zero_row=None) -> list:
    """Each AIR table of a proof of `spec`, random rows at its log size,
    random z and alpha; `zero_row` plants a zero denominator there in the
    plonk or without-Poseidon table: z is its first relation's a_val +
    alpha a_wire, so its first batch's q is 0 (inv(0) = 0)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    if isinstance(spec, NoPoseidonVerifierSpec):
        tables = (("without-Poseidon", vcomp.evaluate_plonk_np, spec.log_size),)
    else:
        tables = (("plonk", vcomp.evaluate_plonk, spec.log_size_plonk),
                  ("poseidon", vcomp.evaluate_poseidon, spec.log_size_poseidon))
    out = []
    for name, fn, log in tables:
        n_pre, n_tr, _, _ = composition_cuda.AIR_SHAPES[composition_cuda.air_id(fn)]
        pre, tr = _rand(gen, (n_pre, 1 << log), device), _rand(gen, (n_tr, 1 << log), device)
        z, alpha = (tuple(int(v) for v in rng.integers(0, P, 4)) for _ in range(2))
        label = f"{name} table ({n_pre} + {n_tr} rows x 2**{log})"
        if zero_row is not None and fn is not vcomp.evaluate_poseidon:
            a_val = tuple(int(v) for v in tr[:4, zero_row].tolist())
            z = scalar.q_add(a_val, scalar.q_mul_m31(alpha, int(pre[0, zero_row])))
            label += f", a zero denominator at row {zero_row}"
        out.append(InteractionCase(label, fn, pre, tr, (QM31(*z), QM31(*alpha))))
    return out


def run_interaction(case: InteractionCase, plain: bool = False) -> torch.Tensor:
    """The case's batch rows (before the last column is closed): the kernel
    or its plain version."""
    from ..ops import interaction_cuda

    if plain:
        return interaction.interaction_rows_plain(case.pre, case.tr, case.lookup, case.evaluate_fn)
    return interaction_cuda.interaction_rows(composition_cuda.air_id(case.evaluate_fn), case.pre, case.tr,
                                             case.lookup)


def n_chunks(spec, chunk_log: int = STREAM_CHUNK_LOG) -> int:
    """The streamed provers' first-layer chunks: one quotient call each."""
    out = 0
    for L in spec.all_log_sizes:
        b = L - spec.log_blowup_factor
        out += 1 << (L - min(L, max(b, chunk_log)))
    return out


class FoldCase(NamedTuple):
    label: str
    g: object  # (4, 2**n) int64, or None
    join: object  # (4, 2**n) int64, or None
    alpha: QM31  # of python ints
    log_size: int


def fold_shapes(spec) -> list:
    """(log n, line, circle) of each fold-layer launch of a proof of `spec`,
    in prover/fri.py fri_tail's order: the largest group's circle fold, then
    each inner layer's line fold, with the next layer's joining group where
    there is one; spec.n_inner_layers + 1 in all."""
    M = spec.max_first_layer_log
    shapes = [(M, False, True)]
    for i in range(spec.n_inner_layers):
        level = M - 1 - i
        shapes.append((level, True, i + 1 < spec.n_inner_layers and level in spec.all_log_sizes))
    return shapes


def fold_case(log_size: int, line: bool, circle: bool, device, seed: int = 0) -> FoldCase:
    """A fold layer of 2**log_size random points: g (line), the join
    (circle), or both, and a random alpha."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    g = _rand(gen, (4, 1 << log_size), device) if line else None
    join = _rand(gen, (4, 1 << log_size), device) if circle else None
    alpha = QM31(*(int(v) for v in rng.integers(0, P, 4)))
    parts = [name for name, on in (("line", line), ("join", circle)) if on]
    return FoldCase(f"{' + '.join(parts)} of (4, 2**{log_size})", g, join, alpha, log_size)


def run_fold(case: FoldCase, plain: bool = False) -> torch.Tensor:
    """The case's next-layer accumulator: the kernel or its plain version."""
    from ..ops import fri_fold_cuda

    if plain:
        return fri.fold_layer_plain(case.g, case.join, case.alpha, case.log_size)
    return fri_fold_cuda.fold_layer(case.g, case.join, case.alpha, case.log_size)


class LastCase(NamedTuple):
    label: str
    g: torch.Tensor  # (4, 2**level) int64 line evaluations
    level: int
    bound: int


def last_layer_case(level: int, bound: int, device, seed: int = 0, planted=()) -> LastCase:
    """A folded last layer of 2**level points whose coefficients (fri_last's
    layered order) are random below 2**bound, random and nonzero at each
    position of `planted` (all >= 2**bound: past the degree bound) and zero
    elsewhere: the copy's interpolation rounds run backwards, a = f0 + x f1
    and b = f0 - x f1 with x the inverse of fri_last.twiddles' entry."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 1 << level
    v = torch.zeros((4, n), dtype=torch.int64, device=device)
    v[:, : 1 << bound] = _rand(gen, (4, 1 << bound), device)
    for p in planted:
        v[:, p] = 1 + torch.randint(0, P - 1, (4,), generator=gen, device=device, dtype=torch.int64)
    tw = fri_last.twiddles(level, v.device)
    for L in reversed(range(level)):
        groups = n >> (L + 1)
        pairs = v.reshape(4, groups, 2, 1 << L)
        x = m31.inv(tw[n - (n >> L) : n - (n >> L) + groups]).reshape(groups, 1)
        xf1 = m31.mul(pairs[:, :, 1], x)
        v = torch.stack([m31.add(pairs[:, :, 0], xf1), m31.sub(pairs[:, :, 0], xf1)], dim=2).reshape(4, n)
    past = f", {len(planted)} planted past it" if planted else ""
    return LastCase(f"last layer of (4, 2**{level}), bound {bound}{past}", v, level, bound)


def run_last(case: LastCase, plain: bool = False):
    """The last-layer kernel's output words (on the card), or the plain
    version's (2**bound, 4) kept coefficients."""
    from ..ops import fri_fold_cuda

    if plain:
        return fri_last.last_layer_poly_plain(case.g, case.level, case.bound)
    return fri_fold_cuda.last_layer(case.g, fri_last.twiddles(case.level, case.g.device), case.level, case.bound)


class MerkleCase(NamedTuple):
    label: str
    children: object  # (2n, 8) int64, or None at a leaf level
    cols: object  # (n_cols, n) int64 (a view where a chunk), or None
    n: int


def merkle_case(n_cols: int, log_size: int, device, seed: int = 0, node: bool = False, rows=None) -> MerkleCase:
    """A level of 2**log_size nodes with n_cols random columns (a leaf level,
    or a node level with random children); `rows` takes the level's first
    `rows` nodes only, the columns as a view of the whole level's, as a
    streamed tree hands a chunk."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 1 << log_size
    cols = _rand(gen, (n_cols, n), device)
    if rows is not None:
        cols, n = cols[:, :rows], rows
    children = _rand(gen, (2 * n, 8), device) if node else None
    where = f"the first {rows} rows of " if rows is not None else ""
    kind = "node" if node else "leaf"
    return MerkleCase(f"{kind} level, {where}{n_cols} columns of 2**{log_size}", children, cols, n)


def merkle_tree_case(spec, tree: int, device, seed: int = 0, rows=None) -> MerkleCase:
    """Tree `tree`'s leaf level of a proof of `spec`: its widest log size's
    columns (`merkle_case`)."""
    L = max(spec.n_columns_per_log_size[tree])
    case = merkle_case(spec.n_columns_per_log_size[tree][L], L, device, seed, rows=rows)
    return case._replace(label=f"tree {tree} {case.label}")


def run_merkle(case: MerkleCase, plain: bool = False, block=None) -> torch.Tensor:
    """The case's (n, 8) digests: the kernel or its plain version; the plain
    version `block` nodes at a time where given (a node depends on its own
    children and column entries only), so its (rows, 16) states stay small."""
    from ..ops import merkle_cuda

    if not plain:
        return merkle_cuda.level(case.children, case.cols, case.n)
    step = block or case.n
    return torch.cat([commit.level_plain(None if case.children is None else case.children[2 * s:2 * (s + step)],
                                         case.cols[:, s:s + step], min(step, case.n - s))
                      for s in range(0, case.n, step)])
