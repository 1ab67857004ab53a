"""Static shape/structure descriptor for the PlonkWithPoseidon verifier.

Everything data-independent about a proof — column counts, tree depths, mask
layout, FRI chain shape, transcript length — is derived here once, host-side,
from (log_size_plonk, log_size_poseidon, PcsConfig): the configuration's
own, never the proof's (config.py).

Layout facts (validated against the fixtures):
  tree 0 (preprocessed): 10 plonk cols @ lp  + 40 poseidon cols @ lq
  tree 1 (trace):        12 plonk cols @ lp  + 48 poseidon cols @ lq
  tree 2 (interaction):   8 plonk cols @ lp  +  8 poseidon cols @ lq,
                          mask (0,) on first 4 of each half, (-1, 0) on last 4
  tree 3 (composition):   8 cols @ d-1, d = max(lp+1, lq+3)
Commitment-tree domains add log_blowup_factor.  See
recursive-stwo components/recursive/composition/src/lib.rs:48-58.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

PLONK_LOG_EXPAND = 1  # max plonk AIR constraint degree 3 -> +1
POSEIDON_LOG_EXPAND = 3  # max poseidon AIR constraint degree ~6 -> +3

N_PREPROCESSED_PLONK = 10
N_PREPROCESSED_POSEIDON = 40
N_TRACE_PLONK = 12
N_TRACE_POSEIDON = 48
N_INTERACTION_PLONK = 8
N_INTERACTION_POSEIDON = 8
N_COMPOSITION = 8


@dataclass(frozen=True)
class VerifierSpec:
    log_size_plonk: int
    log_size_poseidon: int
    pow_bits: int
    log_last_layer_degree_bound: int
    log_blowup_factor: int
    n_queries: int
    n_inner_layers: int

    # -- composition / column structure --------------------------------------

    @cached_property
    def composition_log_degree_bound(self) -> int:
        return max(
            self.log_size_plonk + PLONK_LOG_EXPAND,
            self.log_size_poseidon + POSEIDON_LOG_EXPAND,
        )

    @cached_property
    def tree_col_degree_logs(self) -> Tuple[Tuple[int, ...], ...]:
        lp, lq = self.log_size_plonk, self.log_size_poseidon
        dm1 = self.composition_log_degree_bound - 1
        return (
            (lp,) * N_PREPROCESSED_PLONK + (lq,) * N_PREPROCESSED_POSEIDON,
            (lp,) * N_TRACE_PLONK + (lq,) * N_TRACE_POSEIDON,
            (lp,) * N_INTERACTION_PLONK + (lq,) * N_INTERACTION_POSEIDON,
            (dm1,) * N_COMPOSITION,
        )

    @cached_property
    def tree_col_domain_logs(self) -> Tuple[Tuple[int, ...], ...]:
        b = self.log_blowup_factor
        return tuple(tuple(v + b for v in tree) for tree in self.tree_col_degree_logs)

    @cached_property
    def tree_max_domain_log(self) -> Tuple[int, ...]:
        return tuple(max(t) for t in self.tree_col_domain_logs)

    @cached_property
    def n_samples_per_column(self) -> Tuple[Tuple[int, ...], ...]:
        """Mask points per column (pairs-batched logup: last 4 interaction
        columns of each AIR carry the (-1, 0) prev-row mask)."""
        return (
            (1,) * (N_PREPROCESSED_PLONK + N_PREPROCESSED_POSEIDON),
            (1,) * (N_TRACE_PLONK + N_TRACE_POSEIDON),
            (1, 1, 1, 1, 2, 2, 2, 2, 1, 1, 1, 1, 2, 2, 2, 2),
            (1,) * N_COMPOSITION,
        )

    @cached_property
    def sample_shifts_per_column(self) -> Tuple[Tuple[Tuple[int, ...], ...], ...]:
        """Row-shift of each sample point; shift s means oods + s*trace_step."""
        out = []
        for n_samples_tree in self.n_samples_per_column:
            out.append(tuple((-1, 0) if n == 2 else (0,) for n in n_samples_tree))
        return tuple(out)

    @cached_property
    def total_samples(self) -> int:
        return sum(sum(t) for t in self.n_samples_per_column)

    @cached_property
    def sample_offsets(self) -> Tuple[Tuple[int, ...], ...]:
        """Start index of each column's samples in the flattened sample list."""
        out = []
        pos = 0
        for tree in self.n_samples_per_column:
            tree_off = []
            for n in tree:
                tree_off.append(pos)
                pos += n
            out.append(tuple(tree_off))
        return tuple(out)

    # -- FRI structure -------------------------------------------------------

    @cached_property
    def all_log_sizes(self) -> Tuple[int, ...]:
        """Distinct first-layer column domain log sizes, descending."""
        sizes = set()
        for tree in self.tree_col_domain_logs:
            sizes.update(tree)
        return tuple(sorted(sizes, reverse=True))

    @cached_property
    def max_first_layer_log(self) -> int:
        return self.all_log_sizes[0]

    @cached_property
    def expected_n_inner_layers(self) -> int:
        # line bound after circle fold = max circle bound - 1; fold until the
        # bound hits log_last_layer_degree_bound.
        max_circle_bound = self.max_first_layer_log - self.log_blowup_factor
        return (max_circle_bound - 1) - self.log_last_layer_degree_bound

    @cached_property
    def final_fold_log(self) -> int:
        """Line domain log of the last-layer polynomial evaluations."""
        return self.max_first_layer_log - self.n_inner_layers - 1

    @cached_property
    def group_columns(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        """Per first-layer log size (desc): (tree, col) of every column with
        that domain size, in flattened tree order (stable sort)."""
        out = []
        for size in self.all_log_sizes:
            cols = []
            for tree_idx, tree in enumerate(self.tree_col_domain_logs):
                for col_idx, s in enumerate(tree):
                    if s == size:
                        cols.append((tree_idx, col_idx))
            out.append(tuple(cols))
        return tuple(out)

    @cached_property
    def n_columns_per_log_size(self) -> Tuple[dict, ...]:
        out = []
        for tree in self.tree_col_domain_logs:
            d = {}
            for s in tree:
                d[s] = d.get(s, 0) + 1
            out.append(d)
        return tuple(out)
