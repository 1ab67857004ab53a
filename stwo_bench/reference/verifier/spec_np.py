"""Static shape of a PlonkWithoutPoseidon proof (the last layer's output
system, recursive-stwo constraint_system/src/plonk_without_poseidon.rs), from
(log_size, PcsConfig): the configuration's own, never the proof's.

One table at one log size:
  tree 0 (preprocessed): 8 columns  (a, b, c wires, op1..op4, mult_c)
  tree 1 (trace):       12 columns  (a, b, c values, 4 M31 limbs each)
  tree 2 (interaction):  8 columns  (two logup QM31 columns, batches [a, b]
                                     and [c]; the second at rows -1 and 0)
  tree 3 (composition):  8 columns  at log_size + 1
The constraints reach degree 5 (op2 (a_k^4 - b_k) times the vanishing
inverse), so the composition bound is log_size + 2.  Every derived
property is VerifierSpec's formula (spec.py), read from the same cached
properties, so the FRI answers (quotients_host.py) and the AIR's mask access
(composition.py) take this spec as they take that one.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import Tuple

from .spec import VerifierSpec

LOG_EXPAND = 2
N_PREPROCESSED = 8
N_TRACE = 12
N_INTERACTION = 8
N_COMPOSITION = 8


@dataclass(frozen=True)
class NoPoseidonSpec:
    log_size: int
    pow_bits: int
    log_last_layer_degree_bound: int
    log_blowup_factor: int
    n_queries: int
    n_inner_layers: int

    @cached_property
    def composition_log_degree_bound(self) -> int:
        return self.log_size + LOG_EXPAND

    @cached_property
    def tree_col_degree_logs(self) -> Tuple[Tuple[int, ...], ...]:
        L = self.log_size
        return ((L,) * N_PREPROCESSED, (L,) * N_TRACE, (L,) * N_INTERACTION,
                (self.composition_log_degree_bound - 1,) * N_COMPOSITION)

    @cached_property
    def n_samples_per_column(self) -> Tuple[Tuple[int, ...], ...]:
        return ((1,) * N_PREPROCESSED, (1,) * N_TRACE, (1, 1, 1, 1, 2, 2, 2, 2), (1,) * N_COMPOSITION)

    tree_col_domain_logs = VerifierSpec.__dict__["tree_col_domain_logs"]
    tree_max_domain_log = VerifierSpec.__dict__["tree_max_domain_log"]
    sample_shifts_per_column = VerifierSpec.__dict__["sample_shifts_per_column"]
    total_samples = VerifierSpec.__dict__["total_samples"]
    sample_offsets = VerifierSpec.__dict__["sample_offsets"]
    all_log_sizes = VerifierSpec.__dict__["all_log_sizes"]
    max_first_layer_log = VerifierSpec.__dict__["max_first_layer_log"]
    expected_n_inner_layers = VerifierSpec.__dict__["expected_n_inner_layers"]
    final_fold_log = VerifierSpec.__dict__["final_fold_log"]
    group_columns = VerifierSpec.__dict__["group_columns"]
    n_columns_per_log_size = VerifierSpec.__dict__["n_columns_per_log_size"]


def for_config(config: dict) -> NoPoseidonSpec:
    """The spec a configuration file states (the table's log size,
    `log_size_plonk`, pow_bits and the FRI configuration), its inner layers
    derived."""
    s = NoPoseidonSpec(log_size=config["log_size_plonk"], pow_bits=config["pow_bits"],
                       log_last_layer_degree_bound=config["log_last_layer_degree_bound"],
                       log_blowup_factor=config["log_blowup_factor"], n_queries=config["n_queries"],
                       n_inner_layers=0)
    return dataclasses.replace(s, n_inner_layers=s.expected_n_inner_layers)
