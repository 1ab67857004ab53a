"""The verifier spec a configuration file states (never the proof's own)."""

from __future__ import annotations

import dataclasses

from .proof.containers import FriConfig, PcsConfig
from .verifier.spec import VerifierSpec


def pcs_config(config: dict) -> PcsConfig:
    return PcsConfig(pow_bits=config["pow_bits"],
                     fri_config=FriConfig(config["log_last_layer_degree_bound"], config["log_blowup_factor"],
                                          config["n_queries"]))


def spec(config: dict) -> VerifierSpec:
    s = VerifierSpec(log_size_plonk=config["log_size_plonk"], log_size_poseidon=config["log_size_poseidon"],
                     pow_bits=config["pow_bits"], log_last_layer_degree_bound=config["log_last_layer_degree_bound"],
                     log_blowup_factor=config["log_blowup_factor"], n_queries=config["n_queries"],
                     n_inner_layers=0)
    return dataclasses.replace(s, n_inner_layers=s.expected_n_inner_layers)


def public_inputs(config: dict) -> tuple:
    return tuple((int(i), tuple(int(v) for v in value)) for i, value in config["public_inputs"])
