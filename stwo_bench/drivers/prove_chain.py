"""A recursion-chain level's prover, `prover/prove.py::prove` (resident, the
Poseidon31 channel and `DeviceTree`), over the level's real circuit, in a
closed loop with one prover.

Configuration keys: the tables' `log_size_plonk` and `log_size_poseidon`,
the PcsConfig, and `traces`, proved in turn: an entry with `input_proof` is
chain level `level`'s circuit (`flagship.chain_level_trace`) over that
proof verified `multipliers` times, whose every proof must be the bytes
`proof_bytes` makes of its committed `proof` artifact (the `.pkl`, pinned by
`proof_pkl_sha256`; the bytes by `proof_sha256`, the `.bin` digest of
docs/chain_artifacts.txt); an entry with `seed` is harness/circuit.py's
seeded circuit at the tables' log sizes from `trace_rng(seed, 0)`.  Every
file's sha256 and each trace's digest are pinned there and checked at
set-up.  The traces are fixed, never drawn from the run's seed, so that
neither the grind's draw nor the witness spreads `prove_s`; the run's seed
picks which proof of each trace the reference checks.

Traffic keys: `trace_proofs`, the proofs of a traced window.  Set-up builds
the traces and makes one cold proof, which builds the kernels and host
tables of this shape; the window and the judge are drivers/prove.py's, and
the judge adds `artifact_mismatch`.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np

from stwo_bench.harness import circuit, registry

_prove = registry.driver("prove").Session
# the repository file at a path from the checkout's root, its digest checked
_file = registry.driver("prove_np")._file


def _real_trace(entry: dict, pcs, flagship):
    """(the chain level's trace, the bytes its proofs must be)."""
    from recursive_stwo_tpu_torch.proof.parse import parse_plonk_with_poseidon_proof

    level, (_, multipliers, _, level_pcs) = entry["level"], flagship.CHAIN_LEVELS[entry["level"]]
    if multipliers != entry["multipliers"] or level_pcs != pcs:
        raise RuntimeError(f"chain level {level} verifies its input {multipliers} times under {level_pcs}; the "
                           f"configuration states {entry['multipliers']} times under {pcs}")
    with open(_file(entry["input_proof"], entry["input_proof_sha256"]), "rb") as f:
        proof = parse_plonk_with_poseidon_proof(f.read())
    expected = flagship.proof_bytes(flagship.load_artifact(_file(entry["proof"], entry["proof_pkl_sha256"])))
    got = hashlib.sha256(expected).hexdigest()
    if got != entry["proof_sha256"]:
        raise RuntimeError(f"{entry['proof']}'s proof bytes hash to {got}, not the configuration's "
                           f"{entry['proof_sha256']}")
    return flagship.chain_level_trace(level, proof)[0], expected


class Session:
    kind = "prove"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        import torch

        from recursive_stwo_tpu_torch.models import flagship
        from recursive_stwo_tpu_torch.proof.containers import FriConfig, PcsConfig
        from recursive_stwo_tpu_torch.prover.prove import prove

        self.torch, self.device, self.config, self.traffic = torch, device, config, traffic
        self.proof_bytes = flagship.proof_bytes
        self.pcs = PcsConfig(pow_bits=config["pow_bits"],
                             fri_config=FriConfig(config["log_last_layer_degree_bound"],
                                                  config["log_blowup_factor"], config["n_queries"]))
        self.rng = np.random.Generator(np.random.PCG64([seed, 1 << 32]))
        t0 = time.perf_counter()
        self.traces, self.expected = [], {}
        for i, entry in enumerate(config["traces"]):
            if "input_proof" in entry:
                trace, self.expected[i] = _real_trace(entry, self.pcs, flagship)
            else:
                trace = circuit.seeded_trace(config["log_size_plonk"], config["log_size_poseidon"],
                                             circuit.trace_rng(entry["seed"], 0))
            got = circuit.digest(trace)
            if got != entry["trace_sha256"]:
                raise RuntimeError(f"trace {entry['name']} hashes to {got}, not the configuration's "
                                   f"{entry['trace_sha256']}: the circuit layer changed the input")
            self.traces.append(trace)
        self.notes = {"traces_s": time.perf_counter() - t0}
        self.prove = prove
        t0 = time.perf_counter()
        self.proofs = [(0, self.prove(self.traces[0], self.pcs, None, device))]  # the cold proof
        self.notes["cold_proof_s"] = time.perf_counter() - t0

    # drivers/prove.py's closed loop: proofs back to back, the traces in
    # turn, each traced proof's stages timed by its progress callback
    window = _prove.window

    def judge(self) -> dict:
        """drivers/prove.py's judge (one proof of each trace, drawn from the
        seed, held to the reference; every proof of one trace the same
        bytes), and every proof of the real circuit its artifact's bytes."""
        mismatch = sum(self.proof_bytes(p) != self.expected[i] for i, p in self.proofs if i in self.expected)
        verdict = _prove.judge(self)
        verdict["correct"] = verdict["correct"] and mismatch == 0
        verdict["compared"]["artifact_mismatch"] = {"value": mismatch, "limit": 0}
        return verdict
