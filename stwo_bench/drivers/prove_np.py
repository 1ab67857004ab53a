"""The last layer's prover, `prover/stream.py::prove_np_streamed` in the
Sha256MerkleChannel flavour (`Sha256ProverChannel()`, `Sha256DeviceTree`),
in a closed loop with one prover.

Configuration keys: the table's `log_size_plonk`, `public_inputs` (their
count), the PcsConfig, and `traces`, proved in turn: an entry with
`input_proof` is the real last-layer circuit over that proof
(`flagship.last_layer_trace`), whose every proof must be the bytes of its
`proof`; an entry with `seed` is harness/circuit_np.py's synthetic circuit
of that seed, `synthetic_permutations` and `synthetic_padding_rows`.  Every
file's sha256, each trace's digest and its public inputs' digest are
pinned there and checked at set-up.  The traces are
fixed, never drawn from the run's seed: the 28-bit grind's work is a
geometric draw per transcript, and seeded traces would spread `prove_s` by
that draw alone.  The run's seed picks which proof of each trace the
reference checks.

Traffic keys: `chunk_log` and `cutoff` (the streamed trees'), and
`trace_proofs`, the proofs of a traced window.  Set-up builds the traces
and makes one cold proof, which builds the kernels and host tables of this
shape; the window is drivers/prove.py's.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np

from stwo_bench.harness import circuit, circuit_np, registry
from stwo_bench.harness.work_sha import prover_compressions
from stwo_bench.reference import check_proof_np
from stwo_bench.reference.verifier import spec_np


def _file(path: str, sha256: str) -> str:
    """The repository file at `path` (from the checkout's root), its digest
    checked."""
    full = os.path.join(registry.ROOT, path)
    with open(full, "rb") as f:
        got = hashlib.sha256(f.read()).hexdigest()
    if got != sha256:
        raise RuntimeError(f"{path} hashes to {got}, not the configuration's {sha256}")
    return full


def _pinned(entry: dict, trace: dict, inputs) -> None:
    for key, got in (("trace_sha256", circuit.digest(trace)), ("inputs_sha256", circuit_np.inputs_digest(inputs))):
        if got != entry[key]:
            raise RuntimeError(f"trace {entry['name']}: {key} is {got}, not the configuration's {entry[key]}: the "
                               "circuit layer changed the input")


class Session:
    kind = "prove"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        import torch

        from recursive_stwo_tpu_torch.models import flagship
        from recursive_stwo_tpu_torch.proof.containers import FriConfig, PcsConfig
        from recursive_stwo_tpu_torch.prover.commit import Sha256DeviceTree
        from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel
        from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed

        self.torch, self.device, self.config, self.traffic = torch, device, config, traffic
        self.proof_bytes = flagship.proof_bytes
        self.pcs = PcsConfig(pow_bits=config["pow_bits"],
                             fri_config=FriConfig(config["log_last_layer_degree_bound"],
                                                  config["log_blowup_factor"], config["n_queries"]))
        self.rng = np.random.Generator(np.random.PCG64([seed, 1 << 32]))
        t0 = time.perf_counter()
        self.traces, self.inputs, self.expected = [], [], {}
        for i, entry in enumerate(config["traces"]):
            if "input_proof" in entry:
                level14 = flagship.load_artifact(_file(entry["input_proof"], entry["input_proof_sha256"]))
                trace, _, inputs = flagship.last_layer_trace(level14)
                with open(_file(entry["proof"], entry["proof_sha256"]), "rb") as f:
                    self.expected[i] = f.read()
            else:
                trace, inputs = circuit_np.seeded_trace(config["log_size_plonk"], config["public_inputs"],
                                                        entry["seed"], config["synthetic_permutations"],
                                                        config["synthetic_padding_rows"])
            _pinned(entry, trace, inputs)
            self.traces.append(trace)
            self.inputs.append(inputs)
        self.notes = {"traces_s": time.perf_counter() - t0}
        chunk_log, cutoff = traffic["chunk_log"], traffic["cutoff"]
        self.prove = lambda trace, pcs, progress, dev: prove_np_streamed(
            trace, pcs, progress, dev, channel=Sha256ProverChannel(), tree_cls=Sha256DeviceTree,
            chunk_log=chunk_log, cutoff=cutoff)
        t0 = time.perf_counter()
        self.proofs = [(0, self.prove(self.traces[0], self.pcs, None, device))]  # the cold proof
        self.notes["cold_proof_s"] = time.perf_counter() - t0

    # drivers/prove.py's closed loop: proofs back to back, the traces in
    # turn, each traced proof's stages timed by its progress callback
    window = registry.driver("prove").Session.window

    def judge(self) -> dict:
        """Holds one proof of each trace, drawn from the seed, to the
        reference, every proof of one trace to the others of it, and every
        proof of the real trace to its committed bytes."""
        data = [(i, self.proof_bytes(p)) for i, p in self.proofs]
        self.proofs = None
        if self.device == "cuda":
            self.torch.cuda.empty_cache()
        unstable = sum(len({b for j, b in data if j == i}) > 1 for i in range(len(self.traces)))
        mismatch = sum(b != self.expected[i] for i, b in data if i in self.expected)
        pick = [int(self.rng.choice([k for k, (j, _) in enumerate(data) if j == i]))
                for i in sorted({i for i, _ in data})]
        failed = off = bad_proofs = 0
        for k in pick:
            i, blob = data[k]
            got = check_proof_np.check(blob, self.config, self.traces[i], self.inputs[i])
            failed += got["failed_checks"]
            off += got["trace_samples_off"]
            bad_proofs += bool(got["failed_checks"] or got["trace_samples_off"])
        correct = failed == 0 and off == 0 and unstable == 0 and mismatch == 0 and len(pick) > 0
        work = prover_compressions(spec_np.for_config(self.config), self.traffic["cutoff"])
        return {"correct": correct, "attempted": len(data), "failed": bad_proofs,
                "work": {"sha_compressions_per_proof": work},
                "compared": {"proofs_checked": {"value": len(pick), "limit": "> 0"},
                             "failed_checks": {"value": failed, "limit": 0},
                             "trace_samples_off": {"value": off, "limit": 0},
                             "traces_with_two_proofs": {"value": unstable, "limit": 0},
                             "artifact_mismatch": {"value": mismatch, "limit": 0}}}
