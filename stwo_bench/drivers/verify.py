"""The batched verifier's entry, `verifier/verify.py::verify_batch`, in a
closed loop with one client, on batches prepared in set-up and held on the
card.

Traffic keys: `batch` proofs a call; `pool` distinct corruption patterns,
taken in turn, one slot in `corrupt_one_in` of the pool's corrupted;
`trace_calls` the calls of a traced window; `reference_sample` the
corrupted slots the reference works out (drawn from the seed; every clean
slot is compared).  A call ends when its verdicts, every named check of
every slot stacked in one tensor, are on the host.  Every slot holds the
configuration's one proof, corrupted or not.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time

import numpy as np

from stwo_bench.harness import corrupt
from stwo_bench.harness.registry import ROOT
from stwo_bench.reference.check_verify import Reference, compare
from stwo_bench.reference.proof.parse import parse_plonk_with_poseidon_proof as reference_parse


class Session:
    kind = "verify"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        import torch

        from recursive_stwo_tpu_torch.proof.parse import parse_plonk_with_poseidon_proof
        from recursive_stwo_tpu_torch.verifier import hints, verify
        from recursive_stwo_tpu_torch.verifier.arrays import to_torch
        from recursive_stwo_tpu_torch.verifier.spec import VerifierSpec

        self.torch, self.device, self.config, self.traffic = torch, device, config, traffic
        self.step = verify.verify_batch
        self.rng = np.random.Generator(np.random.PCG64(seed))
        with open(os.path.join(ROOT, config["proof"]), "rb") as f:
            self.proof_bytes = f.read()
        if hashlib.sha256(self.proof_bytes).hexdigest() != config["proof_sha256"]:
            raise RuntimeError(f"{config['proof']} is not the configuration's proof")
        self.inputs = tuple((int(i), tuple(int(v) for v in value)) for i, value in config["public_inputs"])
        self.batch = traffic["batch"]

        t0 = time.perf_counter()
        proof = parse_plonk_with_poseidon_proof(self.proof_bytes)
        self.spec = VerifierSpec.from_proof(proof)
        one = hints.prepare(self.spec, [proof])
        drawn_on = reference_parse(self.proof_bytes)
        self.patterns = corrupt.draw(self.rng, drawn_on, self.batch, traffic["corrupt_one_in"], traffic["pool"])
        places = {}
        for pattern in self.patterns:
            for _, kind, where, _ in pattern:
                if (kind, where) not in places:
                    places[(kind, where)] = corrupt.locate(one, drawn_on, kind, where)
        self.batches = []
        for pattern in self.patterns:
            pa = corrupt.tiled(one, self.batch)
            for slot, kind, where, delta in pattern:
                corrupt.plant(pa, slot, places[(kind, where)], delta)
            self.batches.append(to_torch(pa, device))
        self.notes = {"prepare_s": time.perf_counter() - t0}
        for p in range(len(self.patterns)):
            self._call(p, None)

    def _call(self, p: int, spans):
        span = spans or (lambda name: contextlib.nullcontext())
        with span("verify_batch"):
            checks = self.step(self.spec, self.batches[p], self.inputs)
        with span("verdict_copy"):
            verdicts = self.torch.stack(list(checks.values())).cpu()
        self.names = list(checks)
        return verdicts.numpy()

    def window(self, seconds: float, spans) -> dict:
        traced = spans.traced
        self.calls, latencies = [], []
        start = time.perf_counter()
        while True:
            p = len(self.calls) % len(self.patterns)
            t0 = time.perf_counter()
            verdicts = self._call(p, spans)
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            self.calls.append((p, verdicts))
            if (len(self.calls) >= self.traffic["trace_calls"]) if traced else (t1 - start >= seconds):
                break
        return {"kind": self.kind, "window_s": t1 - start, "latencies_s": latencies,
                "proofs": self.batch * len(self.calls), "calls": len(self.calls), "units": len(self.calls)}

    def judge(self) -> dict:
        """Frees the program's batches, then holds every verdict of the
        window to the reference's."""
        self.batches = None
        if self.device == "cuda":
            self.torch.cuda.empty_cache()
        corrupted = [(p, slot) for p, pattern in enumerate(self.patterns) for slot, *_ in pattern]
        pick = self.rng.choice(len(corrupted), min(self.traffic["reference_sample"], len(corrupted)), replace=False)
        sample = sorted(corrupted[i] for i in pick)
        planted = {(p, slot): (kind, where, delta)
                   for p, pattern in enumerate(self.patterns) for slot, kind, where, delta in pattern}
        ref = Reference(self.proof_bytes, self.config)
        ref_names, table = ref.verdicts([[]] + [[planted[k]] for k in sample])
        index = {k: i + 1 for i, k in enumerate(sample)}
        got = compare(self.names, self.calls, self.patterns, ref_names, table, index)
        return {"correct": got["differing"] == 0 and got["compared"] > 0,
                "attempted": self.batch * len(self.calls), "failed": got["wrong_slots"], "work": ref.work(),
                "compared": {"checks_compared": {"value": got["compared"], "limit": "> 0"},
                             "checks_differing": {"value": got["differing"], "limit": 0}}}
