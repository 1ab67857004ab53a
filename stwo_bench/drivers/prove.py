"""The prover's entries, `prover/prove.py::prove` (resident) and
`prover/stream.py::prove_streamed`, in a closed loop with one prover.

Traffic keys: `path` "resident" or "streamed" (with `chunk_log` and
`cutoff`); `traces` traces proved in turn, each proof of its own trace
object, the first seed 0's (its digest pinned by the configuration), the
others seeded; `trace_proofs` the proofs of a traced window.  The reference
checks one proof of each trace proved in the window, drawn from the seed.
Set-up builds the traces, checks the seed-0 digest and makes one cold proof, which builds the host tables and kernels of this
shape and no other.
"""

from __future__ import annotations

import time

import numpy as np

from stwo_bench.harness import circuit
from stwo_bench.harness.work import prover_perms
from stwo_bench.reference import check_proof, config as ref_config


class Session:
    kind = "prove"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        import torch

        from recursive_stwo_tpu_torch.models.flagship import proof_bytes
        from recursive_stwo_tpu_torch.proof.containers import FriConfig, PcsConfig

        self.torch, self.device, self.config, self.traffic = torch, device, config, traffic
        self.proof_bytes = proof_bytes
        self.pcs = PcsConfig(pow_bits=config["pow_bits"],
                             fri_config=FriConfig(config["log_last_layer_degree_bound"],
                                                  config["log_blowup_factor"], config["n_queries"]))
        self.rng = np.random.Generator(np.random.PCG64([seed, 1 << 32]))
        lp, lq = config["log_size_plonk"], config["log_size_poseidon"]
        t0 = time.perf_counter()
        # the pool's first trace is seed 0's, whose digest the configuration pins
        self.traces = [circuit.seeded_trace(lp, lq, circuit.trace_rng(0, 0))]
        pinned = circuit.digest(self.traces[0])
        if pinned != config["trace_sha256_seed0"]:
            raise RuntimeError(f"the seed-0 trace hashes to {pinned}, not the configuration's "
                               f"{config['trace_sha256_seed0']}: the circuit layer changed the input")
        self.traces += [circuit.seeded_trace(lp, lq, circuit.trace_rng(seed, i)) for i in range(1, traffic["traces"])]
        self.notes = {"traces_s": time.perf_counter() - t0}
        if traffic["path"] == "streamed":
            from recursive_stwo_tpu_torch.prover.stream import prove_streamed

            chunk_log, cutoff = traffic["chunk_log"], traffic["cutoff"]
            self.prove = lambda trace, pcs, progress, dev: prove_streamed(trace, pcs, progress, dev,
                                                                          chunk_log=chunk_log, cutoff=cutoff)
        else:
            from recursive_stwo_tpu_torch.prover.prove import prove

            self.prove = lambda trace, pcs, progress, dev: prove(trace, pcs, progress, dev)
        t0 = time.perf_counter()
        self.proofs = [(0, self.prove(self.traces[0], self.pcs, None, device))]  # the cold proof
        self.notes["cold_proof_s"] = time.perf_counter() - t0

    def window(self, seconds: float, spans) -> dict:
        traced, torch = spans.traced, self.torch
        self.proofs, stages, names = [], [], {}
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        walls = []
        start = time.perf_counter()
        while True:
            i = len(self.proofs) % len(self.traces)
            t0 = time.perf_counter()
            progress = _Stages(torch, spans, names) if traced and self.device == "cuda" else None
            with spans("prove"):
                proof = self.prove(self.traces[i], self.pcs, progress, self.device)
                if self.device == "cuda":
                    torch.cuda.synchronize()
            if progress is not None:
                stages.append(progress.finish())
            self.proofs.append((i, proof))
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            if (len(self.proofs) >= self.traffic["trace_proofs"]) if traced else (t1 - start >= seconds):
                break
        peak = torch.cuda.max_memory_allocated() if self.device == "cuda" else None
        self.notes["proof_walls_s"] = walls
        if self.device == "cuda":
            self.notes["alloc_retries"] = torch.cuda.memory_stats().get("num_alloc_retries")
        return {"kind": self.kind, "window_s": t1 - start, "units": len(self.proofs), "proofs": len(self.proofs),
                "peak_window_bytes": peak, "stages": stages, "span_names": names}

    def judge(self) -> dict:
        """Holds one proof of each trace, drawn from the seed, to the
        reference, and every proof of one trace to the others of it, byte
        for byte."""
        data = [(i, self.proof_bytes(p)) for i, p in self.proofs]
        self.proofs = None
        if self.device == "cuda":
            self.torch.cuda.empty_cache()
        unstable = sum(len({b for j, b in data if j == i}) > 1 for i in range(len(self.traces)))
        pick = [int(self.rng.choice([k for k, (j, _) in enumerate(data) if j == i]))
                for i in sorted({i for i, _ in data})]
        failed = off = bad_proofs = 0
        for k in pick:
            i, blob = data[k]
            got = check_proof.check(blob, self.config, self.traces[i])
            failed += got["failed_checks"]
            off += got["trace_samples_off"]
            bad_proofs += bool(got["failed_checks"] or got["trace_samples_off"])
        correct = failed == 0 and off == 0 and unstable == 0 and len(pick) > 0
        return {"correct": correct, "attempted": len(data), "failed": bad_proofs,
                "work": {"perms_per_proof": prover_perms(ref_config.spec(self.config))},
                "compared": {"proofs_checked": {"value": len(pick), "limit": "> 0"},
                             "failed_checks": {"value": failed, "limit": 0},
                             "trace_samples_off": {"value": off, "limit": 0},
                             "traces_with_two_proofs": {"value": unstable, "limit": 0}}}


class _Stages:
    """`progress` for a traced proof: each stage, named by the message that
    ends it, timed on the host clock after a synchronize(), inside a span
    `stageK` that `names` maps to that message."""

    def __init__(self, torch, spans, names: dict):
        self.torch, self.spans, self.names = torch, spans, names
        self.done, self.t = [], time.perf_counter()
        self._open()

    def _open(self):
        self.span = self.spans(f"stage{len(self.done)}")
        self.span.__enter__()

    def __call__(self, msg: str) -> None:
        self.torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        now = time.perf_counter()
        self.names.setdefault(f"stage{len(self.done)}", msg)
        self.done.append((msg, now - self.t))
        self.t = now
        self._open()

    def finish(self) -> list:
        self.span.__exit__(None, None, None)
        self.names.setdefault(f"stage{len(self.done)}", "after the last message")
        return self.done
