"""Faults planted in a cell's timed path under the harness, for the tests
that see `correct` come out false: each replaces the session's entry."""

from __future__ import annotations

import numpy as np


def _verify_hook(fault: str):
    def hook(session):
        if fault == "hints":  # a clean slot's prepared sibling hash moved, as a fault in the hint layout leaves it
            for p, batch in enumerate(session.batches):
                slot = min(set(range(session.batch)) - {s for s, *_ in session.patterns[p]})
                h = batch.tree_paths[0].sibling_hashes
                h[slot, 0, 0, 0] = (h[slot, 0, 0, 0] + 1) % ((1 << 31) - 1)
            return
        step, last = session.step, {}

        def broken(spec, arrays, inputs):
            checks = step(spec, arrays, inputs)
            if fault == "stale":  # the previous call's verdicts, unchanged
                prev = last.get("checks")
                last["checks"] = checks
                return prev if prev is not None else {k: v.clone().fill_(True) for k, v in checks.items()}
            if fault == "half":  # the second half of the batch left out, passed unchecked
                half = next(iter(checks.values())).shape[0] // 2
                out = {}
                for k, v in checks.items():
                    v = v.clone()
                    v[half:] = True
                    out[k] = v
                return out
            if fault == "altered":  # one verdict altered where it is produced
                out = dict(checks)
                out["ok"] = checks["ok"].clone()
                out["ok"][0] = ~out["ok"][0]
                return out
            raise ValueError(fault)

        session.step = broken

    return hook


def _prove_hook(fault: str):
    def hook(session):
        prove, last = session.prove, {}

        def broken(trace, pcs, progress, dev):
            proof = prove(trace, pcs, progress, dev)
            if fault == "stale":  # the first proof, returned for every trace
                return last.setdefault("proof", proof)
            if fault == "altered":  # one sampled value altered where it is produced
                sv = proof.stark_proof.sampled_values[1][0]
                sv[0, 0] = np.uint32((int(sv[0, 0]) + 1) % ((1 << 31) - 1))
                return proof
            raise ValueError(fault)

        session.prove = broken

    return hook


def hook(spec: str):
    """'verify:stale' and the like."""
    kind, fault = spec.split(":")
    return (_verify_hook if kind == "verify" else _prove_hook)(fault)
