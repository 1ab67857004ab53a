"""The control of a cell: the timed path with one guarantee the
configuration states broken, run at the cell's own size on several seeds;
its `correct` has to come out false.

    python3 stwo_bench/control.py --workload NAME --seeds N [N ...] [--seconds S]

Verifier cells: `verify_batch` with its PoW guarantee dropped (every slot's
`pow` check passes, `ok` taken again).  Proving cells: the prover at 8 PoW
bits fewer than the configuration states.  Prints one JSON line a seed: the
numbers compared and `correct`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stwo_bench.harness import cell  # noqa: E402

POW_BITS_DROPPED = 8


def hook(session) -> None:
    if session.kind == "verify":
        step = session.step

        def no_pow(spec, arrays, inputs):
            checks = dict(step(spec, arrays, inputs))
            checks["pow"] = checks["pow"] | True
            ok = None
            for k, v in checks.items():
                if k != "ok":
                    ok = v if ok is None else ok & v
            checks["ok"] = ok
            return checks

        session.step = no_pow
    else:
        pcs = session.pcs
        session.pcs = type(pcs)(pow_bits=pcs.pow_bits - POW_BITS_DROPPED, fri_config=pcs.fri_config)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    for seed in args.seeds:
        started = time.perf_counter()
        out = cell.run(args.workload, seed, args.seconds, False, "cuda", started, session_hook=hook)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True, "correct": out["correct"],
                          "compared": out["compared"], "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
