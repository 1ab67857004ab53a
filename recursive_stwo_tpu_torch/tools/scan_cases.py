"""Scan programs for holding the scan kernel (ops/poseidon_cuda.wordmajor_scan)
to its plain version (verifier/hashplan.scan_plain).

  seeded_programs(n, lanes, seed, device)  the absorb and the walk pass of
      seeded random inputs over n slots, cut to the first `lanes` lanes.
      Together they hold every op kind: absorb chunks (each chain's first
      with START), chains of 0 columns and of widths that are not a multiple
      of 8, node ops with the query-bit swap, selfcol, sibcol with WRITE_B,
      a pair walk whose last op is a WRITE_B, lanes that end early; inputs
      read through offsets and strides other than a contiguous tensor's.
  fixture_programs(name, batch, device)  the two passes of one verify_batch
      of a committed fixture (verify_batch_np for the without-Poseidon
      fixture np_small), as the main path builds them, and the states of its
      leaf step.

seeded_programs returns [(label, ScanProgram), ...].
"""

from __future__ import annotations

import torch

from ..models import flagship
from ..verifier import hashplan, verify, verify_np
from ..verifier.arrays import to_torch
from ..verifier.hashplan import PairWalk, ScanProgram, SingleWalk

P = 2**31 - 1


def _lanes(prog: ScanProgram, lanes: int) -> ScanProgram:
    return ScanProgram(prog.ops[:lanes].contiguous(), prog.sources, prog.n, prog.n_out,
                       prog.keep_capacity, prog.device)


def seeded_programs(n: int, lanes: int, seed: int, device) -> list:
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape, high=P):
        return torch.randint(0, high, shape, generator=gen, dtype=torch.int64).to(device)

    # B = n proofs of one query each
    wide = rand(n, 1, 24)
    chains = [rand(n, 1, 0), rand(n, 1, 3), rand(n, 1, 8), rand(n, 1, 11), rand(n, 1, 17),
              wide[:, :, 4:20]]
    # digests as (8, n) views four words into a (12, 16, n) block
    block = rand(12, 16, n)
    dig = [block[i, 4:12] for i in range(12)]
    root = rand(n, 8)
    singles = [
        SingleWalk(5, rand(n, 1, high=1 << 5), rand(n, 1, 5, 8), {1: dig[0], 3: dig[1]}, dig[2], root),
        SingleWalk(3, rand(n, 1, high=1 << 3), rand(n, 1, 3, 8), {}, dig[3], root),
    ]
    pairs = [
        PairWalk(4, rand(n, 1, high=1 << 4), rand(n, 1, 3, 8), {1: dig[4], 2: dig[5]},
                 {1: dig[6], 2: dig[7]}, dig[8], dig[9], root),
        # a sibling hash at every level and columns at level 0: the walk
        # ends on a sibcol op, so its digest is carry_s from the op before
        PairWalk(3, rand(n, 1, high=1 << 3), rand(n, 1, 3, 8), {0: dig[10]}, {0: dig[11]},
                 dig[0], dig[1], root),
    ]
    return [
        ("absorb", _lanes(hashplan.absorb_program(chains), lanes)),
        ("walks", _lanes(hashplan.walk_program(singles, pairs), lanes)),
    ]


def fixture_programs(name: str, batch: int, device) -> tuple:
    """([("absorb", ScanProgram), ("walks", ScanProgram)], leaf_state): the
    passes of one verifier run, and the (W, 16, N) states of its leaf step."""
    if name in flagship.NP_FIXTURE_INPUTS:
        spec, pa = flagship.prepared_arrays_np(name)
        inputs, verifier = flagship.NP_FIXTURE_INPUTS[name], verify_np.verify_batch_np
    else:
        spec, pa = flagship.prepared_arrays(name)
        inputs, verifier = flagship.FIXTURE_INPUTS[name], verify.verify_batch
    arrays = to_torch(flagship.tiled_batch(pa, batch), device)
    progs, leaves = [], []
    run, permute = hashplan.run_scan, hashplan.permute_wordmajor

    def record(prog):
        progs.append(prog)
        return run(prog)

    def record_leaves(state):
        leaves.append(state)
        return permute(state)

    hashplan.run_scan, hashplan.permute_wordmajor = record, record_leaves
    try:
        verifier(spec, arrays, inputs)
    finally:
        hashplan.run_scan, hashplan.permute_wordmajor = run, permute
    return list(zip(("absorb", "walks"), progs)), leaves[0]
