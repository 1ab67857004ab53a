"""The seeded circuits of the proving cells: tools/prover_memory.py's
`shaped_trace` (chained Poseidon2 permutations and QM31 products whose
tables pad to the given log sizes), with every starting witness value drawn
from the seed.  Built with the port's circuit layer; `digest` pins what that
layer makes of a seed, so that a change to it fails the set-up instead of
moving the yardstick."""

from __future__ import annotations

import hashlib

import numpy as np

P = (1 << 31) - 1


def seeded_trace(log_plonk: int, log_poseidon: int, rng: np.random.Generator) -> dict:
    from recursive_stwo_tpu_torch.cs.system import PlonkWithPoseidonCS
    from recursive_stwo_tpu_torch.gadgets.fields import QM31Var
    from recursive_stwo_tpu_torch.gadgets.poseidon import Poseidon2Half
    from recursive_stwo_tpu_torch.prover.air import ROWS_PER_INV

    values = [int(v) for v in rng.integers(1, P, 20)]
    n_perms = (1 << (log_poseidon - 1)) // ROWS_PER_INV + 1
    if log_plonk <= (n_perms + 64).bit_length():
        raise ValueError(f"log_plonk {log_plonk} is too small for {n_perms} permutations")
    cs = PlonkWithPoseidonCS()
    left = Poseidon2Half.new_witness(cs, values[:8])
    right = Poseidon2Half.new_witness(cs, values[8:16])
    for _ in range(n_perms):
        left = Poseidon2Half.permute_get_rate(left, right)
    x = QM31Var.new_witness(cs, tuple(values[16:20]))
    while len(cs.a_wire) <= 1 << (log_plonk - 1):
        x = x * x
    cs.pad()
    cs.check_arithmetics()
    cs.populate_logup_arguments()
    cs.check_poseidon_invocations()
    return cs.generate_trace()


def digest(trace: dict) -> str:
    h = hashlib.sha256()
    for key in sorted(trace):
        a = np.ascontiguousarray(trace[key])
        h.update(f"{key}:{a.dtype.str}:{a.shape};".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def trace_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of a run's index-th trace."""
    return np.random.Generator(np.random.PCG64([seed, index]))
