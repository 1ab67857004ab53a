"""The synthetic circuits of the last-layer cell: PlonkWithoutPoseidon
tables of the real last-layer circuit's size, with its number of public
inputs, from a fixed seed.

The real circuit (recursive-stwo examples/last-layer, 2^17 rows) verifies a
level-14 proof: Poseidon2 permutations on the SIMD gates (m4, pow5m4, pow5,
hadamard, grand sum) for its hashing, QM31 arithmetic on the plain gates,
packed public inputs, and padding rows.  A synthetic one has the same
parts: the public inputs first (1, i, j and then n_inputs - 3 QM31 values
drawn from the seed), a chain of Poseidon2 permutations, the chain's rate
and every public input folded into a QM31 accumulator, more QM31 products
until the program fills all but `padding` rows of the table, and the
padding rows.  The configuration states the permutations and the padding
(the real circuit's: 232 permutations, from its 7,424 pow5m4 rows at 32 a
permutation, and 8,192 padding rows).  Built with the port's circuit layer; `circuit.digest` pins
what that layer makes of a seed, so that a change to it fails the set-up
instead of moving the yardstick.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

P = (1 << 31) - 1


def seeded_trace(log_rows: int, n_inputs: int, seed: int, permutations: int, padding: int) -> tuple:
    """(trace, public inputs as (index, QM31) pairs) of a synthetic circuit
    of 2**log_rows rows."""
    from recursive_stwo_tpu_torch.cs.system import PlonkWithoutPoseidonCS
    from recursive_stwo_tpu_torch.gadgets.fields import QM31Var
    from recursive_stwo_tpu_torch.gadgets.poseidon import Poseidon2Half

    rng = np.random.Generator(np.random.PCG64([seed, 1 << 33]))
    cs = PlonkWithoutPoseidonCS()
    inputs = [QM31Var.new_public_input(cs, tuple(int(v) for v in rng.integers(0, P, 4)))
              for _ in range(n_inputs - cs.num_input)]
    words = [int(v) for v in rng.integers(0, P, 20)]
    left = Poseidon2Half.new_witness(cs, words[:8])
    right = Poseidon2Half.new_witness(cs, words[8:16])
    for _ in range(permutations):
        left = Poseidon2Half.permute_get_rate(left, right)
    rate = left.to_qm31()
    acc = QM31Var.new_witness(cs, tuple(words[16:20]))
    for k, x in enumerate(inputs):
        acc = acc * x + rate[k % 2]
    target = (1 << log_rows) - padding
    if len(cs.a_wire) > target:
        raise ValueError(f"{len(cs.a_wire)} rows do not fit 2**{log_rows} with {padding} of padding")
    while len(cs.a_wire) < target:
        acc = acc * acc + inputs[len(cs.a_wire) % len(inputs)]
    cs.pad()
    cs.check_arithmetics()
    cs.populate_logup_arguments()
    trace = cs.generate_trace()
    if len(trace["a_wire"]) != 1 << log_rows:
        raise ValueError(f"the table has {len(trace['a_wire'])} rows, not 2**{log_rows}")
    return trace, tuple((i + 1, tuple(int(v) for v in cs.value(i + 1))) for i in range(cs.num_input))


def inputs_digest(inputs) -> str:
    """sha256 of the public inputs as canonical JSON."""
    return hashlib.sha256(json.dumps([[i, list(v)] for i, v in inputs]).encode()).hexdigest()
