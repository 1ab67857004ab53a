"""In-circuit Poseidon31 Merkle hashing.

Node hash = rate half of permute(left, right); column leaves absorb M31
chunks of 8 (or QM31 pairs) into the capacity, finalized against a zero
rate.  Mirrors /root/reference/primitives/merkle/src/lib.rs and is
bit-exact vs the native `verifier/merkle.py` hashing.
"""

from __future__ import annotations

from .fields import M31Var, QM31Var
from .poseidon import Poseidon2Half


def hash_tree(left, right):
    return Poseidon2Half.permute_get_rate(left, right)


def hash_tree_with_column(left, right, hash_column):
    t = Poseidon2Half.permute_get_rate(left, right)
    return Poseidon2Half.permute_get_rate(t, hash_column)


def hash_tree_with_swap(left, right, bit_value, bit_variable):
    return Poseidon2Half.swap_permute_get_rate(
        left, right, (bit_value, bit_variable)
    )


def hash_tree_with_column_hash_with_swap(
    left, right, bit_value, bit_variable, column_hash
):
    t = Poseidon2Half.swap_permute_get_rate(
        left, right, (bit_value, bit_variable)
    )
    return Poseidon2Half.permute_get_rate(t, column_hash)


def combine_hash_tree_with_column(hash_tree_half, hash_column):
    return Poseidon2Half.permute_get_rate(hash_tree_half, hash_column)


def _absorb_m31(columns):
    """Capacity-mode sponge over M31 chunks of 8 (merkle lib.rs:145-181)."""
    cs = columns[0].cs
    n = len(columns)
    zero = Poseidon2Half.zero(cs)
    zerov = M31Var.zero(cs)

    first = columns[0:8] + [zerov] * max(0, 8 - n)
    digest = Poseidon2Half.permute_get_capacity(
        Poseidon2Half.from_m31(first), zero
    )
    if n <= 8:
        return digest
    num_chunk = -(-n // 8)
    for k in range(1, num_chunk - 1):
        digest = Poseidon2Half.permute_get_capacity(
            Poseidon2Half.from_m31(columns[8 * k : 8 * k + 8]), digest
        )
    remain = n % 8
    tail = columns[n - (remain or 8) :]
    tail = tail + [zerov] * (8 - len(tail))
    return Poseidon2Half.permute_get_capacity(
        Poseidon2Half.from_m31(tail), digest
    )


def hash_m31_columns_get_capacity(columns):
    return _absorb_m31(list(columns))


def hash_m31_columns_get_rate(columns):
    cs = columns[0].cs
    digest = _absorb_m31(list(columns))
    return Poseidon2Half.permute_get_rate(Poseidon2Half.zero(cs), digest)


def hash_qm31_columns_get_capacity(columns):
    """QM31 pairs absorbed per permutation (merkle lib.rs:100-143)."""
    cs = columns[0].cs
    n = len(columns)
    zero = Poseidon2Half.zero(cs)
    zeroq = QM31Var.zero(cs)

    first = list(columns[0:2]) + [zeroq] * max(0, 2 - n)
    digest = Poseidon2Half.permute_get_capacity(
        Poseidon2Half.from_qm31(first[0], first[1]), zero
    )
    if n <= 2:
        return digest
    num_chunk = -(-n // 2)
    for k in range(1, num_chunk - 1):
        digest = Poseidon2Half.permute_get_capacity(
            Poseidon2Half.from_qm31(columns[2 * k], columns[2 * k + 1]), digest
        )
    remain = n % 2
    tail = list(columns[n - (remain or 2) :]) + [zeroq] * (remain and 1)
    digest = Poseidon2Half.permute_get_capacity(
        Poseidon2Half.from_qm31(tail[0], tail[1]), digest
    )
    return digest


def hash_qm31_columns_get_rate(columns):
    cs = columns[0].cs
    digest = hash_qm31_columns_get_capacity(columns)
    return Poseidon2Half.permute_get_rate(Poseidon2Half.zero(cs), digest)
