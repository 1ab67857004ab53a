"""The launch counts of every hand-written kernel, in one place.

Each wrapper (ops/poseidon_cuda.py, ops/sha256_cuda.py,
ops/composition_cuda.py, ops/fold_cuda.py, ops/transcript_cuda.py,
ops/fft_cuda.py, ops/quotients_cuda.py, ops/sample_cuda.py,
ops/interaction_cuda.py, ops/fri_fold_cuda.py, ops/merkle_cuda.py,
ops/latency_cuda.py) adds one to its
`LAUNCHES` where it launches its kernel and nowhere else.  A script that shows a path ran through the
kernels calls `reset()` just before the path and `counts()` just after;
every kernel is in the counts, launched or not.
"""

from __future__ import annotations

from . import (composition_cuda, fft_cuda, fold_cuda, fri_fold_cuda, interaction_cuda, latency_cuda, merkle_cuda,
               poseidon_cuda, quotients_cuda, sample_cuda, sha256_cuda, transcript_cuda)

_WRAPPERS = (poseidon_cuda, sha256_cuda, composition_cuda, fold_cuda, transcript_cuda, fft_cuda, quotients_cuda,
             sample_cuda, interaction_cuda, fri_fold_cuda, merkle_cuda, latency_cuda)
KERNELS = tuple(k for w in _WRAPPERS for k in w.LAUNCHES)


def reset() -> None:
    for w in _WRAPPERS:
        w.reset_launches()


def counts() -> dict:
    """Every kernel's launches since the last reset."""
    return {k: v for w in _WRAPPERS for k, v in w.LAUNCHES.items()}
