"""Out-of-domain sampling of coefficient columns.

Twin of prover/device.py:244-293 (`_sample_jit`, `sample_columns`).  The
plain version, `sample`, builds the QM31 basis at the point by doubling,
vals_{k+1} = [vals_k, vals_k * f_k], then takes each limb as a product with
the coefficients and one sum mod p (a sum of fewer than 2**32 residues fits
int64).  `sample_many` takes every block and point of a proof: on CUDA one
launch of the sampling kernel (ops/sample_cuda.py, csrc/sample.cu) and one
copy back, on the CPU the plain version block by block.  `samples_at` is the
provers' OODS stage on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import m31
from ..core import qm31 as q
from ..core.qm31 import QM31
from ..ops import sample_cuda
from .arrays import to_numpy
from .prove_host import _factors_at_point


def sample(coeffs: torch.Tensor, factors: np.ndarray) -> np.ndarray:
    """(C, 2**n) M31 coefficients x (n, 4) QM31 ladder factors
    (prove._factors_at_point) -> (C, 4) uint32 samples on the host."""
    n = coeffs.shape[-1]
    if n == 1:
        # constant polynomial: the sample is the coefficient, in limb 0
        out = torch.zeros((coeffs.shape[0], 4), dtype=torch.int64, device=coeffs.device)
        out[:, 0] = coeffs[:, 0]
        return to_numpy(out)
    one = torch.ones(1, dtype=torch.int64, device=coeffs.device)
    vals = QM31(one, one * 0, one * 0, one * 0)
    for f in np.asarray(factors, np.int64):
        scaled = q.q_mul(vals, QM31(*(int(v) for v in f)))
        vals = QM31(*(torch.cat([a, b]) for a, b in zip(vals, scaled)))
    limbs = [m31.mul(coeffs, limb).sum(dim=-1) % m31.P for limb in vals]
    return to_numpy(torch.stack(limbs, dim=-1))


def sample_many(jobs) -> list:
    """jobs: [(coeffs (C, 2**n), [factors (n, 4), ...]), ...], one or two
    points a block -> for each job, its (C, 4) uint32 samples at each point.
    The blocks lie on one device: on CUDA one launch of the sampling kernel
    for all of them and one copy to the host; on the CPU the plain version.
    A block on another device than the first raises."""
    dev = jobs[0][0].device
    for coeffs, _ in jobs:
        if coeffs.device != dev:
            raise ValueError(f"the blocks to sample lie on {dev} and {coeffs.device}")
    if dev.type == "cpu":
        return [[sample(coeffs, f) for f in points] for coeffs, points in jobs]
    out, firsts = sample_cuda.sample_columns(jobs)
    host = to_numpy(out)
    return [[host[r + p * c.shape[0] : r + (p + 1) * c.shape[0]] for p in range(len(points))]
            for (c, points), r in zip(jobs, firsts)]


def samples_at(col_coeffs: dict, oods, shifted: dict) -> dict:
    """OODS samples of each coefficient block at the OODS point, keyed
    (key, 0), and of the interaction blocks (the keys of `shifted`) at their
    point shifted back one step, keyed (key, -1): one `sample_many` call."""
    keys = list(col_coeffs)
    jobs = []
    for key in keys:
        cfs = col_coeffs[key]
        deg_log = cfs.shape[1].bit_length() - 1
        points = [oods] + ([shifted[key]] if key in shifted else [])
        jobs.append((cfs, [_factors_at_point(deg_log, p) for p in points]))
    out = {}
    for key, vals in zip(keys, sample_many(jobs)):
        out[(key, 0)] = vals[0]
        if len(vals) > 1:
            out[(key, -1)] = vals[1]
    return out
