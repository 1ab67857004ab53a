"""Out-of-domain sampling of coefficient columns.

Twin of prover/device.py:244-293 (`_sample_jit`, `sample_columns`): the QM31
basis at the point is built by doubling, vals_{k+1} = [vals_k, vals_k * f_k],
then each limb is a product with the coefficients and one sum mod p (a sum
of fewer than 2**32 residues fits int64).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import m31
from ..core import qm31 as q
from ..core.qm31 import QM31
from .arrays import to_numpy


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
