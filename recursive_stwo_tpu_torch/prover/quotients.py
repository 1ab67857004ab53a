"""FRI first-layer quotients over the commitment domains.

Twin of device_prove.py:533-568 (`_stage_quotients_jit`, `_dev_domain`): per
first-layer log size, the port's verifier `fri_answers_for_group` evaluated
with the whole domain as its query axis.  The
answer is pointwise in the domain, so the domain is taken in chunks of
CHUNK points; that bounds the (points, columns) QM31 temporaries (96 columns
at 2**21 points would be several GB each) and changes no value.  A group's
columns stay in their trees' LDE blocks: only each chunk is gathered.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.qm31 import QM31
from ..verifier import quotients as vquot
from ..verifier.spec import VerifierSpec
from . import circle_fft
from .arrays import to_device

CHUNK = 1 << 18


def _q_vec(v4, device) -> QM31:
    """(4,) limbs -> QM31 of (1,) tensors (a batch of one proof)."""
    return QM31(*(torch.tensor([int(x)], dtype=torch.int64, device=device) for x in v4))


def answer_inputs(samples_flat: np.ndarray, oods: Tuple[tuple, tuple], after_coeff, device):
    """(samples (1, S, 4), OODS point, random coefficient) on `device`: the
    proof-wide inputs of `group_answers`, a batch of one."""
    samples = to_device(samples_flat, device)[None]
    point = (_q_vec(oods[0], device), _q_vec(oods[1], device))
    return samples, point, _q_vec(after_coeff, device)


def group_answers(spec: VerifierSpec, g: int, inputs, blocks: List[torch.Tensor], dx, dy) -> torch.Tensor:
    """(4, N) first-layer quotient limbs of group g at the N points (dx, dy)
    of its domain, from its columns' values there: `blocks`, (n_cols, N)
    tensors in group column order; CHUNK points at a time."""
    samples, point, after = inputs
    parts = []
    for s in range(0, dx.shape[0], CHUNK):
        rows = torch.cat([b[:, s : s + CHUNK] for b in blocks]).T[None]  # (1, points, n_cols)
        parts.append(
            vquot.fri_answers_for_group(
                spec, g, point, after, samples, rows, dx[None, s : s + CHUNK], dy[None, s : s + CHUNK]
            )
        )
    return torch.stack([torch.cat([p[i][0] for p in parts]) for i in range(4)])


def quotients_stage(
    spec: VerifierSpec,
    blocks_by_log: Dict[int, List[torch.Tensor]],
    samples_flat: np.ndarray,
    oods: Tuple[tuple, tuple],
    after_coeff,
):
    """blocks_by_log: L -> the (n_cols, 2**L) LDE blocks of log L, in group
    column order (tree-major); samples_flat (S, 4).  Returns the first-layer
    columns {L: (4, 2**L) limbs}."""
    device = next(iter(blocks_by_log.values()))[0].device
    inputs = answer_inputs(samples_flat, oods, after_coeff, device)
    first_cols = {}
    for g, L in enumerate(spec.all_log_sizes):
        dx, dy = circle_fft.domain_points(L, device)
        first_cols[L] = group_answers(spec, g, inputs, blocks_by_log[L], dx, dy)
    return first_cols
