"""FRI first-layer quotients over the commitment domains.

Twin of device_prove.py:533-568 (`_stage_quotients_jit`, `_dev_domain`) and
stream.py:585-613 (`_quot_chunk_jit`): per first-layer log size, the port's
verifier `fri_answers_for_group` evaluated with the whole domain (or a
chunk of it) as its query axis.

`group_answers` dispatches on its columns' device: on CUDA one call of the
quotient kernel (ops/quotients_cuda.py, csrc/quotients.cu), which reads the
group's columns in place from their blocks and raises on anything it does
not take; on the CPU the plain version, `group_answers_plain`.  The answer
is pointwise in the domain, so the plain version takes the domain in chunks
of CHUNK points; that bounds its (points, columns) QM31 temporaries (96
columns at 2**21 points would be several GB each) and changes no value.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..core.qm31 import QM31
from ..ops import quotients_cuda
from ..verifier import quotients as vquot
from ..verifier.spec import VerifierSpec
from . import circle_fft
from .arrays import to_device
from .tiles import TilePoints

CHUNK = 1 << 18


class AnswerInputs(NamedTuple):
    """The proof-wide inputs of `group_answers` on one device."""

    samples: torch.Tensor  # (S, 4) sampled values
    oods: tuple  # the OODS point's eight limbs, x then y
    rc: tuple  # the quotients' random coefficient's four limbs


def _q_vec(v4, device) -> QM31:
    """(4,) limbs -> QM31 of (1,) tensors (a batch of one proof)."""
    return QM31(*(torch.tensor([int(x)], dtype=torch.int64, device=device) for x in v4))


def answer_inputs(samples_flat: np.ndarray, oods: Tuple[tuple, tuple], after_coeff, device) -> AnswerInputs:
    """samples_flat (S, 4), the OODS point (x, y) and the random coefficient
    as `group_answers` takes them, the samples on `device`."""
    return AnswerInputs(to_device(samples_flat, device), tuple(int(v) for c in oods for v in c),
                        tuple(int(v) for v in after_coeff))


def group_answers_plain(spec: VerifierSpec, g: int, inputs: AnswerInputs, blocks: List[torch.Tensor], dx,
                        dy) -> torch.Tensor:
    """The plain version of `group_answers` at the points (dx, dy), CHUNK
    points at a time."""
    dev = dx.device
    samples = inputs.samples[None]
    point = (_q_vec(inputs.oods[:4], dev), _q_vec(inputs.oods[4:], dev))
    after = _q_vec(inputs.rc, dev)
    parts = []
    for s in range(0, dx.shape[0], CHUNK):
        rows = torch.cat([b[:, s : s + CHUNK] for b in blocks]).T[None]  # (1, points, n_cols)
        parts.append(
            vquot.fri_answers_for_group(
                spec, g, point, after, samples, rows, dx[None, s : s + CHUNK], dy[None, s : s + CHUNK]
            )
        )
    return torch.stack([torch.cat([p[i][0] for p in parts]) for i in range(4)])


def group_answers(spec: VerifierSpec, g: int, inputs: AnswerInputs, blocks: List[torch.Tensor], points,
                  out=None) -> torch.Tensor:
    """(4, N) first-layer quotient limbs of group g at N points of its
    domain, from its columns' values there: `blocks`, tensors whose rows in
    order are the group's columns (group column order), each (rows, N).
    `points` is the points' (x, y), a pair of (N,) tensors, or a chunk's
    TilePoints.  Written into `out`, a (4, N) view, when given."""
    if blocks[0].device.type == "cpu":
        if isinstance(points, TilePoints):
            points = tuple(c.reshape(-1) for c in points.points())
        got = group_answers_plain(spec, g, inputs, blocks, *points)
        return got if out is None else out.copy_(got)
    return quotients_cuda.quotients(spec, g, inputs.samples, inputs.oods, inputs.rc, blocks, points, out)


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
        first_cols[L] = group_answers(spec, g, inputs, blocks_by_log[L], circle_fft.domain_points(L, device))
    return first_cols
