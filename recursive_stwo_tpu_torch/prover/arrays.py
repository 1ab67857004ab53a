"""The prover's tensors at the host boundary.

`trace_to_torch` builds the AIR columns on the host (the JAX package's
`air.plonk_columns` / `air.poseidon_columns`, row order) and uploads them once
as int64, the twin of the single upload at device_prove.py:662-666.
`to_numpy` brings a tensor back as uint32, the dtype of the JAX package's
proof containers, so both packages' proofs serialise with the same function;
each call is one `to_host` span (utils/spans.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.spans import span
from . import air


class TraceArrays(NamedTuple):
    plonk_pre: torch.Tensor  # (10, 2**log_plonk)
    plonk_tr: torch.Tensor  # (12, 2**log_plonk)
    pos_pre: torch.Tensor  # (40, 2**log_poseidon)
    pos_tr: torch.Tensor  # (48, 2**log_poseidon)
    log_plonk: int
    log_poseidon: int


def to_device(x, device) -> torch.Tensor:
    """numpy M31 array -> int64 tensor on `device`."""
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int64 tensor of residues -> host uint32 array."""
    with span("to_host"):
        return x.cpu().numpy().astype(np.uint32)


def trace_to_torch(trace: dict, device) -> TraceArrays:
    with span("prove.air"):
        plonk_pre, plonk_tr = air.plonk_columns(trace)
        pos_pre, pos_tr, lq = air.poseidon_columns(trace)
    lp = plonk_pre.shape[1].bit_length() - 1
    with span("prove.upload"):
        cols = [to_device(a, device) for a in (plonk_pre, plonk_tr, pos_pre, pos_tr)]
    return TraceArrays(*cols, log_plonk=lp, log_poseidon=lq)
