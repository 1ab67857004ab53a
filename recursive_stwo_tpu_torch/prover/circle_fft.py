"""Circle FFT over M31 on int64 tensors.

Twin of the traced half of recursive_stwo_tpu/prover/circle_fft.py
(`interpolate_traced`, `evaluate_traced`, `extend_traced`): evaluations in
bit-reversed circle-domain order, coefficients in the stwo FFT basis,
transforms over the last axis and vectorised over the leading ones.  The
per-layer twiddles and the domain points are the JAX package's host tables,
lifted to the device once per log size.

`interpolate`, `evaluate` and `lde` dispatch on their tensor's device: a CPU
tensor takes the plain versions here (`interpolate_plain`,
`evaluate_plain`: one eager op a step, about six passes over memory a
layer), a CUDA tensor the circle FFT kernel (ops/fft_cuda.py,
csrc/circle_fft.cu: a few passes a transform), which raises on anything it
does not take; nothing falls back.  On CUDA `lde` hands the kernel the
unpadded coefficients and the target size, so the zero padding is never
written.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..core import m31
from ..ops import fft_cuda
from . import circle_fft_host as host_fft
from .arrays import to_device


@lru_cache(maxsize=None)
def _layer_twiddles(log_size: int, inverse: bool, device: torch.device):
    tws = host_fft._inv_twiddles(log_size) if inverse else host_fft._twiddles(log_size)
    return tuple(to_device(t, device) for t in tws)


@lru_cache(maxsize=None)
def domain_points(log_size: int, device: torch.device):
    """(x, y) of the circle domain in bit-reversed order, on `device`."""
    x, y = host_fft.domain_points_bit_reversed(log_size)
    return to_device(x, device), to_device(y, device)


def _log(n: int) -> int:
    log_size = n.bit_length() - 1
    if 1 << log_size != n:
        raise ValueError(f"length {n} is not a power of two")
    return log_size


def interpolate(values: torch.Tensor) -> torch.Tensor:
    """Evaluations (..., 2**n) in bit-reversed domain order -> coefficients."""
    if values.device.type == "cpu":
        return interpolate_plain(values)
    return fft_cuda.interpolate(values)


def evaluate(coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients (..., 2**n) -> evaluations in bit-reversed domain order."""
    if coeffs.device.type == "cpu":
        return evaluate_plain(coeffs)
    return fft_cuda.evaluate(coeffs, _log(coeffs.shape[-1]))


def interpolate_plain(values: torch.Tensor) -> torch.Tensor:
    """The plain version of `interpolate`, eager torch on core/m31.py."""
    n = values.shape[-1]
    log_size = _log(n)
    itw = _layer_twiddles(log_size, True, values.device)
    v = values
    for layer in range(log_size):
        step = 1 << layer
        g = v.reshape(v.shape[:-1] + (n // (2 * step), 2, step))
        a, b = g[..., 0, :], g[..., 1, :]
        t = itw[layer].reshape(n // (2 * step), 1)
        v = torch.stack([m31.add(a, b), m31.mul(m31.sub(a, b), t)], dim=-2).reshape(v.shape)
    return m31.mul(v, pow(n, m31.P - 2, m31.P))


def evaluate_plain(coeffs: torch.Tensor) -> torch.Tensor:
    """The plain version of `evaluate`, eager torch on core/m31.py."""
    n = coeffs.shape[-1]
    log_size = _log(n)
    tw = _layer_twiddles(log_size, False, coeffs.device)
    v = coeffs
    for layer in reversed(range(log_size)):
        step = 1 << layer
        g = v.reshape(v.shape[:-1] + (n // (2 * step), 2, step))
        f0, f1 = g[..., 0, :], g[..., 1, :]
        tf1 = m31.mul(f1, tw[layer].reshape(n // (2 * step), 1))
        v = torch.stack([m31.add(f0, tf1), m31.sub(f0, tf1)], dim=-2).reshape(v.shape)
    return v


def extend(coeffs: torch.Tensor, target_log_size: int) -> torch.Tensor:
    """Zero-pad coefficients to 2**target_log_size (the basis is nested)."""
    pad = (1 << target_log_size) - coeffs.shape[-1]
    if pad < 0:
        raise ValueError("cannot extend to a smaller domain")
    return torch.nn.functional.pad(coeffs, (0, pad)) if pad else coeffs


def lde(coeffs: torch.Tensor, target_log_size: int) -> torch.Tensor:
    """Coefficients -> evaluations on the larger domain (`_lde_t`)."""
    if coeffs.device.type == "cpu":
        return evaluate_plain(extend(coeffs, target_log_size))
    return fft_cuda.evaluate(coeffs, target_log_size)
