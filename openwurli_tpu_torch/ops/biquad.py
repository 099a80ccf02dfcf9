"""Biquad coefficient design (Audio EQ Cookbook), float64 NumPy.

Port of `openwurli_tpu/ops/biquad.py`: the coefficient design in NumPy
(note-on and pack time) and in torch (`design_t`, the speaker's per-sample
redesign), and the DF-II-T `step` on torch tensors, which the f64 engine
kernels repeat op for op.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch.ops import exact


class BiquadCoeffs(NamedTuple):
    b0: np.ndarray
    b1: np.ndarray
    b2: np.ndarray
    a1: np.ndarray
    a2: np.ndarray


def _normalize(b0, b1, b2, a0, a1, a2):
    return BiquadCoeffs(b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0)


def _w0(hz, sample_rate):
    w0 = 2.0 * np.pi * np.asarray(hz, dtype=np.float64) / sample_rate
    return np.sin(w0), np.cos(w0)


def bandpass(center_hz, q, sample_rate):
    """Bandpass, constant skirt gain (peak gain = Q)."""
    sin_w0, cos_w0 = _w0(center_hz, sample_rate)
    alpha = sin_w0 / (2.0 * q)
    b0 = sin_w0 / 2.0
    return _normalize(b0, np.zeros_like(b0), -b0,
                      1.0 + alpha, -2.0 * cos_w0, 1.0 - alpha)


def lowpass(cutoff_hz, q, sample_rate):
    sin_w0, cos_w0 = _w0(cutoff_hz, sample_rate)
    alpha = sin_w0 / (2.0 * q)
    b1 = 1.0 - cos_w0
    b0 = b1 / 2.0
    return _normalize(b0, b1, b0, 1.0 + alpha, -2.0 * cos_w0, 1.0 - alpha)


def highpass(cutoff_hz, q, sample_rate):
    sin_w0, cos_w0 = _w0(cutoff_hz, sample_rate)
    alpha = sin_w0 / (2.0 * q)
    b1 = -(1.0 + cos_w0)
    b0 = (1.0 + cos_w0) / 2.0
    return _normalize(b0, b1, b0, 1.0 + alpha, -2.0 * cos_w0, 1.0 - alpha)


class BiquadState(NamedTuple):
    z1: torch.Tensor
    z2: torch.Tensor


def init_state(shape=(), device="cpu"):
    z = torch.zeros(shape, dtype=torch.float64, device=device)
    return BiquadState(z, z)


def step(coeffs: BiquadCoeffs, state: BiquadState, x):
    """One DF-II-T step (broadcasts over batch dims) → (state, y)."""
    y = coeffs.b0 * x + state.z1
    z1 = coeffs.b1 * x - coeffs.a1 * y + state.z2
    z2 = coeffs.b2 * x - coeffs.a2 * y
    return BiquadState(z1, z2), y


def design_t(kind, hz, q, sample_rate):
    """lowpass / highpass on a float64 tensor cutoff: the NumPy design's
    arithmetic in torch ops, on the tensor's device."""
    w0 = exact.div(2.0 * np.pi * hz, sample_rate)
    sin_w0, cos_w0 = torch.sin(w0), torch.cos(w0)
    alpha = exact.div(sin_w0, 2.0 * q)
    if kind == "lowpass":
        b1 = 1.0 - cos_w0
        b0 = b1 / 2.0
    else:
        b1 = -(1.0 + cos_w0)
        b0 = (1.0 + cos_w0) / 2.0
    return _normalize(b0, b1, b0, 1.0 + alpha, -2.0 * cos_w0, 1.0 - alpha)
