"""Biquad coefficient design (Audio EQ Cookbook), float64 NumPy.

Port of the pack-time half of `openwurli_tpu/ops/biquad.py`; the DF-II-T
step runs inside the kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


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
