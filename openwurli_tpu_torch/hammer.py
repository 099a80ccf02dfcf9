"""Hammer model at note-on: Gaussian dwell filter, onset ramp time and the
attack-noise burst parameters. Port of the pack-time half of
`openwurli_tpu/hammer.py` (the noise step runs inside the voice kernel)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from openwurli_tpu_torch.ops import biquad


def dwell_time(velocity, fundamental_hz):
    """Hammer contact duration [s]: 0.75 cycles at ff → 1.0 at pp."""
    v = np.asarray(velocity, dtype=np.float64)
    f = np.asarray(fundamental_hz, dtype=np.float64)
    return np.clip((0.75 + 0.25 * (1.0 - v)) / f, 0.0003, 0.020)


def onset_ramp_time(velocity, fundamental_hz):
    """Onset ramp [s]: 1 period at ff, 2 at pp, 2 ms floor."""
    v = np.asarray(velocity, dtype=np.float64)
    f = np.asarray(fundamental_hz, dtype=np.float64)
    return np.maximum((1.0 + 1.0 * (1.0 - v)) / f, 0.002)


def dwell_attenuation(velocity, fundamental_hz, mode_ratios):
    """Per-mode Gaussian dwell attenuation, normalised to mode 0."""
    f = np.asarray(fundamental_hz, dtype=np.float64)
    ft = f[..., None] * mode_ratios * dwell_time(velocity, f)[..., None]
    atten = np.exp(-ft * ft / (2.0 * 64.0))
    a0 = atten[..., 0:1]
    return np.where(a0 > 1e-30, atten / a0, atten)


class NoiseParams(NamedTuple):
    decay_per_sample: np.ndarray
    bpf: biquad.BiquadCoeffs


class NoiseState(NamedTuple):
    amplitude: np.ndarray
    remaining: np.ndarray  # int32
    rng_state: np.ndarray  # uint32


def make_noise(velocity, fundamental_hz, sample_rate, seed):
    """Attack-noise note-on init. Returns (params, state)."""
    v, f = np.broadcast_arrays(np.asarray(velocity, np.float64),
                               np.asarray(fundamental_hz, np.float64))
    decay = np.full_like(v, np.exp(-1.0 / (0.003 * sample_rate)))
    center = np.clip(f * 5.0, 200.0, 2000.0)
    params = NoiseParams(decay_per_sample=decay,
                         bpf=biquad.bandpass(center, 0.7, sample_rate))
    state = NoiseState(
        amplitude=0.025 * v * v,
        remaining=np.full(v.shape, int(0.015 * sample_rate), dtype=np.int32),
        rng_state=np.broadcast_to(np.asarray(seed).astype(np.uint32),
                                  v.shape))
    return params, state
