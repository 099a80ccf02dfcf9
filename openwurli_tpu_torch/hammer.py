"""Hammer model: Gaussian dwell filter, onset ramp time and the
attack-noise burst. Port of `openwurli_tpu/hammer.py`: note-on in NumPy
float64, the per-sample `noise_step` on torch tensors (repeated op for op
by the f64 engine's voice kernel E1)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch import prng
from openwurli_tpu_torch.ops import biquad

NOISE_FADE_IN_SAMPLES = 16


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
    fade_in_remaining: np.ndarray  # int32
    bpf: biquad.BiquadState
    rng_state: np.ndarray  # u32 word


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
        fade_in_remaining=np.full(v.shape, NOISE_FADE_IN_SAMPLES,
                                  dtype=np.int32),
        bpf=biquad.BiquadState(np.zeros(v.shape), np.zeros(v.shape)),
        rng_state=np.broadcast_to(np.asarray(seed).astype(np.uint32),
                                  v.shape))
    return params, state


def noise_step(params: NoiseParams, state: NoiseState):
    """One attack-noise sample for all voices (torch), masked once the
    burst is over; raised-cosine 16-sample fade-in."""
    active = state.remaining > 0
    fade = state.fade_in_remaining
    in_fade = fade > 0
    t = (NOISE_FADE_IN_SAMPLES - fade).to(torch.float64) / \
        NOISE_FADE_IN_SAMPLES
    env = torch.where(in_fade, 0.5 * (1.0 - torch.cos(np.pi * t)), 1.0)
    rng, noise = prng.lcg_signed_unit(state.rng_state)
    bpf_state, filtered = biquad.step(params.bpf, state.bpf, noise)
    out = torch.where(active, state.amplitude * env * filtered, 0.0)
    return NoiseState(
        amplitude=torch.where(active,
                              state.amplitude * params.decay_per_sample,
                              state.amplitude),
        remaining=torch.clamp(state.remaining - active.to(
            state.remaining.dtype), min=0),
        fade_in_remaining=torch.where(active & in_fade, fade - 1, fade),
        bpf=biquad.BiquadState(
            z1=torch.where(active, bpf_state.z1, state.bpf.z1),
            z2=torch.where(active, bpf_state.z2, state.bpf.z2)),
        rng_state=torch.where(active, rng, state.rng_state)), out
