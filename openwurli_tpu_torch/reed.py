"""Modal reed oscillator at note-on: rotation/decay/onset constants and the
initial state (LCG seeding and the Box-Muller jitter start).

Port of the pack-time half of `openwurli_tpu/reed.py`; the per-sample
rotation, OU jitter and renorm run inside the voice kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from openwurli_tpu_torch import prng
from openwurli_tpu_torch.tables import NUM_MODES

JITTER_SIGMA = 0.0004
JITTER_TAU = 0.020
JITTER_SUBSAMPLE = 16
RENORM_INTERVAL = 1024
TAU = 6.283185307179586
DB_PER_NEPER = 8.686


class ReedParams(NamedTuple):
    cos_inc: np.ndarray  # (..., 7)
    sin_inc: np.ndarray  # (..., 7)
    phase_inc: np.ndarray  # (..., 7)
    amplitude: np.ndarray  # (..., 7)
    decay_mult: np.ndarray  # (..., 7)
    onset_ramp_samples: np.ndarray  # (...,) int64
    onset_ramp_inc: np.ndarray  # (...,)
    onset_shape_exp: np.ndarray  # (...,)
    jitter_revert: np.ndarray  # (...,)
    jitter_diffusion: np.ndarray  # (...,)


class ReedState(NamedTuple):
    jitter_drift: np.ndarray  # (..., 7)
    jitter_state: np.ndarray  # (...,) uint32


def make_params(fundamental_hz, mode_ratios, amplitudes, decay_rates_db,
                onset_time_s, velocity, sample_rate) -> ReedParams:
    f0 = np.asarray(fundamental_hz, dtype=np.float64)
    phase_inc = TAU * (f0[..., None] * mode_ratios) / sample_rate
    decay_per_sample = decay_rates_db / DB_PER_NEPER / sample_rate
    revert = np.exp(-(1.0 / sample_rate) / JITTER_TAU)
    diffusion = JITTER_SIGMA * np.sqrt(1.0 - revert * revert)
    ramp_samps = np.round(np.asarray(onset_time_s, np.float64)
                          * sample_rate).astype(np.int64)
    ramp_inc = np.where(ramp_samps > 0,
                        np.pi / np.maximum(ramp_samps, 1), 0.0)
    return ReedParams(
        cos_inc=np.cos(phase_inc),
        sin_inc=np.sin(phase_inc),
        phase_inc=phase_inc,
        amplitude=np.asarray(amplitudes, dtype=np.float64),
        decay_mult=np.exp(-decay_per_sample),
        onset_ramp_samples=ramp_samps,
        onset_ramp_inc=ramp_inc,
        onset_shape_exp=1.0 + (1.0 - np.asarray(velocity, np.float64)),
        jitter_revert=np.broadcast_to(revert, f0.shape),
        jitter_diffusion=np.broadcast_to(diffusion, f0.shape),
    )


def init_state(params: ReedParams, jitter_seed) -> ReedState:
    """OU drift from its stationary distribution via Box-Muller."""
    state, draws = prng.box_muller_draws(jitter_seed, NUM_MODES)
    batch = params.amplitude.shape[:-1]
    return ReedState(
        jitter_drift=JITTER_SIGMA * draws * np.ones(batch + (NUM_MODES,)),
        jitter_state=np.broadcast_to(state, batch))
