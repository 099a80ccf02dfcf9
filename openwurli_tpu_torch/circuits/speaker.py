"""Wurlitzer 200A speaker cabinet: Hammerstein nonlinearity, tanh Xmax
limit, thermal compression, HPF/LPF, morphed by a "character" setting.

Port of `openwurli_tpu/circuits/speaker.py`: `coeffs_for_character` in
float64 NumPy (the mono-chain packer) and in torch (`coeffs_t`, the f64
engine's per-sample redesign), and the step on torch tensors, repeated op
for op by the f64 engine's chain kernel E2.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch.ops import biquad, exact

HPF_AUTHENTIC_HZ = 30.0
HPF_Q = 0.75
LPF_AUTHENTIC_HZ = 5500.0
LPF_Q = 0.707
HPF_BYPASS_HZ = 20.0
LPF_BYPASS_HZ = 20000.0
THERMAL_TAU = 5.0


def coeffs_for_character(character, sample_rate):
    """Log-interpolated cutoffs + polynomial coefficients; character 0.0
    is bypass (flat, linear), 1.0 authentic."""
    c = np.clip(np.asarray(character, dtype=np.float64), 0.0, 1.0)
    hpf_hz = HPF_BYPASS_HZ * (HPF_AUTHENTIC_HZ / HPF_BYPASS_HZ) ** c
    lpf_hz = LPF_BYPASS_HZ * (LPF_AUTHENTIC_HZ / LPF_BYPASS_HZ) ** c
    return {
        "hpf": biquad.highpass(hpf_hz, HPF_Q, sample_rate),
        "lpf": biquad.lowpass(lpf_hz, LPF_Q, sample_rate),
        "a2": 0.2 * c,
        "a3": 0.6 * c,
        "thermal_coeff": 2.0 * c,
        "character": c,
    }



class SpeakerParams(NamedTuple):
    sample_rate: float
    thermal_alpha: float


class SpeakerState(NamedTuple):
    hpf: biquad.BiquadState
    lpf: biquad.BiquadState
    thermal_state: torch.Tensor


def make_params(sample_rate) -> SpeakerParams:
    sr = float(sample_rate)
    return SpeakerParams(sample_rate=sr, thermal_alpha=1.0 / (THERMAL_TAU
                                                              * sr))


def init_state(device="cpu") -> SpeakerState:
    return SpeakerState(biquad.init_state(device=device),
                        biquad.init_state(device=device),
                        torch.zeros((), dtype=torch.float64, device=device))


def coeffs_t(character, sample_rate):
    """coeffs_for_character on a 0-d float64 tensor, in torch ops."""
    c = exact.clip(character, 0.0, 1.0)
    hpf_hz = HPF_BYPASS_HZ * torch.pow(
        torch.full_like(c, HPF_AUTHENTIC_HZ / HPF_BYPASS_HZ), c)
    lpf_hz = LPF_BYPASS_HZ * torch.pow(
        torch.full_like(c, LPF_AUTHENTIC_HZ / LPF_BYPASS_HZ), c)
    return {
        "hpf": biquad.design_t("highpass", hpf_hz, HPF_Q, sample_rate),
        "lpf": biquad.design_t("lowpass", lpf_hz, LPF_Q, sample_rate),
        "a2": 0.2 * c, "a3": 0.6 * c, "thermal_coeff": 2.0 * c,
        "character": c,
    }


def step(params: SpeakerParams, state: SpeakerState, coeffs, x):
    """One sample: waveshape → Xmax tanh → thermal → HPF → LPF."""
    a2, a3 = coeffs["a2"], coeffs["a3"]
    x2 = x * x
    shaped = (x + a2 * x2 + a3 * x2 * x) / (1.0 + a2 + a3)
    limited = torch.where(coeffs["character"] < 0.001, shaped,
                          torch.tanh(shaped))
    thermal = state.thermal_state + (x2 - state.thermal_state) * \
        params.thermal_alpha
    thermal_gain = 1.0 / (1.0 + coeffs["thermal_coeff"] * torch.sqrt(
        thermal))
    hpf, filtered = biquad.step(coeffs["hpf"], state.hpf,
                                limited * thermal_gain)
    lpf, out = biquad.step(coeffs["lpf"], state.lpf, filtered)
    return SpeakerState(hpf, lpf, thermal), out
