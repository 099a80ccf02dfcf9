"""Speaker cabinet coefficients for a "character" setting.

Port of `openwurli_tpu/circuits/speaker.py::coeffs_for_character`
(float64 NumPy); the Hammerstein/thermal/biquad step runs inside the
mono-chain kernel.
"""

from __future__ import annotations

import numpy as np

from openwurli_tpu_torch.ops import biquad

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
