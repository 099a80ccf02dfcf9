"""Electrostatic pickup constants and note-on parameters.

Port of the pack-time half of `openwurli_tpu/pickup.py`; the bilinear
charge update with the C¹ soft saturation runs inside the voice kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# R_total = 1M || 402K = 287K; C0 = 240 pF → τ = 68.88 µs, fc = 2312 Hz.
TAU_RC = 287.0e3 * 240.0e-12
PICKUP_SENSITIVITY = 1.8375  # V_hv · C0/(C0+Cp) = 147 · 3/240
PICKUP_MAX_Y = 0.98
PICKUP_KNEE_Y = 0.94
DEFAULT_DISPLACEMENT_SCALE = 0.85


class PickupParams(NamedTuple):
    beta: np.ndarray  # dt / (2 τ)
    displacement_scale: np.ndarray


def make_params(sample_rate, displacement_scale=DEFAULT_DISPLACEMENT_SCALE):
    ds = np.asarray(displacement_scale, dtype=np.float64)
    beta = np.full_like(ds, 1.0 / sample_rate / (2.0 * TAU_RC))
    return PickupParams(beta=beta, displacement_scale=ds)


def init_state(shape=()):
    """Normalised charge q, equilibrium 1.0."""
    return np.ones(shape, dtype=np.float64)
