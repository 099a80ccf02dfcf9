"""Electrostatic pickup: time-varying RC with 1/(1-y) capacitance.

Port of `openwurli_tpu/pickup.py`: constants and note-on parameters
(NumPy), and the bilinear charge update with the C¹ soft saturation on
torch tensors (repeated op for op by the f64 engine's voice kernel E1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch.ops import exact

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


class PickupState(NamedTuple):
    q: np.ndarray  # normalised charge, equilibrium 1.0


def init_state(shape=()):
    return PickupState(q=np.ones(shape, dtype=np.float64))


def soft_saturate(y):
    """Identity below ±0.94, a tanh bend asymptoting to ±0.98."""
    abs_y = torch.abs(y)
    rng = PICKUP_MAX_Y - PICKUP_KNEE_Y
    sat = PICKUP_KNEE_Y + rng * torch.tanh(exact.div(abs_y - PICKUP_KNEE_Y,
                                                     rng))
    return torch.where(abs_y < PICKUP_KNEE_Y, y,
                       torch.where(y >= 0.0, sat, -sat))


def step(params: PickupParams, state: PickupState, x):
    """One bilinear charge update; x is the reed displacement.
    q' = (q(1-α) + 2β)/(1+α), α = β(1-y); out = (q'(1-y) - 1)·S."""
    y = soft_saturate(x * params.displacement_scale)
    one_minus_y = 1.0 - y
    alpha = params.beta * one_minus_y
    q_next = (state.q * (1.0 - alpha) + 2.0 * params.beta) / (1.0 + alpha)
    return PickupState(q=q_next), (q_next * one_minus_y - 1.0) * \
        PICKUP_SENSITIVITY
