"""2× polyphase IIR half-band oversampler: two cascades of three
first-order allpass sections. Port of `openwurli_tpu/ops/allpass.py`: the
constants (read by the mono-chain packer) and the per-sample steps of the
f64 engine on torch tensors."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

BRANCH_A_COEFFS = np.array(
    [0.036681502163648, 0.248030921580110, 0.643184620136480])
BRANCH_B_COEFFS = np.array(
    [0.110377634768680, 0.420399304190880, 0.854640112701920])
N_SECTIONS = 3


def _branch_step(coeffs, state, x):
    """Sections y = (a + z⁻¹)/(1 + a z⁻¹) in cascade; state (..., 3)."""
    new_state = []
    y = x
    for i in range(N_SECTIONS):
        a = float(coeffs[i])
        out = a * y + state[..., i]
        new_state.append(y - a * out)
        y = out
    return torch.stack(new_state, dim=-1), y


class OversamplerState(NamedTuple):
    up_a: torch.Tensor  # (..., 3)
    up_b: torch.Tensor
    down_a: torch.Tensor
    down_b: torch.Tensor
    down_delay: torch.Tensor  # (...,)


def init_state(shape=(), device="cpu"):
    z3 = torch.zeros(shape + (N_SECTIONS,), dtype=torch.float64,
                     device=device)
    return OversamplerState(z3, z3, z3, z3,
                            torch.zeros(shape, dtype=torch.float64,
                                        device=device))


def up_step(state: OversamplerState, x):
    """One base-rate sample → (state, (even, odd)) at twice the rate."""
    up_a, even = _branch_step(BRANCH_A_COEFFS, state.up_a, x)
    up_b, odd = _branch_step(BRANCH_B_COEFFS, state.up_b, x)
    return state._replace(up_a=up_a, up_b=up_b), (even, odd)


def down_step(state: OversamplerState, x_even, x_odd):
    """Two 2×-rate samples → one base-rate sample: the branch average
    with a one-sample delay on the B branch."""
    down_a, a = _branch_step(BRANCH_A_COEFFS, state.down_a, x_even)
    down_b, b = _branch_step(BRANCH_B_COEFFS, state.down_b, x_odd)
    y = (a + state.down_delay) * 0.5
    return state._replace(down_a=down_a, down_b=down_b, down_delay=b), y
