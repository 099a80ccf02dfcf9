"""Bit-exact integer PRNGs: the reed-jitter / attack-noise LCG and the
Box-Muller note-on draws. Port of `openwurli_tpu/prng.py`: uint32 NumPy at
note-on, int64 torch tensors holding u32 words in the per-sample steps."""

from __future__ import annotations

import numpy as np
import torch

from openwurli_tpu_torch.ops import exact

_U32 = np.uint32
LCG_MUL = 1664525
LCG_ADD = 1013904223
_HALF_U32_MAX = 4294967295.0 / 2.0
TAU = 6.283185307179586


def lcg_next(state):
    """state' = state * 1664525 + 1013904223 (mod 2^32)."""
    with np.errstate(over="ignore"):
        return (np.asarray(np.asarray(state).astype(_U32)) * _U32(LCG_MUL)
                + _U32(LCG_ADD))


def lcg_to_unit(state):
    """(state >> 1) / (u32::MAX / 2) ∈ [0, 1)."""
    return (np.asarray(state) >> _U32(1)).astype(np.float64) / _HALF_U32_MAX


def box_muller_draws(seed, n):
    """n standard-normal draws from two LCG steps each.

    seed: uint32 array. Returns (final_state, draws[..., n])."""
    state = np.maximum(np.asarray(np.asarray(seed).astype(_U32)), _U32(1))
    draws = []
    for _ in range(n):
        state = lcg_next(state)
        u1 = lcg_to_unit(state)
        state = lcg_next(state)
        u2 = lcg_to_unit(state)
        r = np.sqrt(-2.0 * np.log(np.maximum(u1, 1e-30)))
        draws.append(r * np.cos(TAU * u2))
    return state, np.stack(draws, axis=-1)


# ── torch step draws: u32 words carried in int64, masked to 32 bits ──

U32_MASK = 0xFFFFFFFF
SQRT_3 = 1.7320508080  # the reference truncates at this precision


def lcg_next_i64(state):
    """One LCG step on int64 tensors holding u32 words (no overflow: the
    product is below 2^53)."""
    return (state * LCG_MUL + LCG_ADD) & U32_MASK


def lcg_uniform_scaled(state):
    """(new_state, noise): uniform(-√3, √3), unit variance (reed jitter)."""
    s = lcg_next_i64(state)
    u = exact.div((s >> 1).to(torch.float64), _HALF_U32_MAX)
    return s, (u * 2.0 - 1.0) * SQRT_3


def lcg_signed_unit(state):
    """(new_state, noise): the word as i32 / i32::MAX ∈ (-1, 1] (hammer
    attack noise)."""
    s = lcg_next_i64(state)
    signed = torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.float64)
    return s, exact.div(signed, 2147483647.0)
