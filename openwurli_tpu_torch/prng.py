"""Bit-exact integer PRNGs: the reed-jitter / attack-noise LCG and the
Box-Muller note-on draws. Port of `openwurli_tpu/prng.py` (uint32 NumPy)."""

from __future__ import annotations

import numpy as np

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
