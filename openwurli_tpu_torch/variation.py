"""Deterministic per-note variation — the bit-exact u32 FNV-style hash.

Port of `openwurli_tpu/variation.py`: wrapping uint32 NumPy arithmetic.
"""

from __future__ import annotations

import numpy as np

from openwurli_tpu_torch.tables import NUM_MODES

_U32 = np.uint32


def hash_f64(midi, seed):
    """Hash (midi, seed) → float64 in [0, 1), wrapping u32 semantics."""
    m = np.asarray(np.asarray(midi).astype(_U32))
    s = np.asarray(np.asarray(seed).astype(_U32))
    with np.errstate(over="ignore"):
        h = np.asarray(_U32(2166136261) ^ m, dtype=_U32)
        h = h * _U32(16777619)
        h = h ^ s
        h = h * _U32(16777619)
        h = h ^ (h >> _U32(16))
        h = h * _U32(2654435769)
    return (h & _U32(0x00FFFFFF)).astype(np.float64) / 16777216.0


def freq_detune(midi):
    """Frequency detune multiplier in [1-max, 1+max], max = ±3 cents."""
    return 1.0 + (hash_f64(midi, 0xDEAD) * 2.0 - 1.0) * 0.00173


def mode_amplitude_offsets(midi):
    """Per-mode amplitude multipliers in [0.92, 1.08]. (..., NUM_MODES)."""
    seeds = _U32(0xBEEF) + np.arange(NUM_MODES, dtype=_U32)
    r = hash_f64(np.asarray(midi)[..., None], seeds) * 2.0 - 1.0
    return 1.0 + r * 0.08
