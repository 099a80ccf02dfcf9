"""Per-note MLP v2 parameter corrections (2→16→16→11), float64 NumPy.

Port of `openwurli_tpu/mlp.py`. The weights are read from the package's
`data/mlp_weights.npz`, a copy of the reference's.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np

from openwurli_tpu_torch import DATA_DIR

MIDI_MIN = 21.0
MIDI_MAX = 108.0
N_FREQ = 5
N_DECAY = 5
DS_IDX = 10
TRAIN_MIDI_LO = 65.0
TRAIN_MIDI_HI = 97.0
FADE_SEMITONES = 12.0

WEIGHTS_PATH = os.path.join(DATA_DIR, "mlp_weights.npz")


class MlpWeights(NamedTuple):
    w1: np.ndarray  # (16, 2)
    b1: np.ndarray  # (16,)
    w2: np.ndarray  # (16, 16)
    b2: np.ndarray  # (16,)
    w3: np.ndarray  # (11, 16)
    b3: np.ndarray  # (11,)
    target_means: np.ndarray  # (11,)
    target_stds: np.ndarray  # (11,)


def load_weights(path: str = WEIGHTS_PATH) -> MlpWeights:
    with np.load(path) as z:
        return MlpWeights(*[np.asarray(z[k], dtype=np.float64)
                            for k in MlpWeights._fields])


@functools.lru_cache(maxsize=1)
def default_weights() -> MlpWeights:
    return load_weights()


class MlpCorrections(NamedTuple):
    freq_offsets_cents: np.ndarray  # (..., 5)
    decay_offsets: np.ndarray  # (..., 5)
    ds_correction: np.ndarray  # (...,)


def forward(weights: MlpWeights, midi_norm, vel_norm):
    """Raw denormalised MLP output (..., 11)."""
    x = np.stack(np.broadcast_arrays(np.asarray(midi_norm, np.float64),
                                     np.asarray(vel_norm, np.float64)),
                 axis=-1)
    h1 = np.maximum(x @ weights.w1.T + weights.b1, 0.0)
    h2 = np.maximum(h1 @ weights.w2.T + weights.b2, 0.0)
    raw = h2 @ weights.w3.T + weights.b3
    return raw * weights.target_stds + weights.target_means


def infer(midi, velocity, weights: MlpWeights | None = None,
          enabled=True) -> MlpCorrections:
    """Batched note-on corrections, fading to identity outside MIDI 65-97."""
    if weights is None:
        weights = default_weights()
    m, v = np.broadcast_arrays(np.asarray(midi, np.float64),
                               np.asarray(velocity, np.float64))
    fade = np.where(
        m < TRAIN_MIDI_LO,
        np.clip((m - (TRAIN_MIDI_LO - FADE_SEMITONES)) / FADE_SEMITONES,
                0.0, 1.0),
        np.where(m > TRAIN_MIDI_HI,
                 np.clip(((TRAIN_MIDI_HI + FADE_SEMITONES) - m)
                         / FADE_SEMITONES, 0.0, 1.0),
                 1.0))
    fade = fade * np.asarray(enabled, dtype=np.float64)
    midi_norm = np.clip((m - MIDI_MIN) / (MIDI_MAX - MIDI_MIN), 0.0, 1.0)
    raw = forward(weights, midi_norm, np.clip(v, 0.0, 1.0))
    freq = np.clip(raw[..., :N_FREQ] * fade[..., None], -100.0, 100.0)
    raw_decay = np.clip(raw[..., N_FREQ:N_FREQ + N_DECAY], 0.3, 3.0)
    decay = 1.0 + (raw_decay - 1.0) * fade[..., None]
    ds = 1.0 + (np.clip(raw[..., DS_IDX], 0.7, 1.2) - 1.0) * fade
    return MlpCorrections(freq, decay, ds)
