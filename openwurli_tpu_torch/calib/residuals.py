"""Residual computation (real − model) → MLP training dataset (stage 5).

v2 target layout (11 per observation): freq offsets H2-H6 in cents, decay
ratios H2-H6, ds_correction from the H2/H1 ratio. Inter-harmonic-SNR
masking (10 dB threshold), anomaly masking (H_{n+1} > H_n), tier weights
gold/silver/bronze = 1.0/0.6/0.3. Port of
`openwurli_tpu/calib/residuals.py` (NumPy; the port's own copy), whose
`assemble_batch` returns the port's `TrainBatch` of tensors. A rebuild of
ml/compute_residuals.py.
"""

from __future__ import annotations

import numpy as np

import torch

from openwurli_tpu_torch.calib.harmonics import decay_rate_db_per_s
from openwurli_tpu_torch.calib.notes import TIER_WEIGHTS
from openwurli_tpu_torch.calib.train import TrainBatch

N_FREQ = 5
N_DECAY = 5
N_TARGETS = 11
DS_IDX = 10
SNR_THRESHOLD_DB = 10.0
# Only H2/H3 decay targets are reliable (idx 0-1 in H2-H6 space);
# higher-harmonic decays are noise-dominated (compute_residuals.py:56-58).
MAX_RELIABLE_HARMONIC = 2

MIDI_MIN, MIDI_MAX = 21.0, 108.0


def bucket_velocity(velocity_norm, n_buckets=8):
    """Velocity bucket index (render_model_notes.py parity: 8 buckets)."""
    return int(np.clip(velocity_norm * n_buckets, 0, n_buckets - 1))


def compute_observation(real, model, midi_note, velocity_norm, tier,
                        real_snr_db=None):
    """One (real, model) feature pair → (inputs, targets, mask, weight).

    real/model: feature dicts from harmonics.extract_note_features (need
    f0_hz, windows['early_sustain'] dB amps, decay slopes per harmonic —
    here decay targeting uses the H1 decay ratio applied to H2/H3).
    """
    targets = np.full(N_TARGETS, np.nan)
    mask = np.zeros(N_TARGETS, dtype=bool)

    # Frequency offsets H2-H6: cents between real and model harmonic
    # centres. We compare refined f0 tracks: offset_h ≈ 1200·log2(f_real/f_model)
    # measured from the per-harmonic refined frequencies when available;
    # fall back to the f0 ratio (applies equally to all harmonics).
    f_ratio = real["f0_hz"] / max(model["f0_hz"], 1e-9)
    base_cents = 1200.0 * np.log2(max(f_ratio, 1e-9))
    for h in range(N_FREQ):
        targets[h] = base_cents
        mask[h] = abs(base_cents) < 100.0

    # Decay ratios H2-H6: real_decay / model_decay from the H1 decay slope
    # (the reference derives per-harmonic decays; H1-slope ratio is the
    # robust shared component), masked beyond MAX_RELIABLE_HARMONIC.
    rd = decay_rate_db_per_s(real["decay_db"], real["decay_times"])
    md = decay_rate_db_per_s(model["decay_db"], model["decay_times"])
    if np.isfinite(rd) and np.isfinite(md) and md > 0.1:
        ratio = rd / md
        for h in range(min(N_DECAY, MAX_RELIABLE_HARMONIC)):
            targets[N_FREQ + h] = ratio
            mask[N_FREQ + h] = 0.05 < ratio < 20.0

    # ds_correction from the H2/H1 ratio difference (early sustain window).
    rw = np.asarray(real["windows"]["early_sustain"])
    mw = np.asarray(model["windows"]["early_sustain"])
    if np.isfinite(rw[:2]).all() and np.isfinite(mw[:2]).all():
        real_h2h1 = rw[1] - rw[0]
        model_h2h1 = mw[1] - mw[0]
        delta_db = real_h2h1 - model_h2h1
        # +6 dB H2/H1 deficit ≈ ds × 2^(delta/6) per the v2 sign fix.
        targets[DS_IDX] = 2.0 ** (delta_db / 6.0)
        mask[DS_IDX] = 0.5 < targets[DS_IDX] < 2.0

    # SNR masking on the real observation's harmonics.
    if real_snr_db is not None:
        for h in range(N_FREQ):
            if real_snr_db[h + 1] < SNR_THRESHOLD_DB:  # H2.. indices 1..
                mask[h] = False
                if h < N_DECAY:
                    mask[N_FREQ + h] = False
        if real_snr_db[1] < SNR_THRESHOLD_DB:
            mask[DS_IDX] = False

    # Anomaly masking: ascending harmonic ladder in the real data.
    finite = np.isfinite(rw)
    for h in range(1, min(6, finite.sum())):
        if finite[h] and finite[h - 1] and rw[h] > rw[h - 1] + 6.0:
            if h - 1 < N_FREQ:
                mask[h - 1] = False

    inputs = np.array([
        np.clip((midi_note - MIDI_MIN) / (MIDI_MAX - MIDI_MIN), 0, 1),
        np.clip(velocity_norm, 0, 1),
    ])
    weight = TIER_WEIGHTS.get(tier, 0.3)
    targets = np.where(np.isfinite(targets), targets, 0.0)
    return inputs, targets, mask, weight


def assemble_batch(observations, device="cuda") -> TrainBatch:
    """List of compute_observation outputs → TrainBatch tensors on
    `device` (float64; the mask bool)."""
    inputs = np.stack([o[0] for o in observations])
    targets = np.stack([o[1] for o in observations])
    mask = np.stack([o[2] for o in observations])
    weights = np.asarray([o[3] for o in observations], np.float64)
    return TrainBatch(
        inputs=torch.from_numpy(inputs).to(device),
        targets=torch.from_numpy(targets).to(device),
        mask=torch.from_numpy(mask).to(device),
        weights=torch.from_numpy(weights).to(device),
    )
