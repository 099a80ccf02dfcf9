"""Single-voice note-on computation: tables → variation → dwell/onset →
velocity curve → MLP corrections → pickup + output scale.

Port of the pack-time half of `openwurli_tpu/voice.py`
(`note_on_params`, `init_state`, `default_note_seed`), float64 NumPy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from openwurli_tpu_torch import hammer, mlp, pickup, reed, tables, variation


class VoiceParams(NamedTuple):
    reed: reed.ReedParams
    noise: hammer.NoiseParams
    pickup: pickup.PickupParams
    post_pickup_gain: np.ndarray
    midi_note: np.ndarray


class VoiceState(NamedTuple):
    reed: reed.ReedState
    noise: hammer.NoiseState
    pickup_q: np.ndarray


def note_on_params(midi_note, velocity, sample_rate, mlp_enabled=True,
                   cfg: tables.CalibrationConfig = tables.CalibrationConfig(),
                   weights=None, displacement_scale=None):
    """All note-on parameters, batched. Returns (VoiceParams, detuned_hz)."""
    m, v = np.broadcast_arrays(np.asarray(midi_note, np.float64),
                               np.asarray(velocity, np.float64))
    params = tables.note_params(m)
    detuned = params["fundamental_hz"] * variation.freq_detune(m)

    dwell = hammer.dwell_attenuation(v, detuned, params["mode_ratios"])
    onset_time = hammer.onset_ramp_time(v, detuned)
    amplitudes = (params["mode_amplitudes"] * dwell
                  * variation.mode_amplitude_offsets(m))
    vel_scale = tables.velocity_scurve(v) ** tables.velocity_exponent(m)
    amplitudes = amplitudes * vel_scale[..., None]

    corr = mlp.infer(m, v, weights=weights, enabled=mlp_enabled)
    ratios = params["mode_ratios"].copy()
    ratios[..., 1:6] *= 2.0 ** (corr.freq_offsets_cents / 1200.0)
    decays = params["mode_decay_rates"].copy()
    decays[..., 1:6] /= corr.decay_offsets

    base_ds = tables.pickup_displacement_scale(m, cfg)
    corrected_ds = base_ds * corr.ds_correction
    if displacement_scale is not None:
        corrected_ds = np.broadcast_to(
            np.asarray(displacement_scale, np.float64), m.shape)

    reed_params = reed.make_params(detuned, ratios, amplitudes, decays,
                                   onset_time, v, sample_rate)

    # MLP level compensation: the sqrt of the RMS-proxy ratio restores the
    # level so that the MLP adjusts timbre only.
    f0 = tables.midi_to_freq(m)
    proxy_base = tables.pickup_rms_proxy(base_ds, f0)
    proxy_corr = tables.pickup_rms_proxy(corrected_ds, f0)
    comp = np.where(
        (np.abs(corr.ds_correction - 1.0) > 1e-6) & (proxy_corr > 1e-10),
        np.sqrt(proxy_base / np.maximum(proxy_corr, 1e-300)), 1.0)
    post_pickup_gain = tables.output_scale(m, v, cfg) * comp

    noise_params, _ = hammer.make_noise(v, detuned, sample_rate, 0)
    return VoiceParams(
        reed=reed_params, noise=noise_params,
        pickup=pickup.make_params(sample_rate, corrected_ds),
        post_pickup_gain=post_pickup_gain, midi_note=m), detuned


def init_state(vparams: VoiceParams, detuned_hz, velocity, sample_rate,
               noise_seed) -> VoiceState:
    """Per-voice note-on state; noise_seed seeds both the jitter
    Box-Muller stream and the attack-noise LCG."""
    _, noise_state = hammer.make_noise(np.asarray(velocity, np.float64),
                                       detuned_hz, sample_rate, noise_seed)
    return VoiceState(reed=reed.init_state(vparams.reed, noise_seed),
                      noise=noise_state,
                      pickup_q=pickup.init_state(vparams.midi_note.shape))


def default_note_seed(midi_note):
    """The reference's offline-render seed: midi * 2654435761 (wrapping)."""
    with np.errstate(over="ignore"):
        return (np.asarray(np.asarray(midi_note).astype(np.uint32))
                * np.uint32(2654435761))
