"""Gain-chain calibration sweep — 5 tap points over a note×velocity grid.

Port of `openwurli_tpu/calib/calibrate.py`, the rebuild of `preamp-bench
calibrate` (reference tools/preamp-bench/src/main.rs:1069-1258): per
(note, velocity) the chain is measured at taps T1 (raw reed) → T2
(+pickup) → T3 (+output_scale) → T4 (+2× oversampled DK preamp at R_ldr =
1 MΩ) → T5 (+vol² + power amp + speaker + POST_SPEAKER_GAIN), reporting
peak / RMS / H2-H1 per tap. The whole grid renders at once (BASELINE
config 4: all 64 keys × 8 velocities), a stream per (note, velocity):

  * host packing (`pack_taps`, float64 NumPy): the reeds' note-on
    parameters and states, the pickups' displacement scales, the output
    scales;
  * T1 and T2: kernel E4<tap> (`kernels/render.voice_tap`), the reed and
    its pickup, the reed's samples kept;
  * T3: T2 × output_scale, elementwise;
  * T4: kernel E5<dk> through `di.preamp_di`;
  * T5: kernel E6 (`kernels/render.pa_speaker_scan`) at the base rate;
  * the metrics, float64 on the device.

On the CPU each kernel is its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch import di, hammer, pickup, reed, tables, variation
from openwurli_tpu_torch import voice
from openwurli_tpu_torch.calib import goertzel
from openwurli_tpu_torch.kernels import render as kr
from openwurli_tpu_torch.ops import exact

BASE_SR = 44_100.0
DURATION_S = 0.5
MEASURE_START_S = 0.100
MEASURE_END_S = 0.400


class TapInputs(NamedTuple):
    """One grid's host-packed inputs, a column per stream."""

    cols: tuple          # E4's (vpar, vst, vsti) on the device
    freq: torch.Tensor   # (G,) nominal fundamentals
    ds_actual: torch.Tensor  # (G,) pickup displacement scales
    out_scale: torch.Tensor  # (G,) output scales
    trim: np.ndarray     # (G,) register trims (dB)


def pack_taps(g, v, cfg: tables.CalibrationConfig, device="cuda"):
    """Flat notes g and normalised velocities v (G,) → TapInputs: the raw
    reed (onset time 0, no MLP, the canonical offline seed) and its
    pickup, in float64 NumPy, moved to `device`."""
    params = tables.note_params(g)
    freq = params["fundamental_hz"]
    ds_actual = tables.pickup_displacement_scale(g, cfg)
    detuned = freq * variation.freq_detune(g)
    dwell = hammer.dwell_attenuation(v, detuned, params["mode_ratios"])
    amp_offsets = variation.mode_amplitude_offsets(g)
    vel_scale = tables.velocity_scurve(v) ** tables.velocity_exponent(g)
    amplitudes = (params["mode_amplitudes"] * dwell * amp_offsets
                  * vel_scale[..., None])
    reed_params = reed.make_params(
        detuned, params["mode_ratios"], amplitudes,
        params["mode_decay_rates"], np.zeros_like(v), v, BASE_SR)
    reed_state = reed.init_state(reed_params, voice.default_note_seed(g))
    cols = kr.tap_columns(reed_params, reed_state,
                          pickup.make_params(BASE_SR, ds_actual), device)
    trim = np.where(cfg.zero_trim, 0.0, tables.register_trim_db(g))

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float64)).to(device)

    return TapInputs(cols, t(freq), t(ds_actual),
                     t(tables.output_scale(g, v, cfg)),
                     np.broadcast_to(trim, g.shape))


def _window(buf):
    a = int(MEASURE_START_S * BASE_SR)
    b = int(MEASURE_END_S * BASE_SR)
    return buf[a:b]


def _db(x):
    return 20.0 * torch.log10(exact.maximum(x, 1e-300))


def _peak_db(x):
    return _db(torch.amax(torch.abs(x), dim=0))


def _rms_db(x):
    return _db(torch.sqrt(torch.mean(x * x, dim=0)))


def _h2_h1_db(x, f0):
    mags = goertzel.dft_magnitude(x.T, torch.stack([f0, 2.0 * f0], dim=-1),
                                  BASE_SR)
    return 20.0 * torch.log10(exact.maximum(mags[..., 1], 1e-300)
                              / exact.maximum(mags[..., 0], 1e-300))


def run_calibrate(notes, velocities,
                  cfg: tables.CalibrationConfig = tables.CalibrationConfig(),
                  volume=0.40, speaker_char=1.0, mlp=False, device="cuda"):
    """Run the full calibrate grid in one batched pass on `device`.

    notes: (Nn,) MIDI ints; velocities: (Nv,) MIDI velocity bytes.
    Returns a dict of (Nn, Nv)-shaped NumPy arrays (CSV-ready).
    """
    notes = np.asarray(notes, dtype=np.float64)
    vel_bytes = np.asarray(velocities, dtype=np.float64)
    m = np.broadcast_to(notes[:, None],
                        (notes.shape[0], vel_bytes.shape[0]))
    vel = np.broadcast_to(vel_bytes[None, :] / 127.0, m.shape)
    grid_shape = m.shape
    g = m.reshape(-1)
    v = vel.reshape(-1)
    n_samples = int(DURATION_S * BASE_SR)

    taps = pack_taps(g, v, cfg, device)
    # ── T1, T2: the reed and its pickup (E4<tap>) ──
    t2_buf, reed_buf = kr.voice_tap(*taps.cols, n_samples)
    reed_peak = torch.amax(torch.abs(_window(reed_buf)), dim=0)
    y_peak = reed_peak * taps.ds_actual
    # ── T3: output_scale ──
    t3_buf = t2_buf * taps.out_scale
    # ── T4: 2× oversampled DK preamp at R_ldr = 1 MΩ (E5<dk>) ──
    t4_buf = di.preamp_di(t3_buf, BASE_SR, device=device)
    # ── T5: vol² (audio taper) → power amp → speaker → PSG (E6) ──
    state = kr.init_pa_speaker_state(BASE_SR, g.shape[0], device)
    t5_buf = kr.pa_speaker_scan(BASE_SR, t4_buf, state, volume, speaker_char)

    # ── metrics ──
    t2w, t3w, t4w, t5w = map(_window, (t2_buf, t3_buf, t4_buf, t5_buf))
    t3_rms = _rms_db(t3w)
    t4_pk, t5_pk = _peak_db(t4w), _peak_db(t5w)
    freq = taps.freq

    def r(x):
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        return x.reshape(grid_shape)

    return {
        "midi": r(g),
        "velocity": r(v * 127.0),
        "ds_at_c4": np.full(grid_shape, cfg.ds_at_c4),
        "ds_actual": r(taps.ds_actual),
        "y_peak": r(y_peak),
        "t2_peak_db": r(_peak_db(t2w)),
        "t2_rms_db": r(_rms_db(t2w)),
        "t2_h2_h1_db": r(_h2_h1_db(t2w, freq)),
        "t3_peak_db": r(_peak_db(t3w)),
        "t3_rms_db": r(t3_rms),
        "t4_peak_db": r(t4_pk),
        "t4_rms_db": r(_rms_db(t4w)),
        "t4_h2_h1_db": r(_h2_h1_db(t4w, freq)),
        "t5_peak_db": r(t5_pk),
        "t5_rms_db": r(_rms_db(t5w)),
        "t5_h2_h1_db": r(_h2_h1_db(t5w, freq)),
        "proxy_db": r(20.0 * torch.log10(taps.out_scale)),
        "trim_db": r(taps.trim),
        "proxy_error_db": r(t3_rms - cfg.target_db),
        "tanh_compression_db": r(t4_pk - t5_pk),
    }


_NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]


def midi_note_name(midi):
    midi = int(midi)
    return f"{_NOTE_NAMES[midi % 12]}{midi // 12 - 1}"


def write_calibrate_csv(path, rows):
    """CSV with the reference's 21-column layout (main.rs:1266-1279)."""
    cols = ["midi", "velocity", "ds_at_c4", "ds_actual", "y_peak",
            "t2_peak_db", "t2_rms_db", "t2_h2_h1_db",
            "t3_peak_db", "t3_rms_db",
            "t4_peak_db", "t4_rms_db", "t4_h2_h1_db",
            "t5_peak_db", "t5_rms_db", "t5_h2_h1_db",
            "proxy_db", "trim_db", "proxy_error_db", "tanh_compression_db"]
    with open(path, "w") as f:
        f.write("midi,note_name,velocity,ds_at_c4,ds_actual,y_peak,"
                "t2_peak_db,t2_rms_db,t2_h2_h1_db,"
                "t3_peak_db,t3_rms_db,"
                "t4_peak_db,t4_rms_db,t4_h2_h1_db,"
                "t5_peak_db,t5_rms_db,t5_h2_h1_db,"
                "proxy_db,trim_db,proxy_error_db,tanh_compression_db\n")
        shape = rows["midi"].shape
        for i in range(shape[0]):
            for j in range(shape[1]):
                vals = [rows[c][i, j] for c in cols]
                midi = int(vals[0])
                f.write(f"{midi},{midi_note_name(midi)},{int(round(vals[1]))},"
                        + ",".join(f"{x:.4f}" for x in vals[2:5]) + ","
                        + ",".join(f"{x:.2f}" for x in vals[5:]) + "\n")
