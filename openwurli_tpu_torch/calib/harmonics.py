"""Harmonic feature extraction from note audio (pipeline stage 3).

For each note: H1-H8 amplitudes at 3 time windows (attack, early_sustain,
sustain), H1 decay at 6 time points, spectral centroid, overshoot. Port of
`openwurli_tpu/calib/harmonics.py`: the segmenting and the FFT peak search
in NumPy on the host, the single-bin magnitudes through `goertzel` on
`device`. The dict schema is the reference's, so stage 3's and stage 4's
JSON files read alike.
"""

from __future__ import annotations

import numpy as np

from openwurli_tpu_torch.calib import goertzel

WINDOWS = {
    "attack": (0.000, 0.050, 0.100),
    "early_sustain": (0.050, 0.200, 0.250),
    "sustain": (0.200, 0.800, 0.500),
}
DECAY_TIMES = [0.1, 0.3, 0.5, 0.8, 1.0, 1.5]
N_HARMONICS = 8
DECAY_WIN_S = 0.05


def amps_to_db(amps, floor=1e-12):
    return 20.0 * np.log10(np.maximum(np.asarray(amps), floor))


def _mags(seg, freqs, sr, device):
    return goertzel.dft_magnitude(np.asarray(seg), np.asarray(freqs), sr,
                                  device).cpu().numpy()


def refine_f0_fft(audio, sr, f0_nominal, search_cents=100):
    """FFT peak search around the nominal f0: the 4×-zero-padded rfft's
    peak within ±search_cents."""
    n = len(audio)
    spec = np.abs(np.fft.rfft(np.asarray(audio) * np.hanning(n), 4 * n))
    freqs = np.fft.rfftfreq(4 * n, 1.0 / sr)
    lo = f0_nominal * 2 ** (-search_cents / 1200)
    hi = f0_nominal * 2 ** (search_cents / 1200)
    mask = (freqs >= lo) & (freqs <= hi)
    if not mask.any():
        return f0_nominal
    idx = np.argmax(np.where(mask, spec, 0.0))
    return float(freqs[idx])


def extract_note_features(audio, sr, f0_nominal, onset_s=0.0,
                          duration_s=None, device="cuda"):
    """Features for one note segment starting at onset_s.

    Returns dict: f0_hz, windows{name: amps_db[8]}, decay_db[6] (H1 level
    at DECAY_TIMES), centroid_attack/sustain, overshoot_db.
    """
    audio = np.asarray(audio, dtype=np.float64)
    start = int(onset_s * sr)
    seg = audio[start:]
    if duration_s is not None:
        seg = seg[: int(duration_s * sr)]
    total_s = len(seg) / sr

    # refine f0 on the early sustain portion
    ref_seg = seg[int(0.05 * sr): int(min(0.8, total_s) * sr)]
    f0 = refine_f0_fft(ref_seg if len(ref_seg) > 256 else seg, sr, f0_nominal)
    harm = f0 * np.arange(1, N_HARMONICS + 1)

    windows = {}
    for name, (w0, w1, min_dur) in WINDOWS.items():
        if total_s < min_dur:
            windows[name] = [float("nan")] * N_HARMONICS
            continue
        w = seg[int(w0 * sr): int(w1 * sr)]
        windows[name] = list(amps_to_db(_mags(w, harm, sr, device)))

    decay_db = []
    for t in DECAY_TIMES:
        if t + DECAY_WIN_S > total_s:
            decay_db.append(float("nan"))
            continue
        w = seg[int(t * sr): int((t + DECAY_WIN_S) * sr)]
        mag = float(_mags(w, [f0], sr, device)[0])
        decay_db.append(float(amps_to_db(mag)))

    def centroid(w):
        spec = np.abs(np.fft.rfft(w))
        freqs = np.fft.rfftfreq(len(w), 1.0 / sr)
        return float((spec * freqs).sum() / max(spec.sum(), 1e-12))

    attack_w = seg[: int(0.05 * sr)]
    sustain_w = seg[int(0.2 * sr): int(min(0.8, total_s) * sr)]
    centroid_attack = centroid(attack_w) if len(attack_w) else float("nan")
    centroid_sustain = centroid(sustain_w) if len(sustain_w) else float("nan")

    peak_early = np.abs(seg[: int(0.010 * sr)]).max() if len(seg) else 0.0
    sus = seg[int(0.1 * sr): int(0.2 * sr)]
    sus_rms = np.sqrt((sus**2).mean()) if len(sus) else 1e-12
    overshoot_db = float(20 * np.log10(max(peak_early, 1e-12)
                                       / max(sus_rms, 1e-12)))

    return {
        "f0_hz": f0,
        "windows": windows,
        "decay_db": decay_db,
        "decay_times": DECAY_TIMES,
        "centroid_attack_hz": centroid_attack,
        "centroid_sustain_hz": centroid_sustain,
        "overshoot_db": overshoot_db,
    }


def decay_rate_db_per_s(decay_db, decay_times):
    """Least-squares slope of H1 level vs time over valid points."""
    t = np.asarray(decay_times)
    y = np.asarray(decay_db)
    ok = np.isfinite(y)
    if ok.sum() < 2:
        return float("nan")
    t, y = t[ok], y[ok]
    slope = np.polyfit(t, y, 1)[0]
    return float(-slope)  # positive = decaying


def measure_interharmonic_snr(audio, sr, f0, n_harmonics=N_HARMONICS,
                              window=(0.05, 0.20), device="cuda"):
    """Harmonic SNR: magnitude at h·f0 vs noise at (h+0.5)·f0, in dB."""
    seg = np.asarray(audio[int(window[0] * sr): int(window[1] * sr)])
    hs = np.arange(1, n_harmonics + 1)
    sig = _mags(seg, hs * f0, sr, device)
    noise = _mags(seg, (hs + 0.5) * f0, sr, device)
    return 20.0 * np.log10(np.maximum(sig, 1e-15)
                           / np.maximum(noise, 1e-15))
