"""Note extraction + isolation scoring from recordings (stages 1-2).

Port of `openwurli_tpu/calib/notes.py` (NumPy; the port's own copy), whose
`extract_notes` calls the port's onset model. A rebuild of
ml/extract_notes.py + ml/score_isolation.py without the basic-pitch /
librosa dependencies: onsets from a spectral-flux envelope, pitch from an FFT-peak/harmonic-product estimate,
then the reference's 4-sub-score isolation model (temporal / harmonic-
collision / energy / duration) mapped to gold/silver/bronze tiers.
"""

from __future__ import annotations

import numpy as np

TIER_WEIGHTS = {"gold": 1.0, "silver": 0.6, "bronze": 0.3}


def _frame(audio, frame, hop):
    n = 1 + max(0, (len(audio) - frame)) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    return audio[idx]


def detect_onsets(audio, sr, frame=2048, hop=512, threshold_rel=0.15):
    """Spectral-flux onset detection. Returns onset times in seconds."""
    frames = _frame(np.asarray(audio, dtype=np.float64), frame, hop)
    spec = np.abs(np.fft.rfft(frames * np.hanning(frame), axis=1))
    flux = np.maximum(np.diff(spec, axis=0), 0.0).sum(axis=1)
    if len(flux) == 0:
        return np.zeros(0)
    flux = flux / max(flux.max(), 1e-12)
    thr = threshold_rel + np.convolve(flux, np.ones(16) / 16, mode="same")
    peaks = []
    for i in range(1, len(flux) - 1):
        if flux[i] > thr[i] and flux[i] >= flux[i - 1] and flux[i] > flux[i + 1]:
            if not peaks or (i - peaks[-1]) * hop / sr > 0.05:
                peaks.append(i)
    return (np.asarray(peaks) * hop + frame // 2) / sr


def estimate_pitch(audio, sr, fmin=50.0, fmax=2200.0):
    """Pitch via harmonic-sum scoring of spectral-peak candidates.

    Each strong spectral peak (and its /2, /3 subharmonics) is scored by
    the summed log-magnitude at its first 6 harmonics — robust against the
    strong-H2 "bark" spectra where plain peak-pick or HPS octave-errs.
    Skips the attack transient. Returns (f0_hz, midi_float).
    """
    x = np.asarray(audio, dtype=np.float64)
    x = x[int(0.1 * sr):]  # skip attack noise
    n = len(x)
    if n < 1024:
        return float("nan"), float("nan")
    spec = np.abs(np.fft.rfft(x * np.hanning(n), 4 * n))
    freqs = np.fft.rfftfreq(4 * n, 1.0 / sr)
    df = freqs[1]

    def mag_at(f):
        idx = int(round(f / df))
        if idx < 1 or idx >= len(spec) - 1:
            return 1e-12
        return spec[idx - 1:idx + 2].max()

    band = (freqs >= fmin) & (freqs <= fmax * 3)
    idx_peak = np.argmax(np.where(band, spec, 0.0))
    peak_f = freqs[idx_peak]
    candidates = [peak_f / k for k in (1, 2, 3, 4)]
    # Also consider the lowest strong peak as a direct candidate.
    thresh = spec[idx_peak] * 0.05
    strong = np.where(band & (spec > thresh))[0]
    if len(strong):
        candidates.append(freqs[strong[0]])

    best_f, best_score = float("nan"), -np.inf
    for f in candidates:
        if not (fmin <= f <= fmax):
            continue
        score = sum(np.log(mag_at(k * f) + 1e-12) for k in range(1, 7))
        # Require the fundamental itself to be present.
        if mag_at(f) < thresh * 0.2:
            score -= 50.0
        if score > best_score:
            best_f, best_score = f, score
    if not np.isfinite(best_f):
        return float("nan"), float("nan")
    midi = 69.0 + 12.0 * np.log2(best_f / 440.0)
    return float(best_f), float(midi)


def extract_notes(audio, sr, min_duration=0.25, method="auto",
                  device="cuda"):
    """Segment a recording into note observations.

    method: "auto" (default) tries the trained onset/pitch network
    (calib.onset_model, the reference's basic-pitch role) and falls
    back to the spectral path when no weights are installed or it
    finds nothing — the network earns the default on measured recovery
    (round-4 validation mixtures, 4 notes at −12..0 dB: NN 61/104
    recovered with 15 spurious vs spectral 21/104 with 101 spurious;
    tools/train_onset_model.py prints both). "nn" forces the network;
    "spectral" forces the spectral-flux/harmonic-sum path below.

    The network runs on `device`. Returns a list of dicts: onset_s,
    offset_s, midi_note, f0_hz, velocity_norm (peak-based proxy).
    """
    if method in ("auto", "nn"):
        from openwurli_tpu_torch.calib import onset_model

        found = onset_model.nn_extract_notes(audio, sr,
                                             min_duration=min_duration,
                                             device=device)
        if found or method == "nn":
            return found
    audio = np.asarray(audio, dtype=np.float64)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)
    onsets = detect_onsets(audio, sr)
    notes = []
    bounds = list(onsets) + [len(audio) / sr]
    peak_global = max(np.abs(audio).max(), 1e-12)
    for i, onset in enumerate(onsets):
        offset = bounds[i + 1]
        if offset - onset < min_duration:
            continue
        seg = audio[int(onset * sr): int(offset * sr)]
        f0, midi = estimate_pitch(seg[: int(0.5 * sr)], sr)
        if not np.isfinite(midi):
            continue
        vel = float(np.abs(seg[: int(0.05 * sr)]).max() / peak_global)
        notes.append({
            "onset_s": float(onset),
            "offset_s": float(offset),
            "midi_note": int(round(midi)),
            "f0_hz": f0,
            "velocity_norm": min(vel, 1.0),
        })
    return notes


def score_isolation(notes, audio, sr):
    """4-sub-score isolation model → tier (score_isolation.py parity).

    temporal: gap to neighbouring onsets; harmonic collision: other
    concurrent notes whose harmonics land near ours; energy: note level vs
    recording; duration: longer = better decay measurements.
    """
    scored = []
    onsets = np.asarray([n["onset_s"] for n in notes])
    for i, note in enumerate(notes):
        dur = note["offset_s"] - note["onset_s"]

        prev_gap = (note["onset_s"] - onsets[i - 1]) if i > 0 else 10.0
        next_gap = (onsets[i + 1] - note["onset_s"]) if i + 1 < len(onsets) else 10.0
        temporal = min(1.0, min(prev_gap, next_gap) / 1.0)

        f0 = note["f0_hz"]
        collision = 0.0
        for j, other in enumerate(notes):
            if j == i:
                continue
            overlap = (min(note["offset_s"], other["offset_s"])
                       - max(note["onset_s"], other["onset_s"]))
            if overlap <= 0:
                continue
            for h in range(1, 9):
                for k in range(1, 9):
                    if abs(h * f0 - k * other["f0_hz"]) < 0.03 * h * f0:
                        collision += overlap / dur
                        break
        harmonic = 1.0 / (1.0 + collision)

        seg = audio[int(note["onset_s"] * sr): int(note["offset_s"] * sr)]
        energy = min(1.0, float(np.sqrt((seg**2).mean()))
                     / max(float(np.sqrt((audio**2).mean())), 1e-12))

        duration = min(1.0, dur / 1.5)

        score = 0.35 * temporal + 0.35 * harmonic + 0.1 * energy + 0.2 * duration
        tier = ("gold" if score > 0.8 else
                "silver" if score > 0.55 else
                "bronze" if score > 0.3 else "reject")
        scored.append({**note, "isolation_score": float(score), "tier": tier,
                       "sub_scores": {"temporal": temporal,
                                      "harmonic": harmonic,
                                      "energy": energy,
                                      "duration": duration}})
    return [n for n in scored if n["tier"] != "reject"]
