#!/usr/bin/env python3
"""Recording analysis: note extraction + aggregate statistics.

The PyTorch port's copy of tools/recording_analyzer.py, on the port's
`calib.notes`, `calib.harmonics` (their tensor work on `--device`) and
`io.wav`:

  Tier 1: onset detection + pitch tracking + isolation scoring → chop
          clean notes to WAV files
  Tier 2: aggregate stats — tremolo rate/depth/confidence (bandpassed
          RMS-envelope autocorrelation), per-octave decay rates, H2/H1
          ratios and spectral centroids, velocity estimates by note

Usage:
    python tools/torch_recording_analyzer.py extract rec.wav -o /tmp/notes/
    python tools/torch_recording_analyzer.py stats rec1.wav rec2.wav ...
    python tools/torch_recording_analyzer.py full rec.wav -o /tmp/notes/
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#",
              "B"]


def midi_to_name(midi):
    return f"{NOTE_NAMES[int(midi) % 12]}{int(midi) // 12 - 1}"


def detect_tremolo(audio, sr, min_rate=3.0, max_rate=9.0):
    """Tremolo rate/depth/confidence from the RMS envelope's
    autocorrelation in the 3-9 Hz band (reference detect_tremolo)."""
    hop = 256
    frame = 2048
    n = (len(audio) - frame) // hop
    if n < 10:
        return None
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt((audio[idx] ** 2).mean(axis=1))
    rms_sr = sr / hop
    if len(rms) < int(rms_sr * 2):
        return None

    # 2nd-order butterworth bandpass via bilinear transform (no scipy).
    def butter_bandpass(x, lo, hi, fs):
        # cascade: 1-pole HPF at lo, 1-pole LPF at hi, applied twice
        # forward+backward for zero phase (filtfilt-style).
        def onepass(x):
            a_h = np.exp(-2 * np.pi * lo / fs)
            a_l = np.exp(-2 * np.pi * hi / fs)
            y = np.empty_like(x)
            s = x[0]
            for i, v in enumerate(x):  # LPF
                s += (1 - a_l) * (v - s)
                y[i] = s
            z = np.empty_like(y)
            prev_in = y[0]
            s = 0.0
            for i, v in enumerate(y):  # HPF
                s = a_h * (s + v - prev_in)
                prev_in = v
                z[i] = s
            return z

        return onepass(onepass(x)[::-1])[::-1]

    filt = butter_bandpass(rms - rms.mean(), min_rate, max_rate, rms_sr)
    c = filt - filt.mean()
    corr = np.correlate(c, c, mode="full")[len(c) - 1:]
    corr = corr / (corr[0] + 1e-10)
    min_lag = max(1, int(rms_sr / max_rate))
    max_lag = min(len(corr) - 1, int(rms_sr / min_rate))
    if max_lag <= min_lag + 2:
        return None
    search = corr[min_lag:max_lag]
    peak = int(np.argmax(search)) + min_lag
    if corr[peak] < 0.15:
        return None
    depth_linear = np.std(filt) * 2 * np.sqrt(2) / (np.mean(rms) + 1e-10)
    return {
        "rate_hz": round(float(rms_sr / peak), 2),
        "depth_db": round(float(20 * np.log10(1 + depth_linear + 1e-10)),
                          1),
        "confidence": round(float(corr[peak]), 3),
    }


def estimate_velocity(seg, sr):
    """Attack peak (first 50 ms) → rough 0-1 velocity proxy."""
    atk = seg[: int(0.05 * sr)]
    if not len(atk):
        return 0.0
    return float(np.clip(np.abs(atk).max() * 3.0, 0.0, 1.0))


def spectral_centroid(seg, sr):
    win = np.hanning(len(seg))
    spec = np.abs(np.fft.rfft(seg * win))
    freqs = np.fft.rfftfreq(len(seg), 1 / sr)
    return float((spec * freqs).sum() / (spec.sum() + 1e-12))


def _summ(vals):
    v = np.asarray(vals, dtype=float)
    return {"mean": round(float(v.mean()), 3),
            "std": round(float(v.std()), 3),
            "median": round(float(np.median(v)), 3), "n": len(v)}


def windowed_h2h1(audio, sr, notes_mod, harmonics_mod,
                  window_s=0.5, hop_s=0.25, device="cuda"):
    """No-extracted-notes fallback (reference aggregate_stats else-branch):
    pitch-track 0.5 s windows, keep stable-pitch ones, aggregate H2/H1
    by octave."""
    win = int(window_s * sr)
    hop = int(hop_s * sr)
    by_octave = {}
    for start in range(0, max(len(audio) - win, 0), hop):
        seg = audio[start:start + win]
        f0, midi_f = notes_mod.estimate_pitch(seg, sr)
        if not np.isfinite(f0) or f0 <= 0:
            continue
        # stability: both halves must agree within 5 % (the reference
        # skips unstable-pitch windows)
        fa, _ = notes_mod.estimate_pitch(seg[:win // 2], sr)
        fb, _ = notes_mod.estimate_pitch(seg[win // 2:], sr)
        if not (np.isfinite(fa) and np.isfinite(fb)
                and abs(fa - fb) < 0.05 * f0):
            continue
        midi = int(round(midi_f))
        f = harmonics_mod.extract_note_features(seg, sr, f0, 0.0,
                                                window_s, device=device)
        w = np.asarray(f["windows"]["early_sustain"])
        if len(w) >= 2 and np.isfinite(w[0]) and np.isfinite(w[1]):
            by_octave.setdefault(midi // 12 - 1, []).append(
                float(w[1] - w[0]))
    return {str(k): _summ(v) for k, v in sorted(by_octave.items())}


def aggregate_stats(audio, sr, notes, harmonics_mod, notes_mod=None,
                    device="cuda"):
    stats = {"tremolo": detect_tremolo(audio, sr)}
    if not notes and notes_mod is not None:
        stats["h2_h1_db_windowed"] = windowed_h2h1(
            audio, sr, notes_mod, harmonics_mod, device=device)
        return stats
    by_octave = {}
    velocities = {}
    for n in notes:
        onset = int(n["onset_s"] * sr)
        dur = int((n["offset_s"] - n["onset_s"]) * sr)
        seg = audio[onset:onset + dur]
        if len(seg) < int(0.2 * sr):
            continue
        octave = int(n["midi_note"]) // 12 - 1
        o = by_octave.setdefault(octave, {"decay": [], "h2h1": [],
                                          "centroid": []})
        f = harmonics_mod.extract_note_features(audio, sr, n["f0_hz"],
                                                n["onset_s"],
                                                n["offset_s"]
                                                - n["onset_s"],
                                                device=device)
        d = harmonics_mod.decay_rate_db_per_s(f["decay_db"],
                                              f["decay_times"])
        if np.isfinite(d):
            o["decay"].append(float(d))
        w = np.asarray(f["windows"]["early_sustain"])
        if len(w) >= 2 and np.isfinite(w[0]) and np.isfinite(w[1]):
            o["h2h1"].append(float(w[1] - w[0]))
        o["centroid"].append(spectral_centroid(seg, sr))
        velocities.setdefault(midi_to_name(n["midi_note"]), []).append(
            estimate_velocity(seg, sr))

    stats["by_octave"] = {
        str(k): {m: _summ(v) for m, v in o.items() if v}
        for k, o in sorted(by_octave.items())}
    stats["velocities"] = {
        k: {**_summ(v),
            "range": [round(float(min(v)), 3), round(float(max(v)), 3)]}
        for k, v in sorted(velocities.items())}
    return stats


def extract_to_dir(audio, sr, notes, out_dir, wav_mod):
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, n in enumerate(notes):
        onset = int(n["onset_s"] * sr)
        dur = int((n["offset_s"] - n["onset_s"]) * sr)
        seg = audio[onset:onset + dur]
        if len(seg) < int(0.2 * sr):
            continue
        name = (f"{i:03d}_{midi_to_name(n['midi_note'])}"
                f"_{n['tier']}.wav")
        path = os.path.join(out_dir, name)
        wav_mod.write_wav(path, seg, sr, bits=24)
        written.append({**{k: n[k] for k in
                           ("midi_note", "f0_hz", "onset_s", "offset_s",
                            "tier", "isolation_score")},
                        "file": name})
    with open(os.path.join(out_dir, "notes.json"), "w") as f:
        json.dump(written, f, indent=1)
    return written


def print_report(path, audio, sr, found, scored, stats):
    print(f"file: {path} ({len(audio)/sr:.1f}s @ {sr} Hz)")
    print(f"notes: {len(found)} found, {len(scored)} usable")
    tiers = {t: sum(1 for n in scored if n["tier"] == t)
             for t in ("gold", "silver", "bronze")}
    print(f"tiers: {tiers}")
    trem = stats.get("tremolo")
    if trem:
        print(f"tremolo: {trem['rate_hz']} Hz, {trem['depth_db']} dB "
              f"(confidence {trem['confidence']})")
    else:
        print("tremolo: none detected")
    # note-distribution histogram (reference print_report)
    from collections import Counter

    counts = Counter(midi_to_name(n["midi_note"]) for n in scored)
    if counts:
        print("notes found (by pitch):")
        for name, cnt in sorted(counts.items()):
            print(f"  {name:>4s}: {'#' * min(cnt, 40)} ({cnt})")
    # top 10 cleanest extractions
    top = sorted(scored, key=lambda n: -n.get("isolation_score", 0))[:10]
    if top:
        print("top cleanest extractions:")
        print(f"  {'note':>5s} {'iso':>6s} {'onset':>8s} {'dur':>6s}")
        for n in top:
            print(f"  {midi_to_name(n['midi_note']):>5s} "
                  f"{n.get('isolation_score', 0):6.3f} "
                  f"{n['onset_s']:8.2f} "
                  f"{n['offset_s'] - n['onset_s']:6.2f}")
    for octv, o in stats.get("by_octave", {}).items():
        parts = [f"{m} {v['mean']}±{v['std']} (n={v['n']})"
                 for m, v in o.items()]
        print(f"  octave {octv}: " + ", ".join(parts))
    for octv, v in stats.get("h2_h1_db_windowed", {}).items():
        print(f"  octave {octv} (windowed): H2/H1 {v['mean']}±{v['std']} dB"
              f" (n={v['n']})")
    if stats.get("velocities"):
        vs = stats["velocities"]
        meds = [v["median"] for v in vs.values()]
        print(f"velocity estimates: {len(vs)} notes, "
              f"median {np.median(meds):.2f}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["extract", "stats", "full"])
    p.add_argument("recordings", nargs="+")
    p.add_argument("-o", "--output-dir", default="/tmp/extracted")
    p.add_argument("--json", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from openwurli_tpu_torch.calib import harmonics, notes as notes_mod
    from openwurli_tpu_torch.io import wav

    reports = []
    for path in args.recordings:
        audio, sr = wav.read_wav(path)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        found = notes_mod.extract_notes(audio, sr, device=args.device)
        scored = notes_mod.score_isolation(found, audio, sr)
        stats = {}
        if args.mode in ("stats", "full"):
            stats = aggregate_stats(audio, sr, scored, harmonics,
                                    notes_mod=notes_mod, device=args.device)
        if args.mode in ("extract", "full"):
            extract_to_dir(audio, sr, scored, args.output_dir, wav)
            print(f"extracted {len(scored)} notes → {args.output_dir}")
        print_report(path, audio, sr, found, scored, stats)
        reports.append({"file": path, "notes": scored, "stats": stats})

    if args.json:
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=1)
        print(f"→ {args.json}")


if __name__ == "__main__":
    main()
