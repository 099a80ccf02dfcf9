#!/usr/bin/env python3
"""A/B real-vs-model comparison — the accuracy oracle.

The PyTorch port's copy of tools/wurli_compare.py: select the best
isolated notes of a real recording (`calib.notes`), render matching notes
through the port's DI chain (`di.render_di`: kernels E4 and E5<dk> on the
card), and report per-note harmonic / decay / centroid deltas
(`calib.harmonics`) and a JSON report.

    python tools/torch_wurli_compare.py recording.wav --output report.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("recording")
    p.add_argument("--output", default="/tmp/wurli_compare.json")
    p.add_argument("--max-notes", type=int, default=12)
    p.add_argument("--top-per-pitch", type=int, default=3,
                   help="cap per MIDI pitch so one note can't dominate")
    p.add_argument("--notes", default="",
                   help="comma-separated MIDI numbers to compare only")
    p.add_argument("--model-seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from openwurli_tpu_torch import di
    from openwurli_tpu_torch.calib import harmonics, notes as notes_mod
    from openwurli_tpu_torch.io import wav

    audio, sr = wav.read_wav(args.recording)
    if audio.ndim > 1:
        audio = audio.mean(axis=1)

    found = notes_mod.extract_notes(audio, sr, device=args.device)
    scored = notes_mod.score_isolation(found, audio, sr)
    scored.sort(key=lambda n: -n["isolation_score"])
    if args.notes:
        want = {int(x) for x in args.notes.split(",")}
        scored = [n for n in scored if n["midi_note"] in want]
    # reference select_best_notes: at most top_per_pitch per MIDI note
    per_pitch = {}
    selected = []
    for n in scored:
        cnt = per_pitch.get(n["midi_note"], 0)
        if cnt < args.top_per_pitch:
            selected.append(n)
            per_pitch[n["midi_note"]] = cnt + 1
        if len(selected) >= args.max_notes:
            break
    print(f"{len(found)} notes found, comparing best {len(selected)}")

    if not selected:
        print("no usable notes")
        return

    midis = np.asarray([n["midi_note"] for n in selected], dtype=np.float64)
    vels = np.asarray([max(n["velocity_norm"], 0.3) for n in selected])
    # DI chain INCLUDING the 2x-oversampled preamp (the reference
    # compares the DI path, tools/wurli_compare.py + render_model_notes).
    model_audio = di.render_di(midis, vels, args.model_seconds, float(sr),
                               mlp_enabled=True, device=args.device)

    def attack_time_s(seg, sr_, threshold_db=-10.0):
        # time from onset to within threshold of the peak (ref
        # measure_attack_time)
        env = np.abs(seg[: int(0.3 * sr_)])
        if not len(env):
            return float("nan")
        peak = env.max() + 1e-12
        thresh = peak * 10 ** (threshold_db / 20)
        above = np.nonzero(env >= thresh)[0]
        return float(above[0] / sr_) if len(above) else float("nan")

    report = []
    for k, n in enumerate(selected):
        real = harmonics.extract_note_features(
            audio, sr, n["f0_hz"], n["onset_s"],
            n["offset_s"] - n["onset_s"], device=args.device)
        model = harmonics.extract_note_features(
            model_audio[:, k], sr, n["f0_hz"], device=args.device)

        # relative harmonic ladders in all three analysis windows
        h_windows = {}
        for wname in real["windows"]:
            rw_ = np.asarray(real["windows"][wname])
            mw_ = np.asarray(model["windows"].get(wname, rw_ * np.nan))
            h_windows[wname] = [
                float(r - m) if np.isfinite(r) and np.isfinite(m)
                else None
                for r, m in zip(rw_ - rw_[0], mw_ - mw_[0])]
        rw = np.asarray(real["windows"]["early_sustain"])
        mw = np.asarray(model["windows"]["early_sustain"])
        h_delta = h_windows["early_sustain"]

        onset = int(n["onset_s"] * sr)
        seg_real = audio[onset:onset + int(0.5 * sr)]
        atk_real = attack_time_s(seg_real, sr)
        atk_model = attack_time_s(model_audio[:, k], sr)

        rd = harmonics.decay_rate_db_per_s(real["decay_db"],
                                           real["decay_times"])
        md = harmonics.decay_rate_db_per_s(model["decay_db"],
                                           model["decay_times"])
        cents = 1200.0 * np.log2(max(real["f0_hz"], 1e-9)
                                 / max(model["f0_hz"], 1e-9))

        # harmonic distance: RMS of the relative-ladder deltas over
        # H2-H8 (reference compare_note's harm_dist aggregate)
        hd_vals = [d for d in h_delta[1:8] if d is not None]
        harm_dist = (float(np.sqrt(np.mean(np.square(hd_vals))))
                     if hd_vals else float("nan"))

        entry = {
            "midi": n["midi_note"],
            "harmonic_distance_db": harm_dist,
            "tier": n["tier"],
            "f0_real": real["f0_hz"],
            "f0_model": model["f0_hz"],
            "f0_cents_delta": float(cents),
            "harmonic_rel_delta_db": h_delta,
            "decay_real_db_s": rd,
            "decay_model_db_s": md,
            "centroid_real_hz": real["centroid_sustain_hz"],
            "centroid_model_hz": model["centroid_sustain_hz"],
            "harmonic_windows_delta_db": h_windows,
            "attack_real_s": atk_real,
            "attack_model_s": atk_model,
        }
        report.append(entry)
        h2 = h_delta[1] if len(h_delta) > 1 and h_delta[1] is not None else 0
        print(f"  MIDI {n['midi_note']:3d} [{n['tier']:6s}] "
              f"Δf0 {cents:+6.1f}c  ΔH2/H1 {h2:+5.1f} dB  "
              f"decay {rd:.1f} vs {md:.1f} dB/s")

    # ── aggregate summary (ref print_summary) ──
    def med(key, absval=False):
        vals = [e[key] for e in report
                if e[key] is not None and np.isfinite(e[key])]
        if not vals:
            return float("nan")
        vals = np.abs(vals) if absval else np.asarray(vals)
        return float(np.median(vals))

    h2s = [e["harmonic_rel_delta_db"][1] for e in report
           if len(e["harmonic_rel_delta_db"]) > 1
           and e["harmonic_rel_delta_db"][1] is not None]
    h3s = [e["harmonic_rel_delta_db"][2] for e in report
           if len(e["harmonic_rel_delta_db"]) > 2
           and e["harmonic_rel_delta_db"][2] is not None]
    decay_d = [e["decay_real_db_s"] - e["decay_model_db_s"]
               for e in report
               if np.isfinite(e["decay_real_db_s"])
               and np.isfinite(e["decay_model_db_s"])]
    hds = [e["harmonic_distance_db"] for e in report
           if np.isfinite(e["harmonic_distance_db"])]
    if hds:
        print("harmonic distance (RMS dB, H2-H8 vs real):")
        print(f"  mean {np.mean(hds):6.1f}  median {np.median(hds):6.1f}"
              f"  worst {max(hds):6.1f}  best {min(hds):6.1f}")

    # per-octave breakdown (reference print_comparison_report)
    by_oct = {}
    for e in report:
        o = by_oct.setdefault(e["midi"] // 12 - 1,
                              {"hd": [], "dd": [], "cd": [], "n": 0})
        o["n"] += 1
        if np.isfinite(e["harmonic_distance_db"]):
            o["hd"].append(e["harmonic_distance_db"])
        if (np.isfinite(e["decay_real_db_s"])
                and np.isfinite(e["decay_model_db_s"])):
            o["dd"].append(e["decay_model_db_s"] - e["decay_real_db_s"])
        if (np.isfinite(e["centroid_real_hz"])
                and np.isfinite(e["centroid_model_hz"])):
            o["cd"].append(e["centroid_model_hz"]
                           - e["centroid_real_hz"])
    print("per-octave breakdown:")
    print(f"  {'oct':>4s} {'n':>3s} {'harmdist':>9s} {'decayD':>8s} "
          f"{'centD':>8s}")
    for o, d in sorted(by_oct.items()):
        print(f"  {o:4d} {d['n']:3d} "
              f"{np.mean(d['hd']) if d['hd'] else float('nan'):9.1f} "
              f"{np.mean(d['dd']) if d['dd'] else float('nan'):+8.1f} "
              f"{np.mean(d['cd']) if d['cd'] else float('nan'):+8.0f}")

    summary = {
        "n_notes": len(report),
        "harmonic_distance_db": {
            "mean": float(np.mean(hds)) if hds else float("nan"),
            "median": float(np.median(hds)) if hds else float("nan"),
            "worst": float(max(hds)) if hds else float("nan"),
        },
        "per_octave": {
            str(o): {"n": d["n"],
                     "harm_dist_db": (float(np.mean(d["hd"]))
                                      if d["hd"] else None),
                     "decay_delta_db_s": (float(np.mean(d["dd"]))
                                          if d["dd"] else None),
                     "centroid_delta_hz": (float(np.mean(d["cd"]))
                                           if d["cd"] else None)}
            for o, d in sorted(by_oct.items())},
        "median_abs_f0_cents": med("f0_cents_delta", absval=True),
        "median_abs_h2_delta_db": (float(np.median(np.abs(h2s)))
                                   if h2s else float("nan")),
        "median_abs_h3_delta_db": (float(np.median(np.abs(h3s)))
                                   if h3s else float("nan")),
        "median_decay_delta_db_s": (float(np.median(decay_d))
                                    if decay_d else float("nan")),
    }
    print("summary:")
    print(f"  |Δf0| median      {summary['median_abs_f0_cents']:.1f} cents"
          f"  (reference MLP target ~2.5)")
    print(f"  |ΔH2/H1| median   {summary['median_abs_h2_delta_db']:.2f} dB"
          f"  (reference MLP target ~0.3)")
    print(f"  |ΔH3/H1| median   {summary['median_abs_h3_delta_db']:.2f} dB"
          f"  (reference MLP target ~0.9)")
    print(f"  decay Δ median    {summary['median_decay_delta_db_s']:.1f}"
          f" dB/s")

    with open(args.output, "w") as f:
        json.dump({"notes": report, "summary": summary}, f, indent=1)
    print(f"→ {args.output}")


if __name__ == "__main__":
    main()
