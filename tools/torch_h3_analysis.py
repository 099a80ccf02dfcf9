#!/usr/bin/env python3
"""Offline H3-deficit analysis with SNR filtering.

The PyTorch port's copy of tools/h3_analysis.py: for each usable note in
the harmonics dataset (or a live model render sweep), compare H3/H1
between real and model with inter-harmonic SNR gating, and report the
per-register H3 deficit. The sweep renders through the port's voice render
(kernel E4 on the card) and `calib.harmonics` on `--device`.

    python tools/torch_h3_analysis.py --data-dir ml_data
    python tools/torch_h3_analysis.py --model-sweep   # model-only H3 profile
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

SNR_THRESHOLD_DB = 10.0


def model_sweep(notes, velocity=0.8, seconds=1.5, sr=44100.0, device="cuda"):
    """(midi, H3/H1 dB of the early-sustain window or None) per note."""
    from openwurli_tpu_torch import voice
    from openwurli_tpu_torch.calib import harmonics

    midis = np.asarray(notes, dtype=np.float64)
    vels = np.full(midis.shape, velocity)
    audio = voice.render_note(midis, vels, seconds, sr, mlp_enabled=False,
                              device=device).cpu().numpy()
    rows = []
    for k, midi in enumerate(notes):
        f = harmonics.extract_note_features(
            audio[:, k], sr, 440.0 * 2 ** ((midi - 69) / 12), device=device)
        es = f["windows"]["early_sustain"]
        rows.append((midi, es[2] - es[0] if np.isfinite(es[2]) else None))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-dir", default="ml_data")
    p.add_argument("--model-sweep", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.model_sweep:
        print("midi,h3_h1_db (model DI path, v=0.8)")
        for midi, h3 in model_sweep(list(range(48, 97, 4)),
                                    device=args.device):
            print(f"{midi},{'' if h3 is None else f'{h3:.2f}'}")
        return

    path = os.path.join(args.data_dir, "harmonics.json")
    if not os.path.exists(path):
        print(f"{path} not found — run the pipeline through stage 3, or "
              f"use --model-sweep")
        return
    with open(path) as f:
        feats = json.load(f)
    deficits = []
    for n in feats:
        snr = n.get("snr_db", [99] * 8)
        if len(snr) > 2 and snr[2] < SNR_THRESHOLD_DB:
            continue  # H3 noise-contaminated
        es = n["features"]["windows"]["early_sustain"]
        if not (np.isfinite(es[0]) and np.isfinite(es[2])):
            continue
        deficits.append((n["midi_note"], es[2] - es[0], n["tier"]))
    if not deficits:
        print("no usable H3 observations")
        return
    print("midi,h3_h1_db,tier")
    for midi, d, tier in sorted(deficits):
        print(f"{midi},{d:.2f},{tier}")
    vals = np.asarray([d for _, d, _ in deficits])
    print(f"# n={len(vals)} median={np.median(vals):.2f} dB "
          f"mean={vals.mean():.2f} dB", file=sys.stderr)


if __name__ == "__main__":
    main()
