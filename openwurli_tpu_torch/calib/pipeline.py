"""ML calibration pipeline — 7 stages, on the device (stage-resumable).

Port of `openwurli_tpu/calib/pipeline.py`: the same stages and flags, plus
`--device` (the card unless the caller names another). Stage 4's model
renders call the port's DI chain directly (`di.render_di`: kernels E4 and
E5<dk>, all (note, velocity-bucket) pairs in one pass — BASELINE config
5), stage 6 trains on the device, and stage 7 installs the weight arrays
into the port's own `data/mlp_weights.npz`, which the engine reads.

    python -m openwurli_tpu_torch.calib.pipeline --input-dir rec/ --train
    python -m openwurli_tpu_torch.calib.pipeline --from-stage 5
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

N_VELOCITY_BUCKETS = 8


def _data_dir(args):
    os.makedirs(args.data_dir, exist_ok=True)
    return args.data_dir


def stage_extract_notes(args):
    from openwurli_tpu_torch.calib import notes as notes_mod
    from openwurli_tpu_torch.io import wav

    all_notes = []
    files = sorted(glob.glob(os.path.join(args.input_dir, "*.wav")))
    if not files:
        print(f"  no WAV files in {args.input_dir}")
    for path in files:
        audio, sr = wav.read_wav(path)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        found = notes_mod.extract_notes(audio, sr, device=args.device)
        for n in found:
            n["file"] = path
            n["sr"] = sr
        all_notes.extend(found)
        print(f"  {os.path.basename(path)}: {len(found)} notes")
    out = os.path.join(_data_dir(args), "notes.json")
    json.dump(all_notes, open(out, "w"), indent=1)
    print(f"  → {out} ({len(all_notes)} notes)")


def stage_score_isolation(args):
    from openwurli_tpu_torch.calib import notes as notes_mod
    from openwurli_tpu_torch.io import wav

    notes = json.load(open(os.path.join(args.data_dir, "notes.json")))
    scored = []
    for path in sorted({n["file"] for n in notes}):
        audio, sr = wav.read_wav(path)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        file_notes = [n for n in notes if n["file"] == path]
        scored.extend(notes_mod.score_isolation(file_notes, audio, sr))
    out = os.path.join(args.data_dir, "scored_notes.json")
    json.dump(scored, open(out, "w"), indent=1)
    tiers = {t: sum(1 for n in scored if n["tier"] == t)
             for t in ("gold", "silver", "bronze")}
    print(f"  → {out} tiers: {tiers}")


def stage_extract_harmonics(args):
    from openwurli_tpu_torch.calib import harmonics
    from openwurli_tpu_torch.io import wav

    scored = json.load(open(os.path.join(args.data_dir, "scored_notes.json")))
    feats = []
    for path in sorted({n["file"] for n in scored}):
        audio, sr = wav.read_wav(path)
        if audio.ndim > 1:
            audio = audio.mean(axis=1)
        for n in [x for x in scored if x["file"] == path]:
            f = harmonics.extract_note_features(
                audio, sr, n["f0_hz"], n["onset_s"],
                n["offset_s"] - n["onset_s"], device=args.device)
            snr = harmonics.measure_interharmonic_snr(
                audio[int(n["onset_s"] * sr):], sr, f["f0_hz"],
                device=args.device)
            feats.append({**n, "features": f, "snr_db": list(snr)})
    out = os.path.join(args.data_dir, "harmonics.json")
    json.dump(feats, open(out, "w"), indent=1)
    print(f"  → {out} ({len(feats)} observations)")


def stage_render_model(args):
    """Render matching (midi, velocity-bucket) notes through the DI chain
    (reed → pickup → 2×OS preamp, ml/render_model_notes.py:49-60) — the
    whole unique set in ONE batched render."""
    from openwurli_tpu_torch import di
    from openwurli_tpu_torch.calib import harmonics, residuals

    feats = json.load(open(os.path.join(args.data_dir, "harmonics.json")))
    pairs = sorted({(n["midi_note"],
                     residuals.bucket_velocity(n["velocity_norm"]))
                    for n in feats})
    if not pairs:
        print("  no observations")
        return
    sr = 44100.0
    midis = np.asarray([p[0] for p in pairs], dtype=np.float64)
    vels = np.asarray([(p[1] + 0.5) / N_VELOCITY_BUCKETS for p in pairs])
    audio = di.render_di(midis, vels, args.model_seconds, sr,
                         mlp_enabled=False, device=args.device)
    model_feats = {}
    for k, (midi, bucket) in enumerate(pairs):
        f = harmonics.extract_note_features(
            audio[:, k], sr, 440.0 * 2 ** ((midi - 69) / 12),
            device=args.device)
        model_feats[f"{midi}_{bucket}"] = f
    out = os.path.join(args.data_dir, "model_harmonics.json")
    json.dump(model_feats, open(out, "w"), indent=1)
    print(f"  → {out} ({len(pairs)} model renders, one batched pass)")


def stage_compute_residuals(args):
    from openwurli_tpu_torch.calib import residuals

    feats = json.load(open(os.path.join(args.data_dir, "harmonics.json")))
    model = json.load(open(os.path.join(args.data_dir,
                                        "model_harmonics.json")))
    obs = []
    for n in feats:
        key = f"{n['midi_note']}_{residuals.bucket_velocity(n['velocity_norm'])}"
        if key not in model:
            continue
        obs.append(residuals.compute_observation(
            n["features"], model[key], n["midi_note"], n["velocity_norm"],
            n["tier"], real_snr_db=np.asarray(n["snr_db"])))
    if not obs:
        print("  no matched observations")
        return
    batch = residuals.assemble_batch(obs, device=args.device)
    out = os.path.join(args.data_dir, "training_data.npz")
    np.savez(out, **{k: getattr(batch, k).cpu().numpy()
                     for k in batch._fields})
    print(f"  → {out} ({len(obs)} observations, "
          f"{int(batch.mask.sum())} valid targets)")


def stage_train(args):
    import torch

    from openwurli_tpu_torch.calib import train

    d = np.load(os.path.join(args.data_dir, "training_data.npz"))
    batch = train.TrainBatch(*[torch.from_numpy(d[k]).to(args.device)
                               for k in train.TrainBatch._fields])
    weights = train.train(batch, hidden=args.hidden, epochs=args.epochs,
                          log_every=max(args.epochs // 10, 1))
    out = os.path.join(args.data_dir, "model_weights.npz")
    train.save_weights(weights, out)
    print(f"  → {out}")


def stage_export(args):
    """Install trained weights as the port's correction net."""
    import shutil

    from openwurli_tpu_torch import mlp

    src = os.path.join(args.data_dir, "model_weights.npz")
    dst = mlp.WEIGHTS_PATH
    shutil.copy(src, dst)
    print(f"  installed → {dst}")


STAGES = [
    (1, "Extract notes", stage_extract_notes),
    (2, "Score isolation", stage_score_isolation),
    (3, "Extract harmonics", stage_extract_harmonics),
    (4, "Render model notes", stage_render_model),
    (5, "Compute residuals", stage_compute_residuals),
    (6, "Train MLP", stage_train),
    (7, "Install weights", stage_export),
]


def main(argv=None):
    p = argparse.ArgumentParser(description="OpenWurli ML pipeline (torch)")
    p.add_argument("--input-dir", default="recordings")
    p.add_argument("--data-dir", default="ml_data")
    p.add_argument("--from-stage", type=int, default=1)
    p.add_argument("--through-stage", type=int, default=5)
    p.add_argument("--train", action="store_true",
                   help="run through stage 7 (train + install)")
    p.add_argument("--hidden", type=int, default=16)
    p.add_argument("--epochs", type=int, default=2000)
    p.add_argument("--model-seconds", type=float, default=2.0)
    p.add_argument("--dry-run", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the stages' tensor work")
    args = p.parse_args(argv)
    if args.train:
        args.through_stage = 7

    if args.dry_run:
        for num, name, _ in STAGES:
            status = ("RUN" if args.from_stage <= num <= args.through_stage
                      else "SKIP")
            print(f"  Stage {num}: {name} [{status}]")
        return

    for num, name, fn in STAGES:
        if num > args.through_stage:
            break
        if num < args.from_stage:
            print(f"Stage {num}: {name} [SKIPPED]")
            continue
        print(f"Stage {num}: {name}")
        t0 = time.time()
        fn(args)
        print(f"  ({time.time()-t0:.1f}s)")


if __name__ == "__main__":
    main()
