#!/usr/bin/env python3
"""Train the onset/pitch note-extraction model on self-rendered audio, on
the card. Port of tools/train_onset_model.py, function for function.

The network (openwurli_tpu_torch/calib/onset_model.py) learns from
mixtures synthesized from this repo's own fast-path renders: single notes
across the keyboard and velocity range (`fast.render_grid`, kernels K1
and K2, and the voice bank alone, K1, for a DI family), placed at random
onsets with random gains, polyphony and noise, plus plain harmonic tones.
It prints held-out metrics against the spectral extractor and writes the
format-3 weights to --out.

Usage:
    python tools/torch_train_onset_model.py --out build/onset/onset_pitch.npz
    python tools/torch_train_onset_model.py --device cpu --clips 20 \\
        --steps 200 --out /tmp/op.npz

--out is required and may not lie in either package's data/ directory:
the shipped onset_pitch.npz files stay the reference's bytes. `--device
cpu` is the reference's --interpret smoke mode (velocity 0.7 only, every
12th note, the plain kernel versions). --pool-npz caches the rendered
note pool in the reference tool's format, so one tool loads the other's.
"""

import argparse
import ast
import os
import sys
import time

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def render_note_pool(sr, seconds, device, vels=(0.4, 0.7, 1.0),
                     midi_step=1, depths=(0.0, 0.4, 0.8)):
    """Render every (midi 36-96 × velocity × tremolo depth) single note
    through the full fast-path chain → dict[(midi, vel, depth)] = (T,)
    float32, and each (midi, vel) through the voice bank alone, peak-
    normalised to 0.3 → dict[(midi, vel, "di")].

    On the card all combinations go into one render_grid call per depth,
    the stream count padded to a multiple of 128 as the reference pads
    it (padding streams change no other stream's output); on the CPU the
    calls take the combinations alone, as the reference's interpret mode
    does."""
    import torch

    from openwurli_tpu_torch import fast
    from openwurli_tpu_torch.calib.onset_model import MIDI_HI, MIDI_LO
    from openwurli_tpu_torch.kernels import voice_bank as vb

    midis = np.arange(MIDI_LO, MIDI_HI + 1, midi_step, dtype=np.float64)
    combos = [(int(m), v) for v in vels for m in midis]
    s_pad = len(combos) if torch.device(device).type == "cpu" \
        else max(128, -(-len(combos) // 128) * 128)
    grid = np.full(s_pad, 60.0)
    vel_col = np.full(s_pad, 0.5)
    for i, (m, v) in enumerate(combos):
        grid[i] = m
        vel_col[i] = v
    pool = {}
    for depth in depths:
        out = fast.render_grid(
            grid[:, None], vel_col[:, None], seconds, sr, volume=0.5,
            depth=depth, character=0.0, device=device).cpu().numpy()
        for i, (m, v) in enumerate(combos):
            pool[(m, v, depth)] = out[:, i].astype(np.float32)

    # Voice-only (DI) timbre family: recordings without the amp and
    # speaker coloration; without it the model makes octave errors on
    # voice-path audio.
    params, _ = vb.make_kernel_params(grid, vel_col, sr, lanes=s_pad,
                                      device=device)
    t_pad = -(-int(seconds * sr) // 512) * 512
    voices = vb.render_voice_bank(params, t_pad, events=False,
                                  steady=vb.steady_limits(params))
    voices = voices.cpu().numpy()
    for i, (m, v) in enumerate(combos):
        seg = voices[:int(seconds * sr), i].astype(np.float32)
        peak = max(float(np.abs(seg).max()), 1e-9)
        pool[(m, v, "di")] = 0.3 * seg / peak
    print(f"  rendered {len(combos)} (note, velocity) combinations × "
          f"({len(depths)} tremolo depths + DI) ({s_pad}-stream calls)")
    return pool


def add_synthetic_tones(pool, sr, seconds):
    """Augment the pool with plain decaying harmonic tones (one per MIDI
    note), a second timbre family that keeps the extractor from
    overfitting the chain's coloration."""
    from openwurli_tpu_torch.calib.onset_model import MIDI_HI, MIDI_LO

    t = np.arange(int(seconds * sr)) / sr
    for midi in range(MIDI_LO, MIDI_HI + 1):
        f0 = 440.0 * 2.0 ** ((midi - 69) / 12.0)
        env = np.exp(-3.0 * t) * np.minimum(t / 0.01, 1.0)
        tone = env * (np.sin(2 * np.pi * f0 * t)
                      + 0.45 * np.sin(2 * np.pi * 2 * f0 * t)
                      + 0.15 * np.sin(2 * np.pi * 3 * f0 * t))
        pool[(midi, "syn")] = (0.1 * tone).astype(np.float32)
    return pool


def synth_mixtures(pool, sr, n_clips, clip_seconds, seed):
    """Random mixtures + labels: list of (audio, [(onset_s, midi), ...])."""
    rng = np.random.default_rng(seed)
    keys = list(pool.keys())
    t_len = int(clip_seconds * sr)
    clips = []
    for _ in range(n_clips):
        audio = np.zeros(t_len, dtype=np.float64)
        k = int(rng.integers(1, 5))
        events = []
        for _ in range(k):
            key = keys[rng.integers(len(keys))]
            midi = key[0]
            onset_s = float(rng.uniform(0.1, clip_seconds - 0.6))
            gain = 10.0 ** (rng.uniform(-12.0, 0.0) / 20.0)
            i0 = int(onset_s * sr)
            seg = pool[key].astype(np.float64).copy()
            # fade the pool clip's hard cut (its broadband splatter would
            # teach spurious onsets)
            n_f = min(len(seg), int(0.05 * sr))
            seg[-n_f:] *= np.linspace(1.0, 0.0, n_f)
            n = min(len(seg), t_len - i0)
            audio[i0:i0 + n] += gain * seg[:n]
            events.append((onset_s, midi))
        noise_db = rng.uniform(-70.0, -40.0)
        audio += rng.normal(0.0, 10.0 ** (noise_db / 20.0), t_len)
        if rng.random() < 0.3:   # mains hum
            hum_db = rng.uniform(-70.0, -50.0)
            audio += (10.0 ** (hum_db / 20.0)
                      * np.sin(2 * np.pi * 50.0 * np.arange(t_len) / sr))
        events.sort()
        clips.append((audio.astype(np.float32), events))
    return clips


def label_clip(audio, events, sr):
    """(frames X, onset map, note map, note mask) for one mixture.

    Maps are (n_frames, N_NOTES) multi-hot. The note-presence map is
    supervised over [onset, onset+0.5 s] per pitch and masked over the
    following ring-out window (the note is still audible there, for an
    unknown span)."""
    from openwurli_tpu_torch.calib import onset_model as om

    feats = om.features(audio, sr)
    xs = om.context_windows(feats)
    n = len(feats)
    _, hop = om.frame_params(sr)
    hop_s = hop / sr
    y_on = np.zeros((n, om.N_NOTES), dtype=np.float32)
    y_note = np.zeros((n, om.N_NOTES), dtype=np.float32)
    mask = np.ones((n, om.N_NOTES), dtype=np.float32)
    span = int(round(0.5 / hop_s))
    ring = int(round(2.5 / hop_s))
    for onset_s, midi in events:
        f = int(round(onset_s / hop_s))
        p = int(midi) - om.MIDI_LO
        if not (0 <= p < om.N_NOTES):
            continue
        for df in (0, 1):
            if 0 <= f + df < n:
                y_on[f + df, p] = 1.0
        hi = min(f + span, n)
        y_note[f:hi, p] = 1.0
        mask[hi:min(f + ring, n), p] = 0.0
    return xs, y_on, y_note, mask


def _score(found, events):
    """(hits, spurious) of one mixture: ±80 ms, ±1 semitone."""
    used, hits = set(), 0
    for onset_s, midi in events:
        ok = [i for i, f in enumerate(found)
              if i not in used and abs(f["onset_s"] - onset_s) < 0.08
              and abs(f["midi_note"] - midi) <= 1]
        if ok:
            used.add(ok[0])
            hits += 1
    return hits, len(found) - len(used)


def main(argv=None):
    """Returns the run's numbers: val (P, R, F1), end-to-end and
    spectral (hits, total, spurious), stage seconds, params."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sr", type=float, default=16000.0)
    ap.add_argument("--seconds", type=float, default=1.5,
                    help="single-note render length")
    ap.add_argument("--clip-seconds", type=float, default=3.0)
    ap.add_argument("--clips", type=int, default=400)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu: the smoke mode on the "
                         "plain kernel versions")
    ap.add_argument("--pool-npz", default="",
                    help="cache the rendered note pool here")
    ap.add_argument("--out", required=True,
                    help="where the trained weights go (not into either "
                         "package's data/)")
    args = ap.parse_args(argv)
    out = os.path.realpath(args.out)
    for pkg in ("openwurli_tpu", "openwurli_tpu_torch"):
        d = os.path.realpath(os.path.join(REPO, pkg, "data"))
        if os.path.commonpath([out, d]) == d:
            ap.error(f"--out {args.out} lies in {d}: the shipped weights "
                     "stay as they are")

    from openwurli_tpu_torch.calib import notes as notes_mod
    from openwurli_tpu_torch.calib import onset_model as om

    smoke = args.device == "cpu"
    seconds = {}
    t0 = time.perf_counter()
    if args.pool_npz and os.path.exists(args.pool_npz):
        with np.load(args.pool_npz) as z:
            pool = {tuple(ast.literal_eval(k)): z[k] for k in z.files}
        print(f"loaded pool: {len(pool)} notes")
    else:
        print("rendering note pool (fast path)...")
        pool = render_note_pool(
            args.sr, args.seconds, args.device,
            vels=(0.7,) if smoke else (0.4, 0.7, 1.0),
            midi_step=12 if smoke else 1)
        if args.pool_npz:
            np.savez_compressed(args.pool_npz,
                                **{str(k): v for k, v in pool.items()})
    seconds["pool"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    add_synthetic_tones(pool, args.sr, min(args.seconds, 1.5))
    print(f"synthesizing {args.clips} mixtures "
          f"({len(pool)} pool entries incl. synthetic tones)...")
    clips = synth_mixtures(pool, args.sr, args.clips, args.clip_seconds,
                           args.seed)
    n_val = max(1, args.clips // 10)
    xs, os_, ns_, ms_ = zip(*(label_clip(a, e, args.sr) for a, e in clips))
    x_tr = np.concatenate(xs[n_val:])
    o_tr = np.concatenate(os_[n_val:])
    n_tr = np.concatenate(ns_[n_val:])
    m_tr = np.concatenate(ms_[n_val:])
    x_va = np.concatenate(xs[:n_val])
    o_va = np.concatenate(os_[:n_val])
    print(f"frames: train {len(x_tr)}, val {len(x_va)} "
          f"(onset-cell rate {o_tr.mean():.5f})")
    seconds["mixtures"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    params = om.train(x_tr, o_tr, n_tr, note_mask=m_tr, steps=args.steps,
                      seed=args.seed, log_every=max(args.steps // 10, 1),
                      device=args.device)
    seconds["train"] = time.perf_counter() - t0

    import torch

    t0 = time.perf_counter()
    with torch.inference_mode():
        ol, _ = om.forward(om.params_to(params, args.device),
                           torch.from_numpy(x_va).to(args.device))
        ol = ol.cpu().numpy()
    prob = 1.0 / (1.0 + np.exp(-np.clip(ol, -40.0, 40.0)))
    pred_on = prob > 0.5
    tp = float(np.sum(pred_on & (o_va > 0.5)))
    prec = tp / max(pred_on.sum(), 1)
    rec = tp / max((o_va > 0.5).sum(), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    print(f"val: onset-map P {prec:.3f} R {rec:.3f} F1 {f1:.3f}")

    # end-to-end: decode the val mixtures
    hits = total = fp = 0
    for audio, events in clips[:n_val]:
        found = om.nn_extract_notes(audio, args.sr, params=params,
                                    min_duration=0.1, device=args.device)
        h, f = _score(found, events)
        total += len(events)
        hits += h
        fp += f
    print(f"end-to-end: {hits}/{total} notes recovered "
          f"(±80 ms, ±1 semitone), {fp} spurious")
    seconds["network eval"] = time.perf_counter() - t0

    # the spectral path on the same validation mixtures: the number that
    # decides whether the network earns the pipeline default
    t0 = time.perf_counter()
    s_hits = s_fp = 0
    for audio, events in clips[:n_val]:
        found = notes_mod.extract_notes(audio, args.sr, min_duration=0.1,
                                        method="spectral",
                                        device=args.device)
        h, f = _score(found, events)
        s_hits += h
        s_fp += f
    print(f"spectral baseline: {s_hits}/{total} notes recovered, "
          f"{s_fp} spurious")
    seconds["spectral eval"] = time.perf_counter() - t0

    os.makedirs(os.path.dirname(out), exist_ok=True)
    om.save_params(params, args.out)
    print(f"→ {args.out}")
    print("stage seconds: " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in seconds.items()))
    return {"val": (prec, rec, f1), "end_to_end": (hits, total, fp),
            "spectral": (s_hits, total, s_fp), "seconds": seconds,
            "params": params}


if __name__ == "__main__":
    main()
