"""openwurli-tpu-torch CLI — measurement / validation / render tools.

Port of `openwurli_tpu/cli.py`: the same 21 subcommands (the reference's
`preamp-bench` vocabulary plus `reed-render`), with their names, options,
defaults, printed lines, CSV headers and JSON keys, and one top-level
option more, `--device` (the card unless the caller names another):

    python -m openwurli_tpu_torch.cli [--device cpu] <cmd> --help

What runs where on the card:

  * `gain`, `sweep`, `tremolo-sweep`, `harmonics` and the five `pump-*`
    subcommands step the twin DK preamp directly at `--sr` through kernel
    E7 (`kernels/render.py` `dk_scan`), every stream of a sweep at once;
  * `render`, `centroid-track`, `overshoot`: `di.render_di` (E4, E5<dk>);
    `reed-render` and `bench-reed`: the voice render (E4);
  * `render-poly` / `render-midi`: with `--fast` the fused float32 path
    (`fast`: K1 or K3, K2 or K5, K4), without it the float64 `Engine`
    (E1, E2);
  * `alias-audit`: `calib.alias_audit` (E1, E2); `calibrate`,
    `bark-audit`, `sensitivity`: `calib.calibrate.run_calibrate` (E4<tap>,
    E5<dk>, E6); `intermod-audit`: `tables.intermod_risk` on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ── preamp measurement helpers ───────────────────────────────────────────


def _dk_scan(x, r_ldr, sr, tap, device):
    """x and r_ldr (n, G) NumPy float64 → E7's output (n, G) NumPy: G twin
    DK preamps from their DC point, one step per sample at `sr`."""
    from openwurli_tpu_torch.kernels import render as kr

    x_t = torch.as_tensor(np.ascontiguousarray(x, np.float64)).to(device)
    r_t = torch.as_tensor(np.ascontiguousarray(r_ldr, np.float64)).to(device)
    state = kr.init_dk_scan_state(sr, x_t.shape[1], device)
    return kr.dk_scan(sr, x_t, r_t, state, tap).cpu().numpy()


def _measure_preamp_gain_batch(freqs, amplitude, r_ldrs, sr,
                               settle=0.3, measure=0.2, device="cuda"):
    """Vectorised gain measurement: the whole (freq, R_ldr) grid advances
    as one E7 launch, a stream per point."""
    freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
    r_ldrs = np.broadcast_to(
        np.asarray(r_ldrs, dtype=np.float64), freqs.shape)
    n = int(sr * (settle + measure))
    t = np.arange(n) / sr
    xs = amplitude * np.sin(2 * np.pi * freqs[None, :] * t[:, None])  # (n, F)
    out = _dk_scan(xs, np.broadcast_to(r_ldrs, xs.shape), sr, "diff", device)
    peaks = np.abs(out[int(sr * settle):]).max(axis=0)
    return peaks / amplitude


def _measure_preamp_gain(freq, amplitude, r_ldr, sr, settle=0.3, measure=0.2,
                         device="cuda"):
    return float(_measure_preamp_gain_batch([freq], amplitude, [r_ldr], sr,
                                            settle, measure, device)[0])


def cmd_gain(args):
    sr = args.sr
    gain = _measure_preamp_gain(args.freq, args.amplitude, args.r_ldr, sr,
                                device=args.device)
    print(f"Gain @ {args.freq:.0f} Hz, R_ldr={args.r_ldr:.0f} Ω: "
          f"{gain:.3f}x ({20*np.log10(gain):.2f} dB)")


def cmd_sweep(args):
    freqs = np.geomspace(args.lo, args.hi, args.points)
    gains = _measure_preamp_gain_batch(freqs, args.amplitude, args.r_ldr,
                                       args.sr, device=args.device)
    print("freq_hz,gain_db")
    for f, g in zip(freqs, gains):
        print(f"{f:.1f},{20*np.log10(g):.2f}")


def harmonic_mags(freq, amplitude, r_ldr, sr, seconds=0.5, device="cuda"):
    """`harmonics`' measurement: H1-H5 magnitudes of the preamp's output
    over the second half of `seconds` of a sine at `freq`."""
    from openwurli_tpu_torch.calib import goertzel

    n = int(sr * seconds)
    t = np.arange(n) / sr
    xs = amplitude * np.sin(2 * np.pi * freq * t)
    out = _dk_scan(xs[:, None], np.full((n, 1), float(r_ldr)), sr, "diff",
                   device)[:, 0]
    seg = out[n // 2:]
    return goertzel.dft_magnitude(
        seg, [freq * k for k in (1, 2, 3, 4, 5)], sr,
        device=device).cpu().numpy()


def cmd_harmonics(args):
    mags = harmonic_mags(args.freq, args.amplitude, args.r_ldr, args.sr,
                         device=args.device)
    h1 = mags[0]
    thd = np.sqrt((mags[1:] ** 2).sum()) / h1
    print(f"H1: {20*np.log10(h1):.2f} dB")
    for k in range(2, 6):
        print(f"H{k}/H1: {20*np.log10(mags[k-1]/h1):.2f} dB")
    print(f"THD (H2-H5): {100*thd:.4f} %")


def cmd_tremolo_sweep(args):
    rs = np.geomspace(args.lo, args.hi, args.points)
    gains = _measure_preamp_gain_batch(
        np.full_like(rs, args.freq), args.amplitude, rs, args.sr,
        device=args.device)
    print("r_ldr_ohm,gain_db")
    for r, g in zip(rs, gains):
        print(f"{r:.0f},{20*np.log10(g):.2f}")


# ── renders ──────────────────────────────────────────────────────────────


def _render_di(note, velocity, duration, sr, device):
    """DI path: reed → pickup → output_scale → 2×OS preamp @1 MΩ.

    Matches the reference's `preamp-bench render` chain (the path the ML
    pipeline's model renders use — no amp/speaker)."""
    from openwurli_tpu_torch import di

    return di.render_di(note, velocity, duration, sr, mlp_enabled=True,
                        device=device)


def cmd_render(args):
    from openwurli_tpu_torch.io import wav

    out = _render_di(args.note, args.velocity / 127.0, args.duration, args.sr,
                     args.device)
    peak = np.abs(out).max()
    if args.normalize and peak > 0:
        out = out / peak * 0.9
    wav.write_wav(args.output, out, args.sr, bits=24)
    print(f"Rendered note {args.note} v={args.velocity} → {args.output} "
          f"({len(out)} samples, peak {peak:.4f})")


def cmd_reed_render(args):
    """reed-renderer parity: voice-only (reed+pickup) → 24-bit WAV."""
    from openwurli_tpu_torch import voice
    from openwurli_tpu_torch.io import wav

    notes = ([33, 40, 48, 55, 62, 69, 76, 84, 96] if args.sweep
             else [args.note])
    for n in notes:
        out = voice.render_note(n, args.velocity / 127.0, args.duration,
                                args.sr, device=args.device).cpu().numpy()
        path = (args.output if len(notes) == 1
                else args.output.replace(".wav", f"_{n}.wav"))
        peak = np.abs(out).max()
        if peak > 0:
            out = out / peak * 0.9
        wav.write_wav(path, out, args.sr, bits=24)
        print(f"note {n} v={args.velocity} → {path}")


def _engine(args):
    from openwurli_tpu_torch.engine import Engine

    eng = Engine(args.sr, device=args.device)
    eng.set_volume(args.volume)
    eng.set_tremolo_depth(args.tremolo)
    eng.set_speaker_character(args.speaker)
    if args.noise_level > 0.0:
        eng.set_noise_enabled(True)
        eng.set_noise_gain(args.noise_level)
    eng.render(1536)
    return eng


def cmd_render_poly(args):
    from openwurli_tpu_torch.io import wav

    notes = [int(x) for x in args.notes.split(",")]
    if args.fast:
        from openwurli_tpu_torch import fast

        out = fast.render_chord(
            notes, args.velocity / 127.0, args.duration, args.sr,
            volume=args.volume, depth=args.tremolo,
            character=args.speaker, warm_seconds=0.6,
            noise_level=args.noise_level,
            device=args.device).cpu().numpy().astype(np.float64)
        wav.write_wav(args.output, out, args.sr, bits=24)
        print(f"Rendered {len(notes)} notes × {args.duration}s (fused "
              f"kernel path) → {args.output} "
              f"(peak {np.abs(out).max():.4f})")
        return
    eng = _engine(args)
    for n in notes:
        eng.note_on(n, args.velocity / 127.0)
    out = eng.render(int(args.sr * args.duration)).cpu().numpy()
    wav.write_wav(args.output, out, args.sr, bits=24)
    print(f"Rendered {len(notes)} notes × {args.duration}s → {args.output} "
          f"(peak {np.abs(out).max():.4f})")


def cmd_render_midi(args):
    from openwurli_tpu_torch.io import midi_file, wav

    if args.fast:
        from openwurli_tpu_torch import fast

        out = fast.render_midi_file(
            args.input, args.sr, tail_seconds=args.tail,
            volume=args.volume, depth=args.tremolo,
            character=args.speaker, noise_level=args.noise_level,
            parallel=not args.serial,
            device=args.device).cpu().numpy().astype(np.float64)
        wav.write_wav(args.output, out, args.sr, bits=24)
        print(f"Rendered {args.input} ({len(out)/args.sr:.1f}s, fused "
              f"kernel event path) → {args.output} "
              f"(peak {np.abs(out).max() if len(out) else 0.0:.4f})")
        return

    events, total_s = midi_file.load_events(args.input)
    eng = _engine(args)
    chunks = []
    cursor = 0.0
    for ev in events:
        gap = int((ev.time_s - cursor) * args.sr)
        if gap > 0:
            chunks.append(eng.render(gap).cpu().numpy())
            cursor = ev.time_s
        if ev.kind == "on":
            eng.note_on(ev.note, ev.velocity / 127.0)
        elif ev.kind == "off":
            eng.note_off(ev.note)
        elif ev.kind == "sustain":
            eng.set_sustain(ev.velocity >= 64)
    tail = int((total_s - cursor + args.tail) * args.sr)
    if tail > 0:
        chunks.append(eng.render(tail).cpu().numpy())
    out = np.concatenate(chunks) if chunks else np.zeros(0)
    wav.write_wav(args.output, out, args.sr, bits=24)
    print(f"Rendered {args.input} ({len(events)} events, "
          f"{len(out)/args.sr:.1f}s) → {args.output}")


# ── audits / calibration ─────────────────────────────────────────────────


def cmd_alias_audit(args):
    from openwurli_tpu_torch.calib import alias_audit

    if args.note:
        entries = [(args.note, alias_audit.STIMULUS_VELOCITY,
                    alias_audit.run_with_note(args.note,
                                              device=args.device))]
    else:
        entries = alias_audit.run_sweep(device=args.device)
    report = []
    for note, vel, r in entries:
        print(f"note {note} v={vel}: f0={r.f0_hz:.1f} Hz  "
              f"H1 {r.h1_dbfs:.1f} dBFS  max_step_up {r.max_step_up_db:.3f} dB"
              f" (from H{r.max_step_up_from_harmonic})  "
              f"hf_band {r.hf_band_dbc:.3f} dBc")
        report.append({
            "note": note, "velocity": vel, "f0_hz": r.f0_hz,
            "max_step_up_db": r.max_step_up_db,
            "hf_band_dbc": r.hf_band_dbc,
            "harmonic_dbc": r.harmonic_dbc,
        })
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.output}")


def cmd_intermod_audit(args):
    from openwurli_tpu_torch import tables

    rep = tables.intermod_risk(np.arange(tables.MIDI_LO, tables.MIDI_HI + 1))
    max_risk = rep["max_risk"]
    total = rep["total_risk"]
    print("midi,f0_hz,mu,max_risk,total_risk")
    for i, m in enumerate(range(tables.MIDI_LO, tables.MIDI_HI + 1)):
        print(f"{m},{float(rep['fundamental_hz'][i]):.1f},"
              f"{float(rep['mu'][i]):.3f},"
              f"{max_risk[i]:.5f},{total[i]:.5f}")
    worst = int(np.argmax(max_risk)) + tables.MIDI_LO
    print(f"# worst: MIDI {worst} max_risk {max_risk.max():.5f}",
          file=sys.stderr)


def cmd_bark_audit(args):
    """H2/H1 at each chain stage for one note (pickup bark tracking)."""
    from openwurli_tpu_torch.calib import calibrate

    rows = calibrate.run_calibrate([args.note], [args.velocity],
                                   device=args.device)
    for tap in ("t2", "t4", "t5"):
        print(f"{tap} H2/H1: {rows[f'{tap}_h2_h1_db'][0,0]:.2f} dB")
    print(f"y_peak: {rows['y_peak'][0,0]:.3f}  "
          f"ds_actual: {rows['ds_actual'][0,0]:.3f}")


def cmd_calibrate(args):
    from openwurli_tpu_torch import tables
    from openwurli_tpu_torch.calib import calibrate

    notes = [int(x) for x in args.notes.split(",")]
    vels = [int(x) for x in args.velocities.split(",")]
    cfg = tables.CalibrationConfig(
        ds_at_c4=args.ds_at_c4,
        ds_clamp=(0.02, args.ds_clamp_max),
        zero_trim=args.zero_trim,
    )
    rows = calibrate.run_calibrate(notes, vels, cfg, volume=args.volume,
                                   speaker_char=args.speaker, mlp=args.mlp,
                                   device=args.device)
    calibrate.write_calibrate_csv(args.output, rows)
    print(f"Calibrate: {len(notes)} notes × {len(vels)} velocities "
          f"→ {args.output}")


def cmd_sensitivity(args):
    from openwurli_tpu_torch import tables
    from openwurli_tpu_torch.calib import calibrate

    notes = [int(x) for x in args.notes.split(",")]
    vels = [int(x) for x in args.velocities.split(",")]
    ds_values = [float(x) for x in args.ds_grid.split(",")]
    with open(args.output, "w") as f:
        f.write("ds_at_c4,midi,velocity,t2_h2_h1_db,t5_rms_db,y_peak\n")
        for ds in ds_values:
            cfg = tables.CalibrationConfig(ds_at_c4=ds)
            rows = calibrate.run_calibrate(notes, vels, cfg,
                                           device=args.device)
            for i in range(len(notes)):
                for j in range(len(vels)):
                    f.write(f"{ds},{notes[i]},{vels[j]},"
                            f"{rows['t2_h2_h1_db'][i,j]:.2f},"
                            f"{rows['t5_rms_db'][i,j]:.2f},"
                            f"{rows['y_peak'][i,j]:.4f}\n")
    print(f"Sensitivity grid → {args.output}")


def cmd_centroid_track(args):
    out = _render_di(args.note, args.velocity / 127.0, args.duration, args.sr,
                     args.device)
    win = int(args.sr * 0.05)
    print("t_s,centroid_hz")
    for i in range(len(out) // win):
        seg = out[i * win:(i + 1) * win]
        spec = np.abs(np.fft.rfft(seg))
        freqs = np.fft.rfftfreq(len(seg), 1 / args.sr)
        c = (spec * freqs).sum() / max(spec.sum(), 1e-12)
        print(f"{i*win/args.sr:.3f},{c:.1f}")


def cmd_overshoot(args):
    out = _render_di(args.note, args.velocity / 127.0, 0.3, args.sr,
                     args.device)
    sr = args.sr
    attack_peak = np.abs(out[: int(0.010 * sr)]).max()
    sustain = out[int(0.100 * sr):int(0.200 * sr)]
    sustain_rms = np.sqrt((sustain**2).mean())
    ratio_db = 20 * np.log10(max(attack_peak, 1e-12)
                             / max(sustain_rms, 1e-12))
    print(f"note {args.note}: 0-10ms peak {attack_peak:.4f}, "
          f"100-200ms RMS {sustain_rms:.4f}, overshoot {ratio_db:.2f} dB")


# ── shadow-pump characterisation ─────────────────────────────────────────


def _pump_trace(r_ldr_fn, seconds, sr, device="cuda"):
    """Run the shadow preamp solver with a time-varying R_ldr, record the
    pump (the shadow's OUT node voltage after each step).

    r_ldr_fn(t) may return (n,) for one trace or (n, P) for a whole grid
    of traces advanced in one E7 launch."""
    n = int(seconds * sr)
    rs = np.asarray(r_ldr_fn(np.arange(n) / sr), dtype=np.float64)
    batch_shape = rs.shape[1:]
    rs = rs.reshape(n, -1)
    out = _dk_scan(np.zeros_like(rs), rs, sr, "shadow", device)
    return out.reshape((n,) + batch_shape)


def cmd_pump_trace(args):
    trace = _pump_trace(lambda t: np.full_like(t, args.r_ldr), args.duration,
                        args.sr, args.device)
    print("t_s,shadow_out_v")
    step = max(1, len(trace) // 2000)
    for i in range(0, len(trace), step):
        print(f"{i/args.sr:.5f},{trace[i]:.6f}")


def cmd_pump_sweep(args):
    rs = np.geomspace(args.lo, args.hi, args.points)
    tr = _pump_trace(
        lambda t: np.broadcast_to(rs, (len(t), len(rs))), 0.5, args.sr,
        args.device)
    tails = tr[len(tr) // 2:]
    print("r_ldr_ohm,pump_pp_v")
    for k, r in enumerate(rs):
        print(f"{r:.0f},{tails[:, k].max()-tails[:, k].min():.6f}")


def cmd_pump_step(args):
    def r_fn(t):
        return np.where(t < args.duration / 2, args.r_a, args.r_b)

    tr = _pump_trace(r_fn, args.duration, args.sr, args.device)
    print("t_s,shadow_out_v")
    step = max(1, len(tr) // 4000)
    for i in range(0, len(tr), step):
        print(f"{i/args.sr:.5f},{tr[i]:.6f}")


def sinusoid_r_ldr(lo, hi, rate):
    """`pump-sinusoid`'s R_ldr law: log R swings between log lo and log
    hi at `rate` Hz."""
    def r_fn(t):
        log_mid = (np.log(lo) + np.log(hi)) / 2
        log_amp = (np.log(hi) - np.log(lo)) / 2
        return np.exp(log_mid + log_amp * np.sin(2 * np.pi * rate * t))

    return r_fn


def cmd_pump_sinusoid(args):
    tr = _pump_trace(sinusoid_r_ldr(args.lo, args.hi, args.rate),
                     args.duration, args.sr, args.device)
    tail = tr[len(tr) // 2:]
    print(f"pump pp under {args.rate} Hz log-R modulation: "
          f"{tail.max()-tail.min():.4f} V")


def cmd_pump_spike(args):
    rs = np.geomspace(30_000.0, 70_000.0, 41)
    tr_all = _pump_trace(
        lambda t: np.broadcast_to(rs, (len(t), len(rs))), 0.3, args.sr,
        args.device)
    print("r_ldr_ohm,pump_pp_v")
    for k, r in enumerate(rs):
        tail = tr_all[len(tr_all) // 2:, k]
        print(f"{r:.0f},{tail.max()-tail.min():.6f}")


def cmd_bench_reed(args):
    from openwurli_tpu_torch import voice

    sr = args.sr
    notes = np.tile(np.arange(33, 97), args.voices // 64 + 1)[
        : args.voices].astype(np.float64)
    vels = np.full(notes.shape, 0.8)
    vparams, detuned = voice.note_on_params(notes, vels, sr,
                                            mlp_enabled=False)
    state = voice.init_state(vparams, detuned, vels, sr,
                             voice.default_note_seed(notes))
    n = int(sr * args.duration)

    def render():
        voice.render(vparams, state, n, device=args.device)
        _sync(args.device)

    render()  # the kernel library's build and load
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        render()
    wall = (time.perf_counter() - t0) / reps
    rtf = args.duration / wall
    print(f"{args.voices} voices × {args.duration}s at {sr:.0f} Hz: "
          f"{wall:.3f}s wall → {rtf:.0f}x realtime")


# ── argument parsing ─────────────────────────────────────────────────────


def build_parser():
    p = argparse.ArgumentParser(
        prog="openwurli-tpu-torch",
        description="Wurlitzer 200A DSP validation & render tools "
                    "(PyTorch / CUDA)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the work (default: the card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, fn, **kw):
        sp = sub.add_parser(name, **kw)
        sp.set_defaults(fn=fn)
        return sp

    sp = add("gain", cmd_gain, help="Measure preamp gain at one frequency")
    sp.add_argument("--freq", type=float, default=1000.0)
    sp.add_argument("--amplitude", type=float, default=0.001)
    sp.add_argument("--r-ldr", type=float, default=1_000_000.0)
    sp.add_argument("--sr", type=float, default=88_200.0)

    sp = add("sweep", cmd_sweep, help="Frequency response sweep (log)")
    sp.add_argument("--lo", type=float, default=20.0)
    sp.add_argument("--hi", type=float, default=20_000.0)
    sp.add_argument("--points", type=int, default=25)
    sp.add_argument("--amplitude", type=float, default=0.001)
    sp.add_argument("--r-ldr", type=float, default=1_000_000.0)
    sp.add_argument("--sr", type=float, default=88_200.0)

    sp = add("harmonics", cmd_harmonics, help="Harmonic distortion (H2-H5)")
    sp.add_argument("--freq", type=float, default=440.0)
    sp.add_argument("--amplitude", type=float, default=0.005)
    sp.add_argument("--r-ldr", type=float, default=1_000_000.0)
    sp.add_argument("--sr", type=float, default=88_200.0)

    sp = add("tremolo-sweep", cmd_tremolo_sweep,
             help="Gain vs LDR resistance")
    sp.add_argument("--lo", type=float, default=8_000.0)
    sp.add_argument("--hi", type=float, default=1_000_000.0)
    sp.add_argument("--points", type=int, default=13)
    sp.add_argument("--freq", type=float, default=1000.0)
    sp.add_argument("--amplitude", type=float, default=0.001)
    sp.add_argument("--sr", type=float, default=88_200.0)

    sp = add("render", cmd_render, help="Reed→pickup→preamp DI render → WAV")
    sp.add_argument("-n", "--note", type=int, default=69)
    sp.add_argument("-v", "--velocity", type=int, default=100)
    sp.add_argument("--duration", type=float, default=2.0)
    sp.add_argument("--sr", type=float, default=44_100.0)
    sp.add_argument("--normalize", action="store_true")
    sp.add_argument("-o", "--output", default="/tmp/render.wav")

    sp = add("reed-render", cmd_reed_render,
             help="Voice-only render → 24-bit WAV (reed-renderer parity)")
    sp.add_argument("-n", "--note", type=int, default=69)
    sp.add_argument("-v", "--velocity", type=int, default=100)
    sp.add_argument("--duration", type=float, default=2.0)
    sp.add_argument("--sr", type=float, default=44_100.0)
    sp.add_argument("--sweep", action="store_true",
                    help="render 9 notes across the keyboard")
    sp.add_argument("-o", "--output", default="/tmp/reed.wav")

    sp = add("render-poly", cmd_render_poly,
             help="Simultaneous notes through the shared chain")
    sp.add_argument("--notes", default="48,55,60,64,67,72")
    sp.add_argument("-v", "--velocity", type=int, default=100)
    sp.add_argument("--duration", type=float, default=10.0)
    sp.add_argument("--volume", type=float, default=0.5)
    sp.add_argument("--tremolo", type=float, default=0.5)
    sp.add_argument("--speaker", type=float, default=0.0)
    sp.add_argument("--sr", type=float, default=44_100.0)
    sp.add_argument("-o", "--output", default="/tmp/poly.wav")
    sp.add_argument("--fast", action="store_true",
                    help="fused float32 kernel path (sustained render; "
                         "see openwurli_tpu_torch.fast)")
    sp.add_argument("--noise-level", type=float, default=0.0,
                    help="circuit thermal-noise gain (reference "
                         "'Authentic Noise'/'Noise Level'; 0 = off)")

    sp = add("render-midi", cmd_render_midi,
             help="Render a MIDI file through the full chain")
    sp.add_argument("input")
    sp.add_argument("--volume", type=float, default=0.5)
    sp.add_argument("--tremolo", type=float, default=0.5)
    sp.add_argument("--speaker", type=float, default=0.0)
    sp.add_argument("--tail", type=float, default=2.0)
    sp.add_argument("--sr", type=float, default=44_100.0)
    sp.add_argument("-o", "--output", default="/tmp/midi.wav")
    sp.add_argument("--fast", action="store_true",
                    help="event-capable fused kernel path (note-off/"
                         "damper/sustain resolved host-side; "
                         "fast.render_midi_file)")
    sp.add_argument("--serial", action="store_true",
                    help="with --fast: force the serial block-streamed "
                         "path instead of the time-parallel renderer")
    sp.add_argument("--noise-level", type=float, default=0.0,
                    help="circuit thermal-noise gain (reference "
                         "'Authentic Noise'/'Noise Level'; 0 = off)")

    sp = add("alias-audit", cmd_alias_audit,
             help="Click-band aliasing audit (H6-H11 plateau + HF hash)")
    sp.add_argument("--note", type=int, default=0)
    sp.add_argument("-o", "--output", default="")

    add("intermod-audit", cmd_intermod_audit,
        help="Inharmonic intermod beating risk per note")

    sp = add("bark-audit", cmd_bark_audit,
             help="H2/H1 at each chain stage")
    sp.add_argument("-n", "--note", type=int, default=60)
    sp.add_argument("-v", "--velocity", type=int, default=127)

    sp = add("calibrate", cmd_calibrate,
             help="Gain chain at 5 tap points → CSV")
    sp.add_argument("--notes",
                    default="36,40,44,48,52,56,60,64,68,72,76,80,84")
    sp.add_argument("--velocities", default="40,80,127")
    sp.add_argument("--ds-at-c4", type=float, default=0.85)
    sp.add_argument("--ds-clamp-max", type=float, default=0.95)
    sp.add_argument("--volume", type=float, default=0.40)
    sp.add_argument("--speaker", type=float, default=1.0)
    sp.add_argument("--zero-trim", action="store_true")
    sp.add_argument("--mlp", action="store_true")
    sp.add_argument("-o", "--output", default="/tmp/calibrate.csv")

    sp = add("sensitivity", cmd_sensitivity, help="Multi-DS grid sweep → CSV")
    sp.add_argument("--notes", default="36,48,60,72,84")
    sp.add_argument("--velocities", default="80,127")
    sp.add_argument("--ds-grid", default="0.65,0.75,0.85,0.95")
    sp.add_argument("-o", "--output", default="/tmp/sensitivity.csv")

    sp = add("centroid-track", cmd_centroid_track,
             help="Spectral centroid over time")
    sp.add_argument("-n", "--note", type=int, default=60)
    sp.add_argument("-v", "--velocity", type=int, default=100)
    sp.add_argument("--duration", type=float, default=2.0)
    sp.add_argument("--sr", type=float, default=44_100.0)

    sp = add("overshoot", cmd_overshoot,
             help="Onset overshoot (0-10ms peak vs 100-200ms RMS)")
    sp.add_argument("-n", "--note", type=int, default=60)
    sp.add_argument("-v", "--velocity", type=int, default=100)
    sp.add_argument("--sr", type=float, default=44_100.0)

    sp = add("pump-trace", cmd_pump_trace,
             help="Shadow pump time series at fixed R_ldr")
    sp.add_argument("--r-ldr", type=float, default=47_500.0)
    sp.add_argument("--duration", type=float, default=1.0)
    sp.add_argument("--sr", type=float, default=88_200.0)

    sp = add("pump-sweep", cmd_pump_sweep,
             help="Steady-state pump vs R_ldr")
    sp.add_argument("--lo", type=float, default=8_000.0)
    sp.add_argument("--hi", type=float, default=1_000_000.0)
    sp.add_argument("--points", type=int, default=13)
    sp.add_argument("--sr", type=float, default=88_200.0)

    sp = add("pump-step", cmd_pump_step, help="Pump step response R_a→R_b")
    sp.add_argument("--r-a", type=float, default=1_000_000.0)
    sp.add_argument("--r-b", type=float, default=19_000.0)
    sp.add_argument("--duration", type=float, default=1.0)
    sp.add_argument("--sr", type=float, default=88_200.0)

    sp = add("pump-sinusoid", cmd_pump_sinusoid,
             help="Pump under sinusoidal log-R modulation")
    sp.add_argument("--lo", type=float, default=9_000.0)
    sp.add_argument("--hi", type=float, default=1_000_000.0)
    sp.add_argument("--rate", type=float, default=5.5)
    sp.add_argument("--duration", type=float, default=2.0)
    sp.add_argument("--sr", type=float, default=88_200.0)

    sp = add("pump-spike", cmd_pump_spike,
             help="Probe the ~47.5 kΩ pump resonance region")
    sp.add_argument("--sr", type=float, default=88_200.0)

    sp = add("bench-reed", cmd_bench_reed,
             help="Reed-bank realtime-ratio microbenchmark")
    sp.add_argument("--voices", type=int, default=64)
    sp.add_argument("--duration", type=float, default=1.0)
    sp.add_argument("--sr", type=float, default=44_100.0)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
