#!/usr/bin/env python3
"""Where E4's time goes on an NVIDIA GPU: the voice render (`voice.render`,
`di.render_di`'s voices) and E4<tap> (`run_calibrate`'s reed and pickup
taps).

Builds tools/voice_breakdown.cu (E4 before its lane redesign, a thread per
voice; the same with its libm calls only where they are selected; the
lane kernel at 32 and 128 threads per block, with staged stores, and a
copy stamped with the SM's cycle counter between its parts) with the
port's nvcc flags into build/voice_breakdown/, and runs every variant on
two cases at --samples samples:

  * `render_di`'s 512 voices (the calibration grid's 64 keys × 8
    velocities, note-on as `di.render_di` packs them) through E4;
  * `run_calibrate`'s 512 taps (`calibrate.pack_taps` at BASELINE config
    4: 64 keys × velocities 1-127) through E4<tap>.

Every variant is first checked bit for bit (output, reed and state)
against the library's kernel (`kernels.render.voice_render` /
`voice_tap`) on both cases and on 133 ragged voices with a NaN and an inf
voice. It then times each with CUDA events (ms, µs per sample step) and
splits the stamped one's time into its parts: each part's share of the
stamped cycles times the stamped variant's time.

E1 (the f64 engine's voice slots) on an engine session's 128 slots
(chip_smoke.py phase 21's: ten notes, 2048 samples of history, the bank
filled by steals; `--e1-slots chord`: the perf sweep's chord just
struck) at --e1-engines engines (each copy at its own sample
offset and steal fade), 256-sample chunks: its cluster form (E4's group
body on a cluster of eight blocks per engine) is checked bit for bit
against `kernels.engine.render_voices` first, then timed beside its two
knock-outs (no slot sum; no tile, cluster barrier or sum); its thread
form (a thread per slot) without its votes (as it ran before) and with
them at launch bounds of 1 (the library's), 3 and 4 blocks per SM, each
checked bit for bit against render_voices too; and E4 on the same slots
(`kernels.render.voice_render`, the group body without E1's gates and
sum), up to 128 engines. Each variant's copies of the slots are made
before its timed calls. Run on a machine with a card:

    python tools/torch_voice_breakdown.py [--samples 2048] [--reps 3]
        [--e1-engines 1,5,128] [--e1-slots session|chord]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

# voice_breakdown.cu's variants and E4Part, in order
VARIANTS = ("thread (E4 before)", "thread, libm guarded",
            "lanes, 32 per block", "lanes, 128 per block",
            "lanes, staged stores, 128 per block", "lanes, stamped, 32")
STAMPED = len(VARIANTS) - 1
PARTS = ("modes", "sum", "tail", "stores")
# voice_breakdown.cu's E1 variants, in order; E1's engines and chunk
E1_VARIANTS = ("E1 (library)", "E1 without the slot sum",
               "E1 without tile, cluster barrier and sum",
               "E1 thread form without votes (before)",
               "E1 thread form, votes, 1 block per SM (library)",
               "E1 thread form, votes, 3 blocks per SM",
               "E1 thread form, votes, 4 blocks per SM")
# the variants that compute E1 (the knock-outs do not)
E1_EXACT = (0, 3, 4, 5, 6)
E1_CHUNK = 256
SR = 44100.0
# BASELINE.json config 4 (chip_smoke.py's CALIB_NOTES, CALIB_VELOCITIES)
CALIB_NOTES = tuple(range(33, 97))
CALIB_VELOCITIES = (1, 20, 40, 60, 80, 100, 120, 127)


def build():
    from openwurli_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "voice_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libe4b.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
           os.path.join(REPO, "tools", "voice_breakdown.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.e4b_launch.argtypes = [i, i, p, p, p, p, p, p, i, i, p]
    d = ctypes.c_double
    dll.e1b_launch.argtypes = [i, p, p, p, p, p, i, i, d, d, p]
    for f in (dll.e4b_launch, dll.e4b_count, dll.e4b_parts, dll.e1b_launch,
              dll.e1b_count):
        f.restype = i
    if dll.e4b_count() != len(VARIANTS) or dll.e4b_parts() != len(PARTS) \
            or dll.e1b_count() != len(E1_VARIANTS):
        raise RuntimeError("the tool's lists and voice_breakdown.cu differ")
    return dll, proc.stdout + proc.stderr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--e1-engines", default="1,5,128")
    ap.add_argument("--e1-slots", choices=("session", "chord"),
                    default="session")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from openwurli_tpu_torch import tables, voice
    from openwurli_tpu_torch.calib import calibrate
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    if not torch.cuda.is_available():
        raise SystemExit("torch_voice_breakdown: no CUDA device")
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dll, log = build()
    stream = torch.cuda.current_stream().cuda_stream

    def bits(a):
        return a.contiguous().view(torch.int64)

    def same(a, b):
        return torch.equal(bits(a), bits(b))

    def run(w, tap, cols, n):
        a = [c.clone() for c in cols]
        g = cols[0].shape[1]
        out = torch.empty((n, g), dtype=torch.float64, device=dev)
        reed = torch.empty_like(out)
        parts = torch.zeros((len(PARTS), g), dtype=torch.int64, device=dev)
        err = dll.e4b_launch(w, int(tap), *[c.data_ptr() for c in a],
                             out.data_ptr(), reed.data_ptr(),
                             parts.data_ptr(), g, n, stream)
        if err:
            raise RuntimeError(f"variant {VARIANTS[w]}: cudaError {err}")
        return out, reed, a, parts

    def ms_of(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    # the DI grid's voices, as di.render_di packs them
    midis = np.arange(33, 97, dtype=np.float64)
    vels = (np.arange(8) + 0.5) / 8
    mg, vg = (a.ravel() for a in np.meshgrid(midis, vels, indexing="ij"))
    vp, det = voice.note_on_params(mg, vg, SR, mlp_enabled=False)
    di_cols = kr.voice_columns(
        vp, voice.init_state(vp, det, vg, SR, voice.default_note_seed(mg)),
        dev)
    # run_calibrate's taps
    cm, cv = (a.ravel() for a in np.meshgrid(
        np.asarray(CALIB_NOTES, np.float64),
        np.asarray(CALIB_VELOCITIES) / 127.0, indexing="ij"))
    tap_cols = calibrate.pack_taps(cm, cv, tables.CalibrationConfig(),
                                   dev).cols
    # 133 ragged voices, a NaN and an inf voice (chip_smoke.py phase 23)
    rng = np.random.default_rng(23)
    rm = rng.integers(33, 97, 133).astype(np.float64)
    rv = rng.uniform(0.05, 1.0, 133)
    vp_r, det_r = voice.note_on_params(rm, rv, SR, mlp_enabled=True)
    rag_cols = kr.voice_columns(vp_r, voice.init_state(
        vp_r, det_r, rv, SR, voice.default_note_seed(rm)), dev)
    rag_cols[0][ek.P_AMP + 2, 7] = float("nan")
    rag_cols[1][ek.S_C, 50] = float("inf")

    n = args.samples
    cases = (("render_di's 512 voices (E4)", False, di_cols),
             ("run_calibrate's 512 taps (E4<tap>)", True, tap_cols))
    for tap in (False, True):
        checks = [(c, n) for _, t, c in cases if t == tap] + [(rag_cols,
                                                               1100)]
        for cols, nc in checks:
            a = [c.clone() for c in cols]
            if tap:
                ref, ref_reed = kr.voice_tap(*a, nc)
            else:
                ref = kr.voice_render(*a, nc)
            for w, name in enumerate(VARIANTS):
                out, reed, st, _ = run(w, tap, cols, nc)
                if not (same(out, ref) and all(same(x, y)
                                                for x, y in zip(st, a))
                        and (not tap or same(reed, ref_reed))):
                    raise RuntimeError(f"{name} differs from the library's "
                                       f"kernel (tap {tap})")

    results = {}
    for label, tap, cols in cases:
        lib_fn = ((lambda: kr.voice_tap(*[c.clone() for c in cols], n))
                  if tap else
                  (lambda: kr.voice_render(*[c.clone() for c in cols], n)))
        rows = [{"variant": "library (kernels.render)",
                 "ms": ms_of(lib_fn)}]
        for w, name in enumerate(VARIANTS):
            row = {"variant": name,
                   "ms": ms_of(lambda: run(w, tap, cols, n))}
            if w == STAMPED:
                cyc = run(w, tap, cols, n)[3].double().cpu()
                share = cyc / cyc.sum(0)
                row["parts_ms"] = dict(zip(PARTS, (
                    share.mean(1) * row["ms"]).tolist()))
            rows.append(row)
        for row in rows:
            row["us_per_sample"] = row["ms"] * 1e3 / n
        results[label] = rows

    e1 = e1_rows(dll, dev, same, stream, args.reps,
                 [int(x) for x in args.e1_engines.split(",")],
                 args.e1_slots)
    print(f"{card}; {n} samples, {args.reps} reps; every variant "
          "bit-identical to the library's kernel on both cases and on 133 "
          "ragged voices (NaN, inf)")
    for label, rows in results.items():
        print(label)
        for row in rows:
            print(f"{row['ms']:10.3f} ms {row['us_per_sample']:8.3f} us per "
                  f"sample  {row['variant']}")
            if "parts_ms" in row:
                print("            " + ", ".join(
                    f"{k} {v:.3f}" for k, v in row["parts_ms"].items())
                    + " ms")
    print(f"E1, {E1_CHUNK}-sample chunks (the cluster form and the four "
          "thread forms bit-identical to render_voices; the knock-outs "
          "timed only)")
    for b, rows in e1.items():
        print(f"  {b} engine{'s' if b > 1 else ''}: " + "; ".join(
            f"{r['variant']} {r['ms']:.4f} ms" for r in rows))
    ptxas = [" ".join(line.split()) for line in log.splitlines()
             if "e4b_" in line or "voice_lanes" in line or "Used" in line
             or "engine_voices" in line or "stack frame" in line]
    print(json.dumps({"card": card, "samples": n, "results": results,
                      "e1_chunk": E1_CHUNK, "e1": e1, "ptxas": ptxas}))
    return results


def e1_rows(dll, dev, same, stream, reps, widths, slots="session"):
    """E1's variants, and E4 on the same slots up to 128 engines, at
    `widths` engines: {engines: [{"variant", "ms"}]}. `slots` "chord":
    the perf sweep's chord (MIDI 48, 55, 60, 63, 67, 70 at 0.95) just
    struck on a fresh engine, as tools/torch_perf_sweep.py and
    chip_smoke.py phase 28 (d) broadcast it, in place of the session."""
    import torch

    from openwurli_tpu_torch.engine import Engine
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    eng = Engine(SR, device=dev)
    if slots == "chord":
        for note in (48, 55, 60, 63, 67, 70):
            eng.note_on(note, 0.95)
    else:
        for k, note in enumerate((41, 48, 55, 60, 64, 67, 72, 79, 84, 93)):
            eng.note_on(note, 0.35 + 0.06 * k)
        eng.render(2048)
        for note in range(33, 97):  # fills the bank; steals with fades
            eng.note_on(note, 0.5)
    n = E1_CHUNK

    def launch(w, a):
        mono = torch.empty((a[0].shape[0], n), dtype=torch.float64,
                           device=dev)
        err = dll.e1b_launch(w, *[c.data_ptr() for c in a],
                             mono.data_ptr(), n, a[0].shape[0],
                             eng.fade_len, SR, stream)
        if err:
            raise RuntimeError(f"{E1_VARIANTS[w]}: cudaError {err}")
        return mono, a

    def timed(fn, cols):
        """ms per call of fn over reps copies made beforehand (one call
        first)."""
        copies = [[c.clone() for c in cols] for _ in range(reps + 1)]
        fn(copies[0])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in copies[1:]:
            fn(c)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {}
    for b in widths:
        cols = [x.expand(b, *x.shape).clone()
                for x in (eng.vpar, eng.vst, eng.vsti, eng.eng_i)]
        e = torch.arange(b, device=dev)
        cols[2][:, ek.I_N] += 37 * e[:, None]
        cols[3][:, ek.MAX_VOICES:ek.SLOTS] = torch.clamp(
            cols[3][:, ek.MAX_VOICES:ek.SLOTS] - e[:, None], min=0)
        ref = [c.clone() for c in cols]
        ref_mono = ek.render_voices(*ref, n, eng.fade_len, SR)
        for w in E1_EXACT:
            mono, st = launch(w, [c.clone() for c in cols])
            if not (same(mono, ref_mono)
                    and all(same(x, y) for x, y in zip(st, ref))):
                raise RuntimeError(f"{E1_VARIANTS[w]} at {b} engines "
                                   "differs from render_voices")
        rows = [{"variant": name,
                 "ms": timed(lambda a, w=w: launch(w, a), cols)}
                for w, name in enumerate(E1_VARIANTS)]
        if b <= 128:
            voices = [c.transpose(0, 1).reshape(c.shape[1], -1).contiguous()
                      for c in cols[:3]]
            rows.append({"variant": "E4 on the same slots",
                         "ms": timed(lambda v: kr.voice_render(*v, n),
                                     voices)})
        out[b] = rows
    return out


if __name__ == "__main__":
    main()
