#!/usr/bin/env python3
"""Where one twin DK preamp step's time goes on an NVIDIA GPU.

Builds tools/dk_breakdown.cu (the DK step as one thread walks it and as a
warp runs it, each beside a copy stamped with the SM's cycle counter
between the step's parts) with the port's nvcc flags into
build/dk_breakdown/, checks that every variant equals E7
(`kernels.render.dk_scan`, tap "diff") bit for bit, output and state, on
the CLI `sweep`'s 25 streams and on 33 streams with NaN and inf inputs and
resistances, then times each variant over the sweep's streams with CUDA
events and prints µs per step. The stamped variants split the step into
the history, the predictor, Newton (per residual pass), the final
currents and node update, and the commit: each part's share of the
stamped cycles times the stamped variant's µs per step. Last, E5<dk> as
it ran before (a thread per stream) and as it runs now (a warp per
stream) on the DI grid's 512 voices (`render_di`'s), both checked bit for
bit against `kernels.render.preamp_scan`. Run on a machine with a card:

    python tools/torch_dk_breakdown.py [--steps 4096] [--e5-samples 2048]
                                       [--reps 3]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

# (name, stamped), in db_launch's order; every variant is exact
VARIANTS = [
    ("one thread: preamp_step, a thread per stream (E7 before)", False),
    ("one thread: stamped", True),
    ("warp: dk_step_warp, a warp per stream (E7<diff>)", False),
    ("warp: stamped", True),
    ("warp: stamped, both exps on every lane", True),
    ("warp: E7<diff> without its step-ahead loads", False),
]
E5_VARIANTS = ["E5<dk> before: a thread per stream",
               "E5<dk>: a warp per stream (preamp_scan_kernel<dk>)"]
PARTS = ("history", "predictor", "newton", "final", "commit")
SR = 88200.0       # the CLI's --sr, and E5's oversampled step rate
BASE_SR = 44100.0  # the DI grid's rate


def build():
    from openwurli_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "dk_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libdb.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
           os.path.join(REPO, "tools", "dk_breakdown.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.db_launch.argtypes = [i, p, i, p, p, p, p, p, i, i, p]
    dll.db_e5_launch.argtypes = [i, p, i, p, p, p, p, i, i, p]
    dll.db_launch.restype = dll.db_e5_launch.restype = i
    dll.db_count.restype = dll.db_e5_count.restype = i
    if (dll.db_count() != len(VARIANTS)
            or dll.db_e5_count() != len(E5_VARIANTS)):
        raise RuntimeError("VARIANTS and kVariants differ in length")
    return dll, proc.stdout + proc.stderr


def sweep_streams(n, dev):
    """`sweep`'s defaults: 25 log-spaced frequencies from 20 Hz to 20 kHz,
    1 mV, 1 MΩ, 88.2 kHz. → x, r (n, 25)."""
    import numpy as np
    import torch

    f = np.geomspace(20.0, 20_000.0, 25)
    t = np.arange(n)[:, None] / SR
    x = torch.as_tensor(0.001 * np.sin(2 * np.pi * f[None, :] * t),
                        device=dev)
    return x.contiguous(), torch.full_like(x, 1e6)


def nan_streams(dev, n=300, g=33):
    """Seeded millivolt sines at seeded resistances from 500 Ω to 2 MΩ; a
    NaN input, an inf input from midway, a NaN and an inf resistance.
    → x, r (n, g)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(17)
    t = np.arange(n)[:, None]
    x = rng.uniform(1e-4, 5e-3, g) * np.sin(rng.uniform(0.001, 0.5, g) * t)
    r = np.exp(rng.uniform(np.log(500.0), np.log(2e6), (n, g)))
    x[n // 3, 5] = np.nan
    x[n // 2:, 17] = np.inf
    r[n // 4, 31] = np.nan
    r[n // 5:, 2] = np.inf
    return (torch.as_tensor(x, device=dev).contiguous(),
            torch.as_tensor(r, device=dev).contiguous())


def di_audio(n, dev):
    """`render_di`'s 512 voices (notes 33-96 × 8 velocities, the MLP off)
    over their first n samples at 44.1 kHz, through E4. → (n, 512)."""
    import numpy as np

    from openwurli_tpu_torch import voice
    from openwurli_tpu_torch.kernels import render as kr

    mg, vg = (a.ravel() for a in np.meshgrid(
        np.arange(33, 97, dtype=np.float64), (np.arange(8) + 0.5) / 8,
        indexing="ij"))
    vp, det = voice.note_on_params(mg, vg, BASE_SR, mlp_enabled=False)
    vs = voice.init_state(vp, det, vg, BASE_SR, voice.default_note_seed(mg))
    return kr.voice_render(*kr.voice_columns(vp, vs, dev), n)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4096,
                    help="steps per sweep stream (the CLI runs 44100)")
    ap.add_argument("--e5-samples", type=int, default=2048,
                    help="DI samples per stream (render_di runs 88200)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from openwurli_tpu_torch.kernels import render as kr

    if not torch.cuda.is_available():
        raise SystemExit("torch_dk_breakdown: no CUDA device")
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dll, log = build()
    consts = torch.from_numpy(kr.preamp_consts("dk", SR)).to(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(w, x, r, st):
        out = torch.empty_like(x)
        parts = torch.zeros((len(PARTS) + 1, x.shape[1]), dtype=torch.int64,
                            device=dev)
        err = dll.db_launch(w, consts.data_ptr(), consts.numel(),
                            x.data_ptr(), r.data_ptr(), st.data_ptr(),
                            out.data_ptr(), parts.data_ptr(), x.shape[0],
                            x.shape[1], stream)
        if err:
            raise RuntimeError(f"variant {w}: cudaError {err}")
        return out, parts

    def run_e5(w, x, st, g):
        out = torch.empty_like(x)
        err = dll.db_e5_launch(w, consts.data_ptr(), consts.numel(),
                               x.data_ptr(), st.data_ptr(), g.data_ptr(),
                               out.data_ptr(), x.shape[0], x.shape[1],
                               stream)
        if err:
            raise RuntimeError(f"E5 variant {w}: cudaError {err}")
        return out

    def bits(a):
        return a.contiguous().view(torch.int64)

    def same(a, b):
        return torch.equal(bits(a), bits(b))

    sweep = sweep_streams(args.steps, dev)
    for x, r in (sweep, nan_streams(dev)):
        st0 = kr.init_dk_scan_state(SR, x.shape[1], dev)
        ref_st = st0.clone()
        ref = kr.dk_scan(SR, x, r, ref_st, "diff")
        for w, (name, _) in enumerate(VARIANTS):
            st = st0.clone()
            out, _ = run(w, x, r, st)
            if not (same(out, ref) and same(st, ref_st)):
                raise RuntimeError(f"{name} differs from E7")

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

    x, r = sweep
    st0 = kr.init_dk_scan_state(SR, x.shape[1], dev)
    per_step = 1e3 / args.steps
    rows = [{"variant": "E7<diff> through kr.dk_scan",
             "us_per_step": ms_of(lambda: kr.dk_scan(
                 SR, x, r, st0.clone(), "diff")) * per_step}]
    for w, (name, stamped) in enumerate(VARIANTS):
        row = {"variant": name, "us_per_step": ms_of(
            lambda: run(w, x, r, st0.clone())) * per_step}
        if stamped:
            _, parts = run(w, x, r, st0.clone())
            cyc = parts[:len(PARTS)].double().cpu()
            share = cyc / cyc.sum(0)
            us = (share * row["us_per_step"]).mean(1)
            passes = parts[len(PARTS)].double().cpu() / args.steps
            row["parts_us_per_step"] = dict(zip(PARTS, us.tolist()))
            row["cycles_per_step"] = dict(zip(
                PARTS, (cyc.mean(1) / args.steps).tolist()))
            row["newton_passes_per_step"] = [passes.min().item(),
                                             passes.mean().item(),
                                             passes.max().item()]
            row["us_per_newton_pass"] = float(
                (share[2] * row["us_per_step"] / passes).mean())
        rows.append(row)

    # E5<dk>, before and now, on the DI grid's 512 streams
    n5 = args.e5_samples
    audio = di_audio(n5, dev)
    g5 = torch.full((audio.shape[1],), 1e-6, dtype=torch.float64,
                    device=dev)
    st5 = kr.init_dk_state(SR, audio.shape[1], dev)
    ref_st = st5.clone()
    ref = kr.preamp_scan("dk", SR, audio, ref_st, g5)
    e5_rows = []
    for w, name in enumerate(E5_VARIANTS):
        st = st5.clone()
        out = run_e5(w, audio, st, g5)
        if not (same(out, ref) and same(st, ref_st)):
            raise RuntimeError(f"{name} differs from E5<dk>")
        ms = ms_of(lambda: run_e5(w, audio, st5.clone(), g5))
        e5_rows.append({"variant": name, "ms": ms,
                        "us_per_dk_step": ms * 1e3 / (2 * n5)})

    print(f"{card}; E7: {x.shape[1]} streams (sweep's) x {args.steps} steps "
          f"at {SR:g} Hz, {args.reps} reps; every variant bit-identical to "
          "E7 there and on 33 streams with NaN and inf")
    for row in rows:
        print(f"{row['us_per_step']:9.3f} us  {row['variant']}")
        if "parts_us_per_step" in row:
            lo, mean, hi = row["newton_passes_per_step"]
            print("           " + ", ".join(
                f"{k} {v:.3f}" for k, v in row["parts_us_per_step"].items())
                + f" us per step; {row['us_per_newton_pass']:.3f} us per "
                f"Newton pass; passes per step {lo:.2f}-{hi:.2f} (mean "
                f"{mean:.2f})")
    print(f"E5<dk> on the DI grid's {audio.shape[1]} streams x {n5} "
          "samples, both bit-identical to E5<dk>:")
    for row in e5_rows:
        print(f"{row['ms']:9.3f} ms = {row['us_per_dk_step']:.3f} us per "
              f"DK step  {row['variant']}")
    ptxas = [" ".join(line.split()) for line in log.splitlines()
             if "db_" in line or "dk_" in line or "preamp_scan" in line
             or "Used" in line or "stack frame" in line]
    print(json.dumps({"card": card, "steps": args.steps, "rows": rows,
                      "e5_samples": n5, "e5_rows": e5_rows,
                      "ptxas": ptxas}))
    return rows, e5_rows


if __name__ == "__main__":
    main()
