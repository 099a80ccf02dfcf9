#!/usr/bin/env python3
"""Where one melange preamp step's time goes on an NVIDIA GPU.

Builds tools/melange_breakdown.cu (the melange step as one thread walks it
and as a warp runs it, each beside a copy stamped with the SM's cycle
counter between the step's parts) with the port's nvcc flags into
build/melange_breakdown/, checks that every variant equals E5<melange>
(`kernels.render.preamp_scan`) bit for bit, output and state, on the
physics gates' six streams and on six streams with a NaN input, then
times each variant over the gates' streams with CUDA events and prints µs
per step. The stamped variants split the step into the draws, the
predictor, Newton (per residual pass) and the corrector: each part's share
of the stamped cycles times the stamped variant's µs per step. Run on a
machine with a card:

    python tools/torch_melange_breakdown.py [--steps 8192] [--reps 3]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

# (name, stamped), in mb_launch's order; every variant is exact
VARIANTS = [
    ("one thread: melange_step, a thread per stream", False),
    ("one thread: stamped", True),
    ("warp: melange_step_warp, a warp per stream (E5<melange>)", False),
    ("warp: stamped", True),
    ("warp: stamped, derivatives beside the currents", True),
]
PARTS = ("draws", "predictor", "newton", "corrector")
SR = 88200.0  # the melange step's rate in the oversampled chain


def build():
    from openwurli_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "melange_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libmb.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
           os.path.join(REPO, "tools", "melange_breakdown.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.mb_launch.argtypes = [i, p, i, p, p, p, p, p, p, i, i, p]
    dll.mb_launch.restype = i
    dll.mb_count.restype = i
    if dll.mb_count() != len(VARIANTS):
        raise RuntimeError("VARIANTS and kVariants differ in length")
    return dll, proc.stdout + proc.stderr


def gate_streams(n, dev):
    """chip_smoke.py phase 25's streams: a 1 mV 1 kHz sine at 1 MΩ,
    19 kΩ and 12 kΩ without noise; silence at 100 kΩ (noise 1x) and at
    1 MΩ (noise 1x and 4x). → x (n, 6), g_ldr, noise scale."""
    import numpy as np
    import torch

    tt = torch.arange(n, dtype=torch.float64, device=dev) / SR
    sine = 0.001 * torch.sin(2 * np.pi * 1000.0 * tt)
    zero = torch.zeros_like(sine)
    x = torch.stack([sine, sine, sine, zero, zero, zero], dim=1)
    g = torch.tensor([1.0 / max(r, 1000.0) for r in
                      (1e6, 19e3, 12e3, 1e5, 1e6, 1e6)],
                     dtype=torch.float64, device=dev)
    sc = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 4.0], dtype=torch.float64,
                      device=dev)
    return x.contiguous(), g, sc


def nan_streams(dev):
    """chip_smoke.py phase 23's six streams × 160: millivolt sines, three
    conductances, noise scales 0, 1 and 30, a NaN input."""
    import torch

    t = torch.arange(160, dtype=torch.float64, device=dev)
    x = 0.002 * torch.sin(t[:, None] * torch.tensor(
        [0.01, 0.05, 0.03, 0.07, 0.02, 0.04], dtype=torch.float64,
        device=dev))
    x[40, 5] = float("nan")
    g = torch.tensor([1e-6, 1e-5, 1.0 / 19e3, 1e-6, 1e-5, 1.0 / 19e3],
                     dtype=torch.float64, device=dev)
    sc = torch.tensor([0.0, 1.0, 30.0, 30.0, 1.0, 0.0], dtype=torch.float64,
                      device=dev)
    return x.contiguous(), g, sc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8192,
                    help="steps per stream (the gates run 105840)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from openwurli_tpu_torch.kernels import render as kr

    if not torch.cuda.is_available():
        raise SystemExit("torch_melange_breakdown: no CUDA device")
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dll, log = build()
    consts = torch.from_numpy(kr.preamp_consts("melange", SR)).to(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(w, x, g, sc, st):
        out = torch.empty_like(x)
        parts = torch.zeros((len(PARTS) + 1, x.shape[1]), dtype=torch.int64,
                            device=dev)
        err = dll.mb_launch(w, consts.data_ptr(), consts.numel(),
                            x.data_ptr(), st.data_ptr(), g.data_ptr(),
                            sc.data_ptr(), out.data_ptr(), parts.data_ptr(),
                            x.shape[0], x.shape[1], stream)
        if err:
            raise RuntimeError(f"variant {w}: cudaError {err}")
        return out, parts

    def bits(a):
        return a.contiguous().view(torch.int64)

    gates = gate_streams(args.steps, dev)
    for x, g, sc in (gates, nan_streams(dev)):
        st0 = kr.init_melange_state(SR, x.shape[1], dev)
        ref_st = st0.clone()
        ref = kr.preamp_scan("melange", SR, x, ref_st, g, sc)
        for w, (name, _) in enumerate(VARIANTS):
            st = st0.clone()
            out, _ = run(w, x, g, sc, st)
            if not (torch.equal(bits(out), bits(ref))
                    and torch.equal(bits(st), bits(ref_st))):
                raise RuntimeError(f"{name} differs from E5<melange>")

    x, g, sc = gates
    st0 = kr.init_melange_state(SR, x.shape[1], dev)

    def us_per_step(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps * 1e3 / args.steps

    rows = [{"variant": "E5<melange> through kr.preamp_scan",
             "us_per_step": us_per_step(lambda: kr.preamp_scan(
                 "melange", SR, x, st0.clone(), g, sc))}]
    for w, (name, stamped) in enumerate(VARIANTS):
        row = {"variant": name, "us_per_step": us_per_step(
            lambda: run(w, x, g, sc, st0.clone()))}
        if stamped:
            _, parts = run(w, x, g, sc, st0.clone())
            cyc = parts[:len(PARTS)].double().cpu()
            share = cyc / cyc.sum(0)
            us = (share * row["us_per_step"]).mean(1)
            passes = parts[len(PARTS)].double().cpu() / args.steps
            row["parts_us_per_step"] = dict(zip(PARTS, us.tolist()))
            row["cycles_per_step"] = dict(zip(
                PARTS, (cyc.mean(1) / args.steps).tolist()))
            row["newton_passes_per_step"] = passes.tolist()
            row["us_per_newton_pass"] = float(
                (share[2] * row["us_per_step"] / passes).mean())
        rows.append(row)
    print(f"{card}; {x.shape[1]} streams (the physics gates') x "
          f"{args.steps} steps at {SR:g} Hz, {args.reps} reps; every "
          "variant bit-identical to E5<melange>")
    for r in rows:
        print(f"{r['us_per_step']:9.3f} us  {r['variant']}")
        if "parts_us_per_step" in r:
            print("           " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["parts_us_per_step"].items())
                + f" us per step; {r['us_per_newton_pass']:.3f} us per "
                "Newton pass; passes per step "
                + " ".join(f"{p:.2f}" for p in r["newton_passes_per_step"]))
    ptxas = [" ".join(line.split()) for line in log.splitlines()
             if "mb_" in line or "melange" in line or "Used" in line
             or "stack frame" in line]
    print(json.dumps({"card": card, "steps": args.steps, "rows": rows,
                      "ptxas": ptxas}))
    return rows


if __name__ == "__main__":
    main()
