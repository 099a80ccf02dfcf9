#!/usr/bin/env python3
"""Where a voice-bank (K1/K3) group's time goes on an NVIDIA GPU.

Builds tools/vb_breakdown.cu (timing variants of the voice-bank kernel,
beside the kernel itself from openwurli_tpu_torch/csrc/voice_bank.cu) with
the port's nvcc flags into build/vb_breakdown/, checks that every exact
variant equals the kernel bit for bit (output and state), then times each
variant with CUDA events at the three main-path shapes and prints µs per
8-sample group:

  * K1 at the headline grid: 8192 lanes × 44032 (`render_grid`, 128
    streams × 64 voices);
  * K3 on the song's voice window: 128 lanes × the longest voice
    (`render_events_parallel` on the 36 s pseudo-song);
  * K3 for one engine block: 128 lanes × 1024 from sample 4096, the legacy
    stage throughout (`FastEngine`, min_release 0, no steady gating).

Variants: the earlier one-thread-per-lane kernel; the kernel at 128 (its
own), 64 and 32 threads per block; exact alternatives (the charge
handed thread to thread by shuffles; whole-row output stores through a
block barrier per group); and, timed only, no pickup, no refresh, no
legacy stage, no onset ramp or attack noise, one output sample in eight
stored, and the stage terms alone (with each store pattern). Run on a machine with a card:

    python tools/torch_vb_breakdown.py [--reps 3]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

# (name, exact), in kVariants order
VARIANTS = [
    ("one thread per lane (the earlier kernel)", True),
    ("8 threads per lane, 128 per block (the kernel)", True),
    ("8 threads per lane, 64 per block", True),
    ("8 threads per lane, 32 per block", True),
    ("charge handed thread to thread by shuffles", True),
    ("whole-row stores through a block barrier per group", True),
    ("no pickup", False),
    ("no refresh", False),
    ("no legacy stage", False),
    ("no onset ramp, no attack noise", False),
    ("one output sample in eight stored", False),
    ("stage terms, state advance and stores only", False),
    ("stage terms, state advance, one sample in eight stored", False),
    ("stage terms, state advance, whole-row stores", False),
]


def build():
    from openwurli_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "vb_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libvbb.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
           os.path.join(REPO, "tools", "vb_breakdown.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.vbb_launch.argtypes = [i, i, p, p, p, p, i, i, i, i, f, f, f, p]
    dll.vbb_launch.restype = i
    dll.vbb_count.restype = i
    if dll.vbb_count() != len(VARIANTS):
        raise RuntimeError("VARIANTS and kVariants differ in length")
    return dll


def shapes(dev):
    """The three main-path calls: (label, params, samples, n0, steady,
    events, min_release) with the paths' own inputs."""
    import chip_smoke as cs
    from openwurli_tpu_torch import fast
    from openwurli_tpu_torch.kernels import mono_chain as mc
    from openwurli_tpu_torch.kernels import voice_bank as vb

    sr = cs.SR
    midis = np.tile(np.arange(36, 100, dtype=np.float64), (128, 1))
    vel = (0.95 + 0.0005 * np.arange(128))[:, None] * np.ones((1, 64))
    grid, _ = vb.make_kernel_params(midis.reshape(-1), vel.reshape(-1), sr,
                                    lanes=8192, device=dev)
    s_midis, s_vels, s_on, s_rel = cs.song_schedule(36.0)
    on16 = np.round(s_on / 16.0) * 16.0
    t_song = int(round(36.0 * sr))
    lens = fast._voice_lifetimes(s_midis, on16, s_rel, sr, t_song)
    song, _ = vb.make_kernel_params(s_midis, s_vels, sr,
                                    onsets=np.zeros(len(s_midis)),
                                    releases=s_rel - on16, device=dev)
    t_voice = -(-int(lens.max()) // mc.T_TILE) * mc.T_TILE
    midis4, vels4, ons4, rels4 = (list(x) for x in zip(*cs.SESSION_SCHEDULE))
    eng, _ = vb.make_kernel_params(midis4, vels4, sr, onsets=ons4,
                                   releases=rels4, lanes=128, device=dev)
    big = 3.0e38
    return [
        ("K1 8192 lanes x 44032", grid, 44032, 0, vb.steady_limits(grid),
         False, vb.NEVER),
        (f"K3 128 lanes x {t_voice} (song window)", song, t_voice, 0,
         vb.steady_limits(song), True, vb._min_release(song)),
        ("K3 128 lanes x 1024 (engine block 4)", eng, 1024, 4096, (big, big),
         True, 0.0),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from openwurli_tpu_torch.kernels import voice_bank as vb

    if not torch.cuda.is_available():
        raise SystemExit("torch_vb_breakdown: no CUDA device")
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dll = build()
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for label, params, n, n0, steady, events, min_rel in shapes(dev):
        lanes = params.shape[-1]
        t_tile = vb.render_tile(lanes, n, True)
        state = vb.init_bank_state(params)
        out = torch.empty((n, lanes), device=dev)
        st_out = torch.empty_like(state)

        def run(w):
            err = dll.vbb_launch(w, int(events), params.data_ptr(),
                                 state.data_ptr(), out.data_ptr(),
                                 st_out.data_ptr(), lanes, n, t_tile, n0,
                                 float(steady[0]), float(steady[1]),
                                 float(min_rel), stream)
            if err:
                raise RuntimeError(f"variant {w}: cudaError {err}")

        ref, ref_st = vb.render_voice_bank(
            params, n, steady=None if steady[0] > 1e38 else steady,
            state=state, n0=n0, return_state=True, events=events,
            min_release=min_rel)
        for w, (name, exact) in enumerate(VARIANTS):
            run(w)
            if exact and not (
                    torch.equal(out.view(torch.int32), ref.view(torch.int32))
                    and torch.equal(st_out.view(torch.int32),
                                    ref_st.view(torch.int32))):
                raise RuntimeError(f"{label}: {name} differs from the kernel")

        def us_per_group(w):
            run(w)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                run(w)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / args.reps * 1e3 / (n // 8)

        rows = [{"variant": name, "exact": exact,
                 "us_per_group": us_per_group(w)}
                for w, (name, exact) in enumerate(VARIANTS)]
        results.append({"shape": label, "groups": n // 8, "rows": rows})
        print(f"{label}: {n // 8} groups; {card}; {args.reps} reps; exact "
              "variants bit-identical to the kernel", flush=True)
        for r in rows:
            print(f"  {r['us_per_group']:9.4f} us/group "
                  f"({r['us_per_group'] * (n // 8) / 1e3:8.3f} ms)  "
                  f"{r['variant']}" + ("" if r["exact"] else "  (timing only)"),
                  flush=True)
    print(json.dumps({"card": card, "results": results}))
    return results


if __name__ == "__main__":
    main()
