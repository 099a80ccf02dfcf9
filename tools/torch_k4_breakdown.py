#!/usr/bin/env python3
"""Where one tremolo pre-roll (K4) update's time goes on an NVIDIA GPU.

Builds tools/k4_breakdown.cu (timing variants of K4's update, beside the
kernel itself from openwurli_tpu_torch/csrc/mono_chain.cu) with the port's
nvcc flags into build/k4_breakdown/, checks that every exact variant
equals the kernel bit for bit (from init_state and from a state whose
first updates take pnjlim's limited branch), then times each variant over
2 captures × `--steps` updates with CUDA events and prints µs per update.
Two families: the update as one thread walks it (K4's earlier design; every
lane of K2 still runs it so) and K4's warp update, each also with one piece
switched off (those compute something else and are timed only). Run on a
machine with a card:

    python tools/torch_k4_breakdown.py [--steps 6656] [--reps 3]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

# (name, exact), in kVariants order
VARIANTS = [
    ("one thread: the one-thread K4", True),
    ("one thread: no LDR tail", False),
    ("one thread: no tail, no history matvec", False),
    ("one thread: no tail, 2 Newton iterations", False),
    ("one thread: no tail, 1 Newton iteration", False),
    ("one thread: no tail, 0 Newton iterations", False),
    ("one thread: no tail, no 4x4 elimination", False),
    ("one thread: no tail, no pnjlim", False),
    ("one thread: no tail, no gp_derivs", False),
    ("one thread: no tail, no final gp_currents", False),
    ("one thread: no tail, no envelope", False),
    ("warp: K4", True),
    ("warp: pnjlim as a select", True),
    ("warp: pnjlim as a select, Newton loop rolled", True),
    ("warp: pnjlim as a select, 4x5 system through shared memory", True),
    ("warp: limexp on 8 lanes", True),
    ("warp: 4x5 system through shared memory", True),
    ("warp: no 4x4 elimination", False),
    ("warp: no gp_derivs", False),
    ("warp: no pnjlim", False),
    ("warp: 1 Newton iteration", False),
    ("warp: 0 Newton iterations", False),
]


def build():
    from openwurli_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "k4_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libk4b.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
           os.path.join(REPO, "tools", "k4_breakdown.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.k4b_launch.argtypes = [i, p, p, p, p, p, i, i, p]
    dll.k4b_launch.restype = i
    dll.k4b_count.restype = i
    if dll.k4b_count() != len(VARIANTS):
        raise RuntimeError("VARIANTS and kVariants differ in length")
    return dll


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6656,
                    help="updates per interval (the song path's: 6656)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from openwurli_tpu_torch.kernels import mono_chain as mc

    if not torch.cuda.is_available():
        raise SystemExit("torch_k4_breakdown: no CUDA device")
    sr, dev = 44100.0, "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dll = build()
    flat, scal = mc._kernel_inputs(sr, dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(w, ctrl, st, n_cap, steps):
        caps = torch.empty((n_cap, mc.PREROLL_ROWS), device=dev)
        err = dll.k4b_launch(w, flat.data_ptr(), scal.data_ptr(),
                             ctrl.data_ptr(), st.data_ptr(), caps.data_ptr(),
                             n_cap, steps, stream)
        if err:
            raise RuntimeError(f"variant {w}: cudaError {err}")
        return caps

    ctrl = mc.make_controls(sr, 1, volume=0.5, depth=0.5, device=dev)
    kicked = mc.init_state(sr, 1, device=dev)
    kicked[slice(*mc._OFFSETS["trem_vnl"])] = 0.0
    for st in (mc.init_state(sr, 1, device=dev), kicked):
        for n_cap, steps in ((5, 32), (3, args.steps)):
            _, ref = mc.trem_preroll(sr, ctrl, n_cap, 2 * steps,
                                     state_flat=st)
            for w, (name, exact) in enumerate(VARIANTS):
                got = run(w, ctrl, st, n_cap, steps)
                if exact and not torch.equal(got.view(torch.int32),
                                             ref.view(torch.int32)):
                    raise RuntimeError(f"{name} differs from K4")

    st = mc.init_state(sr, 1, device=dev)

    def us_per_update(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps * 1e3 / args.steps

    rows = [{"variant": "K4 through mc.trem_preroll", "exact": True,
             "us_per_update": us_per_update(lambda: mc.trem_preroll(
                 sr, ctrl, 2, 2 * args.steps, state_flat=st))}]
    for w, (name, exact) in enumerate(VARIANTS):
        rows.append({"variant": name, "exact": exact,
                     "us_per_update": us_per_update(
                         lambda: run(w, ctrl, st, 2, args.steps))})
    print(f"{card}; 2 captures x {args.steps} updates, {args.reps} reps; "
          "exact variants bit-identical to K4")
    for r in rows:
        print(f"{r['us_per_update']:8.3f} us  {r['variant']}"
              + ("" if r["exact"] else "  (timing only)"))
    print(json.dumps({"card": card, "steps": args.steps, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
