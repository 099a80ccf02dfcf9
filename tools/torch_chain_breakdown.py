#!/usr/bin/env python3
"""Where E2's behavioral warp form runs `behavioral()`, on an NVIDIA GPU:
on every lane of the engine's warp with the same input (the library,
`OW_BEHAVIORAL_ALL_LANES` 1) or on lane 0 alone (0).

Builds tools/chain_breakdown.cu (which includes
openwurli_tpu_torch/csrc/engine.cu) twice with the port's nvcc flags into
build/chain_breakdown/, once with each setting, and runs
`ow_engine_chain` of both on the chord's first 256-sample chunk of
`Engine(44100, preamp_model=P, pa_model="behavioral")` at B = 1 (the
chord MIDI 48, 55, 60, 63, 67, 70 at 0.95 after --history samples at
volume 1 and tremolo depth 1, the inputs `Engine.render` gives E2), for
both preamps: the two warp forms and the thread form are first checked
bit for bit (output and state) against each other and against the
library's `kernels.engine.render_chain`, then timed with CUDA events in
turns (all lanes, lane 0, lane 0, all lanes; the mean of --reps calls
each). It also times one `behavioral()` call's latency (a dependent chain
of --calls calls on one thread, `cb_behavioral`). Prints the card and its
power limit, then one JSON line:

    python tools/torch_chain_breakdown.py [--reps 5] [--history 1536]
        [--calls 4096]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

CHORD = (48, 55, 60, 63, 67, 70)
CHUNK = 256
SETTINGS = {"all lanes": 1, "lane 0": 0}


def build(setting):
    from openwurli_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "chain_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libchain{setting}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
           f"-DOW_BEHAVIORAL_ALL_LANES={setting}", "-o", lib,
           os.path.join(REPO, "tools", "chain_breakdown.cu")]
    return cmd, lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--history", type=int, default=1536)
    ap.add_argument("--calls", type=int, default=4096)
    args = ap.parse_args(argv)

    import torch

    from openwurli_tpu_torch.engine import Engine
    from openwurli_tpu_torch.kernels import engine as ek

    if not torch.cuda.is_available():
        raise SystemExit("torch_chain_breakdown: no CUDA device")
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    builds = {name: build(v) for name, v in SETTINGS.items()}
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, (cmd, _) in builds.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) failed:\n{log}")
        dll = ctypes.CDLL(builds[name][1])
        p, i = ctypes.c_void_p, ctypes.c_int
        dll.ow_engine_chain.argtypes = [p, i, p, p, p, i, i, p, i, i, p, i,
                                        p]
        dll.cb_behavioral.argtypes = [p, i, p]
        libs[name] = dll
    stream = torch.cuda.current_stream().cuda_stream

    def bits(a):
        return a.contiguous().view(torch.int64 if a.element_size() == 8
                                   else torch.int32)

    def same(a, b):
        return a.shape == b.shape and torch.equal(bits(a), bits(b))

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

    rows = {}
    for pre in ("dk", "melange"):
        eng = Engine(44100.0, device=dev, preamp_model=pre,
                     pa_model="behavioral")
        eng.set_volume(1.0)
        eng.set_tremolo_depth(1.0)
        eng.render(args.history)
        for note in CHORD:
            eng.note_on(note, 0.95)
        seen = []
        real = ek.render_chain

        def keep(cp, mono, chain, sag, scale=0.0):
            if mono.shape[-1] >= CHUNK and not seen:
                seen.append((cp, mono[..., :CHUNK].clone(), chain.clone(),
                             sag, scale))
            return real(cp, mono, chain, sag, scale)

        ek.render_chain = keep
        try:
            eng.render(CHUNK)
        finally:
            ek.render_chain = real
        cp, mono, chain, sag, scale = seen[0]
        mono = mono.reshape(1, CHUNK).contiguous()
        chain = chain.reshape(1, -1).contiguous()
        sag_t = torch.tensor([bool(sag)], device=dev)
        scale_t = torch.tensor([float(scale)], dtype=torch.float64,
                               device=dev)
        flat = ek._flat_on(ek._cp_key(cp), dev)

        def run(name, warp):
            st = chain.clone()
            out = torch.empty((1, CHUNK), dtype=torch.float32, device=dev)
            err = libs[name].ow_engine_chain(
                flat.data_ptr(), flat.numel(), mono.data_ptr(),
                st.data_ptr(), out.data_ptr(), CHUNK, 1, sag_t.data_ptr(),
                ek.PREAMP_MODELS.index(pre), 1, scale_t.data_ptr(), warp,
                stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")
            return out, st

        lib_st = chain.clone()
        lib_out = ek.render_chain(cp, mono, lib_st, sag_t, scale_t)
        got = {name: run(name, 1) for name in SETTINGS}
        got["thread"] = run("all lanes", 0)
        for name, (out, st) in got.items():
            if not (same(out, lib_out) and same(st, lib_st)):
                raise SystemExit(f"<{pre}, behavioral> {name} differs from "
                                 "the library's render_chain")
        order = ("all lanes", "lane 0", "lane 0", "all lanes")
        times = [ms_of(lambda: run(name, 1)) for name in order]
        thread_ms = ms_of(lambda: run("all lanes", 0))
        rows[pre] = {"all_lanes_ms": [times[0], times[3]],
                     "lane0_ms": times[1:3], "thread_ms": thread_ms,
                     "us_per_base_sample": {
                         "all lanes": (times[0] + times[3]) * 500 / CHUNK,
                         "lane 0": (times[1] + times[2]) * 500 / CHUNK,
                         "thread": thread_ms * 1e3 / CHUNK}}
    x = torch.full((1,), 0.05, dtype=torch.float64, device=dev)

    def calls():
        err = libs["all lanes"].cb_behavioral(x.data_ptr(), args.calls,
                                               stream)
        if err:
            raise RuntimeError(f"cb_behavioral: cudaError {err}")

    call_us = ms_of(calls) * 1e3 / args.calls
    print(json.dumps({"card": card, "chunk": CHUNK, "reps": args.reps,
                      "bit_identical": True, "behavioral": rows,
                      "behavioral_call_us": call_us}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
