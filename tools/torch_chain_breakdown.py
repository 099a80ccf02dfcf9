#!/usr/bin/env python3
"""Where E2's time goes, on an NVIDIA GPU: where its behavioral warp form
runs `behavioral()`, and the half form's stamped parts.

Builds tools/chain_breakdown.cu (which includes
openwurli_tpu_torch/csrc/engine.cu) three times with the port's nvcc
flags into build/chain_breakdown/: `OW_BEHAVIORAL_ALL_LANES` 1 (the
library's setting: `behavioral()` on every lane of the engine's warp with
the same input) and 0 (on lane 0 alone), and `OW_HALF_STAMPS` 1 (the half
form with each thread's clock64 cycles summed by part).

  * The behavioral warp form: `ow_engine_chain` of both builds on the
    chord's first 256-sample chunk of `Engine(44100, preamp_model=P,
    pa_model="behavioral")` at B = 1 (the chord MIDI 48, 55, 60, 63, 67,
    70 at 0.95 after --history samples at volume 1 and tremolo depth 1,
    the inputs `Engine.render` gives E2), for both preamps: the two warp
    forms and the thread form are first checked bit for bit (output and
    state) against each other and against the library's
    `kernels.engine.render_chain`, then timed with CUDA events in turns
    (all lanes, lane 0, lane 0, all lanes; the mean of --reps calls
    each). It also times one `behavioral()` call's latency (a dependent
    chain of --calls calls on one thread, `cb_behavioral`).
  * The half form (a half-warp per engine), every instantiation, on the
    same kind of chunk broadcast to --half-engines engines: the half,
    warp and thread forms and the stamped half form are first checked bit
    for bit against the library's render_chain, then timed (thread,
    half, half, thread; the warp form and the stamped half form once),
    and the stamped run's cycles split into its parts: Newton (the
    tremolo's and the power amp's mna Newton loops), the votes (the
    segment ballots and the loops' warp votes, with their waits), lane
    0's share (the smoothers, the allpass branches, the speaker and guard
    #2's test, on lane 0 of each segment) and the rest; each part's share
    of lane 0's cycles and of the other lanes'.
  * The behavioral thread form (a thread per engine), both preamps, on
    the same kind of chunk broadcast to --thread-engines engines: the
    library's (each step's values in registers, the engine's rows in
    shared memory), the form before it (`cb_thread_old`: `chain_sample`
    over the engine's rows in a local array) and the old form stamped by
    part are first checked bit for bit against the library's
    render_chain, then timed old, new, new, old (ms per chunk), and the
    stamped run's cycles split into the tremolo, the preamp's twins,
    `behavioral()` and the rest (each part's share of a thread's cycles,
    the mean over the engines).

--sections picks the parts to run (behavioral, half, thread). Prints the
card and its power limit, then one JSON line:

    python tools/torch_chain_breakdown.py [--reps 5] [--history 1536]
        [--calls 4096] [--half-engines 1,8192]
        [--thread-engines 1,8192,16384,32768]
        [--sections behavioral,half,thread]
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
SETTINGS = {"all lanes": "-DOW_BEHAVIORAL_ALL_LANES=1",
            "lane 0": "-DOW_BEHAVIORAL_ALL_LANES=0",
            "half stamped": "-DOW_HALF_STAMPS=1"}
# engine.cu's HalfPart, in order
HALF_PARTS = ("newton", "votes", "lane 0", "rest")
# chain_breakdown.cu's ThreadPart, in order
THREAD_PARTS = ("tremolo", "preamp twins", "behavioral", "rest")
MODELS = (("dk", "circuit"), ("melange", "circuit"), ("dk", "behavioral"),
          ("melange", "behavioral"))


def build(name):
    from openwurli_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "chain_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libchain-{name.replace(' ', '-')}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", SETTINGS[name],
           "-o", lib, os.path.join(REPO, "tools", "chain_breakdown.cu")]
    return cmd, lib


def chunk_inputs(ek, Engine, pre, pa, history, dev):
    """The chord's first CHUNK-sample E2 call of Engine(44100, pre, pa)
    after `history` samples at volume 1 and tremolo depth 1: (cp, mono (1,
    CHUNK), chain (1, CHAIN_ROWS), sag (1,), scale (1,))."""
    import torch

    eng = Engine(44100.0, device=dev, preamp_model=pre, pa_model=pa)
    eng.set_volume(1.0)
    eng.set_tremolo_depth(1.0)
    eng.render(history)
    for note in CHORD:
        eng.note_on(note, 0.95)
    seen = []
    real = ek.render_chain

    def keep(cp, mono, chain, sag, scale=0.0):
        if mono.shape[-1] >= CHUNK and not seen:
            seen.append((cp, mono[..., :CHUNK].clone(), chain.clone(), sag,
                         scale))
        return real(cp, mono, chain, sag, scale)

    ek.render_chain = keep
    try:
        eng.render(CHUNK)
    finally:
        ek.render_chain = real
    cp, mono, chain, sag, scale = seen[0]
    return (cp, mono.reshape(1, CHUNK).contiguous(),
            chain.reshape(1, -1).contiguous(),
            torch.tensor([bool(sag)], device=dev),
            torch.tensor([float(scale)], dtype=torch.float64, device=dev))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--history", type=int, default=1536)
    ap.add_argument("--calls", type=int, default=4096)
    ap.add_argument("--half-engines", default="1,8192")
    ap.add_argument("--thread-engines", default="1,8192,16384,32768")
    ap.add_argument("--sections", default="behavioral,half,thread")
    args = ap.parse_args(argv)
    sections = args.sections.split(",")

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
    need = {"all lanes", *(["lane 0"] if "behavioral" in sections else []),
            *(["half stamped"] if "half" in sections else [])}
    builds = {name: build(name) for name in SETTINGS if name in need}
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
        dll.cb_half_parts.argtypes = [p, p]
        dll.cb_thread_old.argtypes = [i, i, p, i, p, p, p, i, i, p, p, p,
                                      p]
        if dll.cb_thread_part_count() != len(THREAD_PARTS):
            raise RuntimeError("the tool's THREAD_PARTS and "
                               "chain_breakdown.cu differ")
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
    for pre in ("dk", "melange") if "behavioral" in sections else ():
        cp, mono, chain, sag_t, scale_t = chunk_inputs(
            ek, Engine, pre, "behavioral", args.history, dev)
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
        got = {name: run(name, 1) for name in ("all lanes", "lane 0")}
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

    call_us = (ms_of(calls) * 1e3 / args.calls if "behavioral" in sections
               else None)
    half = (half_rows(args, ek, Engine, libs, dev, stream, same, ms_of)
            if "half" in sections else {})
    thread = (thread_rows(args, ek, Engine, libs["all lanes"], dev, stream,
                          same, ms_of) if "thread" in sections else {})
    for key, row in thread.items():
        print(f"<{key}> engines: old / new / new / old "
              + " / ".join(f"{t:.3f}" for t in row["ms"])
              + " ms per chunk; the old form's cycles: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in row["old_share"].items()),
              flush=True)
    print(json.dumps({"card": card, "chunk": CHUNK, "reps": args.reps,
                      "bit_identical": True, "behavioral": rows,
                      "behavioral_call_us": call_us, "half": half,
                      "thread": thread}),
          flush=True)
    return 0


def thread_rows(args, ek, Engine, dll, dev, stream, same, ms_of):
    """The behavioral thread form, new and old, and the old one's stamped
    parts, at --thread-engines engines of the chord broadcast."""
    import torch

    out = {}
    for pre in ("dk", "melange"):
        cp, mono1, chain1, sag1, scale1 = chunk_inputs(
            ek, Engine, pre, "behavioral", args.history, dev)
        flat = ek._flat_on(ek._cp_key(cp), dev)
        pre_i = ek.PREAMP_MODELS.index(pre)
        for b in [int(x) for x in args.thread_engines.split(",")]:
            mono = mono1.expand(b, CHUNK).contiguous()
            chain = chain1.expand(b, -1).contiguous()
            sag = sag1.expand(b).contiguous()
            scale = scale1.expand(b).contiguous()
            parts = torch.zeros((b, len(THREAD_PARTS)), dtype=torch.int64,
                                device=dev)

            def run(kind):
                st = chain.clone()
                o = torch.empty((b, CHUNK), dtype=torch.float32, device=dev)
                if kind == "new":
                    err = dll.ow_engine_chain(
                        flat.data_ptr(), flat.numel(), mono.data_ptr(),
                        st.data_ptr(), o.data_ptr(), CHUNK, b,
                        sag.data_ptr(), pre_i, 1, scale.data_ptr(),
                        ek.CHAIN_FORMS.index("thread"), stream)
                else:
                    err = dll.cb_thread_old(
                        pre_i, int(kind == "stamped"), flat.data_ptr(),
                        flat.numel(), mono.data_ptr(), st.data_ptr(),
                        o.data_ptr(), CHUNK, b, sag.data_ptr(),
                        scale.data_ptr(), parts.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{pre} {kind} at {b}: cudaError "
                                       f"{err}")
                return o, st

            lib_st = chain.clone()
            lib_out = ek.render_chain(cp, mono, lib_st, sag, scale)
            for kind in ("new", "old", "stamped"):
                o, st = run(kind)
                if not (same(o, lib_out) and same(st, lib_st)):
                    raise SystemExit(f"<{pre}, behavioral> thread form "
                                     f"{kind} at {b} engines differs from "
                                     "the library's render_chain")
            times = [ms_of(lambda k=k: run(k))
                     for k in ("old", "new", "new", "old")]
            parts.zero_()
            stamped_ms = ms_of(lambda: run("stamped"))
            cyc = parts.double().cpu()
            share = (cyc / cyc.sum(1, keepdim=True)).mean(0)
            out[f"{pre}, behavioral, {b}"] = {
                "ms": times, "stamped_old_ms": stamped_ms,
                "old_share": dict(zip(THREAD_PARTS, share.tolist())),
                "us_per_base_sample": {
                    "old": (times[0] + times[3]) * 500 / CHUNK,
                    "new": (times[1] + times[2]) * 500 / CHUNK}}
    return out


def half_rows(args, ek, Engine, libs, dev, stream, same, ms_of):
    """The half form against the thread and warp forms, and its stamped
    parts, for every instantiation at --half-engines engines."""
    import torch

    out = {}
    for pre, pa in MODELS:
        cp, mono1, chain1, sag1, scale1 = chunk_inputs(
            ek, Engine, pre, pa, args.history, dev)
        flat = ek._flat_on(ek._cp_key(cp), dev)
        for b in [int(x) for x in args.half_engines.split(",")]:
            mono = mono1.expand(b, CHUNK).contiguous()
            chain = chain1.expand(b, -1).contiguous()
            sag, scale = sag1.expand(b).contiguous(), scale1.expand(b).contiguous()
            threads = (b + 1) // 2 * 32

            def run(name, form, parts=None):
                st = chain.clone()
                o = torch.empty((b, CHUNK), dtype=torch.float32, device=dev)
                if parts is not None:
                    err = libs[name].cb_half_parts(parts.data_ptr(), stream)
                    if err:
                        raise RuntimeError(f"cb_half_parts: cudaError {err}")
                err = libs[name].ow_engine_chain(
                    flat.data_ptr(), flat.numel(), mono.data_ptr(),
                    st.data_ptr(), o.data_ptr(), CHUNK, b, sag.data_ptr(),
                    ek.PREAMP_MODELS.index(pre), ek.PA_MODELS.index(pa),
                    scale.data_ptr(), ek.CHAIN_FORMS.index(form), stream)
                if err:
                    raise RuntimeError(f"{name} {form}: cudaError {err}")
                return o, st

            lib_st = chain.clone()
            lib_out = ek.render_chain(cp, mono, lib_st, sag, scale)
            parts = torch.zeros((threads, len(HALF_PARTS) + 2),
                                dtype=torch.int64, device=dev)
            got = {form: run("all lanes", form)
                   for form in ("thread", "warp", "half")}
            got["half stamped"] = run("half stamped", "half", parts)
            for name, (o, st) in got.items():
                if not (same(o, lib_out) and same(st, lib_st)):
                    raise SystemExit(f"<{pre}, {pa}> {name} at {b} engines "
                                     "differs from the library's "
                                     "render_chain")
            order = ("thread", "half", "half", "thread")
            times = [ms_of(lambda f=f: run("all lanes", f)) for f in order]
            warp_ms = ms_of(lambda: run("all lanes", "warp"))
            parts.zero_()
            stamped_ms = ms_of(lambda: run("half stamped", "half", parts))
            cyc = parts[:, :len(HALF_PARTS)].double().cpu()
            lane0 = torch.arange(threads) % 16 == 0

            def share(rows):
                tot = rows.sum()
                return dict(zip(HALF_PARTS, (rows.sum(0) / tot).tolist()))

            out[f"{pre}, {pa}, {b}"] = {
                "thread_ms": [times[0], times[3]],
                "half_ms": times[1:3], "warp_ms": warp_ms,
                "stamped_half_ms": stamped_ms,
                "lane0_share": share(cyc[lane0]),
                "other_lanes_share": share(cyc[~lane0]),
                "us_per_base_sample_half": times[1] * 1e3 / CHUNK}
    return out


if __name__ == "__main__":
    sys.exit(main())
