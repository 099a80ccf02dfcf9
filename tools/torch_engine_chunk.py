#!/usr/bin/env python3
"""One f64 engine's chunk on the port: E1 and E2 at B = 1, the batch that
`Engine.render` launches, beside their plain versions on the same inputs.

Builds `Engine(sr)` (the DK preamp, or with --preamp-model melange the
melange one; --noise turns its thermal noise on, as a plugin with
authentic noise does; --pa-model behavioral takes the behavioral power
amp in place of the circuit one) at volume 1 and tremolo depth 1,
renders --history samples, strikes the chord (MIDI 48, 55, 60, 63, 67,
70 at 0.95) and renders --chord-s seconds (at the defaults
`chip_smoke.py` phase 22's loud 1 s render), keeping the inputs of its
first 256-sample chunk. Then it times E1 and E2 on that chunk (CUDA
events, the mean of --reps calls after one), runs the plain versions
once on the same inputs and checks each kernel against its plain version
bit for bit, output and state. A fresh engine's --warm-up-s seconds of
silence are timed too. Host times are synchronised.

    python tools/torch_engine_chunk.py [--root CHECKOUT] [--device cpu]
        [--preamp-model melange] [--noise] [--pa-model behavioral]

--root imports the package from another checkout (one that has the same
`Engine` and `kernels.engine` entry points), so that two trees can be
compared on one card in one session: run A, B, B, A. Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CHORD = (48, 55, 60, 63, 67, 70)
VELOCITY = 0.95
CHUNK = 256


def _bits(x):
    import torch
    return x.contiguous().view(torch.int64 if x.element_size() == 8
                               else torch.int32)


def _same(a, b):
    import torch
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sr", type=float, default=44100.0)
    p.add_argument("--history", type=int, default=1536)
    p.add_argument("--chord-s", type=float, default=1.0)
    p.add_argument("--warm-up-s", type=float, default=0.6)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--preamp-model", default="dk", choices=("dk", "melange"))
    p.add_argument("--noise", action="store_true")
    p.add_argument("--pa-model", default="circuit",
                   choices=("circuit", "behavioral"))
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    from openwurli_tpu_torch.engine import Engine
    from openwurli_tpu_torch.kernels import engine as ek
    if not os.path.abspath(ek.__file__).startswith(root + os.sep):
        raise SystemExit(f"the package was imported from {ek.__file__}, "
                         f"not from --root {root}")

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def host_ms(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, out

    def kernel_ms(fn):
        fn()
        if not cuda:
            return host_ms(lambda: [fn() for _ in range(args.reps)])[0] \
                / args.reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        sync()
        return start.elapsed_time(end) / args.reps

    def clones(xs):
        return tuple(x.clone() if torch.is_tensor(x) else x for x in xs)

    # the first call of each wrapper on a CHUNK-sample chunk, its inputs
    # kept before the call updates the state in place
    seen = {}
    real_v, real_c = ek.render_voices, ek.render_chain

    def voices(*a):
        if a[4] == CHUNK and "voices" not in seen:
            seen["voices"] = clones(a)
        return real_v(*a)

    def chain(*a):
        if a[1].shape[-1] == CHUNK and "chain" not in seen:
            seen["chain"] = clones(a)
        return real_c(*a)

    def engine():
        e = Engine(args.sr, device=dev, preamp_model=args.preamp_model,
                   pa_model=args.pa_model)
        e.set_noise_enabled(args.noise)
        return e

    fresh = engine()
    n_warm = int(args.sr * args.warm_up_s)
    warm_ms, _ = host_ms(lambda: fresh.render(n_warm))
    eng = engine()
    eng.set_volume(1.0)
    eng.set_tremolo_depth(1.0)
    eng.render(args.history)
    for note in CHORD:
        eng.note_on(note, VELOCITY)
    ek.render_voices, ek.render_chain = voices, chain
    try:
        chord_ms, _ = host_ms(lambda: eng.render(int(args.sr
                                                     * args.chord_s)))
    finally:
        ek.render_voices, ek.render_chain = real_v, real_c
    if "chain" not in seen:
        raise SystemExit(f"--chord-s {args.chord_s} renders no {CHUNK}-"
                         "sample chunk")

    vin = seen["voices"]
    e1_ms = kernel_ms(lambda: ek.render_voices(*clones(vin)))
    k_in, p_in = clones(vin), clones(vin)
    k_mono = ek.render_voices(*k_in)
    e1_plain_ms, p_mono = host_ms(lambda: ek.voices_plain(*p_in))
    e1_same = _same(k_mono, p_mono) and all(
        _same(a, b) for a, b in zip(k_in[1:4], p_in[1:4]))

    cin = seen["chain"]
    e2_ms = kernel_ms(lambda: ek.render_chain(*clones(cin)))
    k_in, p_in = clones(cin), clones(cin)
    k_out = ek.render_chain(*k_in)
    e2_plain_ms, p_out = host_ms(lambda: ek.chain_plain(*p_in))
    e2_same = _same(k_out, p_out) and _same(k_in[2], p_in[2])

    card = "cpu"
    if cuda:
        import subprocess
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True).stdout.strip()
        card = smi or torch.cuda.get_device_name(dev)
    print(json.dumps({
        "root": root, "device": card, "sr": args.sr,
        "preamp_model": args.preamp_model, "pa_model": args.pa_model,
        "noise": args.noise,
        "warm_up_ms": warm_ms, "warm_up_samples": n_warm,
        "chord_ms": chord_ms, "chord_samples": int(args.sr * args.chord_s),
        "chunk": CHUNK, "e1_ms": e1_ms, "e1_plain_ms": e1_plain_ms,
        "e1_bit_identical": e1_same, "e2_ms": e2_ms,
        "e2_us_per_base_sample": e2_ms * 1e3 / CHUNK,
        "e2_plain_ms": e2_plain_ms, "e2_bit_identical": e2_same}),
        flush=True)
    return 0 if e1_same and e2_same else 1


if __name__ == "__main__":
    sys.exit(main())
