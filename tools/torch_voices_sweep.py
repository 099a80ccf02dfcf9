#!/usr/bin/env python3
"""E1 (the f64 engine's voice slots, `kernels.engine.render_voices`)
across batch widths on an NVIDIA GPU, for two checkouts on one card.

Builds one `Engine(44100)` session's slots (chip_smoke.py phase 21's
bank: ten notes, 2048 samples of history, the bank filled by steals, so
that steal fades are live), copies them to B engines (copy e at its own
sample offset, 37·e samples on, and its steal fades e samples shorter)
and times one --samples chunk of E1 at each width of --engines with CUDA
events (the mean of --reps calls after one; the state copies are made
before the timed calls). `--form lanes` or `--form thread` runs E1 in
that form at every width (the cluster form, eight threads per slot; a
thread per slot), to measure the two against each other; the default
takes the wrapper's choice (`kernels.engine.VOICES_LANES_MAX_ENGINES`).
Prints the card and its power limit, then one JSON line of ms per chunk
and ns per engine-sample:

    python tools/torch_voices_sweep.py [--root CHECKOUT]
        [--engines 1,128,1024,4096,8192] [--samples 256] [--reps 5]
        [--form auto|lanes|thread]

--root imports the package from another checkout (one with the same
`Engine` and `kernels.engine.render_voices`), so that two trees can be
compared on one card in one session: run A, B, B, A.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=HERE)
    p.add_argument("--engines", default="1,128,1024,4096,8192")
    p.add_argument("--samples", type=int, default=256)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--form", choices=("auto", "lanes", "thread"),
                   default="auto")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch
    from openwurli_tpu_torch.engine import Engine
    from openwurli_tpu_torch.kernels import engine as ek
    if not os.path.abspath(ek.__file__).startswith(root + os.sep):
        raise SystemExit(f"the package was imported from {ek.__file__}, "
                         f"not from --root {root}")
    if not torch.cuda.is_available():
        raise SystemExit("torch_voices_sweep: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = "cuda"
    eng = Engine(44100.0, device=dev)
    for k, note in enumerate((41, 48, 55, 60, 64, 67, 72, 79, 84, 93)):
        eng.note_on(note, 0.35 + 0.06 * k)
    eng.render(2048)
    for note in range(33, 97):  # fills the bank; steals with fades
        eng.note_on(note, 0.5)
    n = args.samples
    if args.form != "auto":
        ek.VOICES_LANES_MAX_ENGINES = None if args.form == "lanes" else 0
    rows = {}
    for b in [int(x) for x in args.engines.split(",")]:
        cols = [x.expand(b, *x.shape).clone()
                for x in (eng.vpar, eng.vst, eng.vsti, eng.eng_i)]
        e = torch.arange(b, device=dev)
        cols[2][:, ek.I_N] += 37 * e[:, None]
        cols[3][:, ek.MAX_VOICES:ek.SLOTS] = torch.clamp(
            cols[3][:, ek.MAX_VOICES:ek.SLOTS] - e[:, None], min=0)
        copies = [[c.clone() for c in cols] for _ in range(args.reps + 1)]
        ek.render_voices(*copies[0], n, eng.fade_len, 44100.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for c in copies[1:]:
            ek.render_voices(*c, n, eng.fade_len, 44100.0)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.reps
        rows[b] = {"ms": ms, "ns_per_engine_sample": ms * 1e6 / (b * n)}
    print(json.dumps({"root": root, "card": card, "samples": n,
                      "reps": args.reps, "form": args.form, "e1": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
