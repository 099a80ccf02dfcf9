#!/usr/bin/env python3
"""Throughput sweep of the PyTorch port's f64 engine over batch widths.

Renders B engine states at once (`engine.render_states`: E1 a cluster
of eight blocks per engine up to `kernels.engine.VOICES_LANES_MAX_ENGINES`
engines and a thread per slot above, E2 a warp, a half-warp or a thread
per engine, by width: `kernels.engine.chain_form`) at several widths B
and prints a CSV of aggregate realtime factors, the counterpart of
`tools/perf_sweep.py`:

    python tools/torch_perf_sweep.py --streams 8,32,128 --seconds 0.25

`--form warp`, `--form half` or `--form thread` runs the sweep's E2
calls in that form at every width (a warp, a half-warp or a thread per
engine), to measure the forms against each other; standard error says
which form ran at each width ("plain" on the CPU).
`--preamp-model melange` sweeps the melange engine (default: the DK one),
`--pa-model behavioral` the behavioral power amp (default: the circuit).
The first line names the card and its power limit (nvidia-smi).

Every width starts from one engine holding the six-note chord (MIDI 48,
55, 60, 63, 67, 70 at 0.95) broadcast to B engines; `--traffic distinct`
starts instead from chip_smoke.py phase 28 (a)'s 128 distinct engines
(`chip_smoke.distinct_engines`: eight kinds, each with its own chord,
velocities and history, and rail sag off, a NaN slot, steal fades, a NaN
speaker state, noise, ramping controls or a sustained release; 16 copies
of each a few samples apart) tiled to B engines, so that neighbouring
engines (a warp's two segments in the half form) differ; it runs at
44.1 kHz and builds the 128 once per process and model. Each call
renders one chunk of int(sr · seconds) samples. `compile_s` is the first call (the
kernels' build, when the process has not built them yet, and the first
launch); `wall_s` the `--reps` calls after it. The device is synchronised
before every clock read. `--device cpu` runs the kernels' plain versions.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402

from openwurli_tpu_torch import engine  # noqa: E402
from openwurli_tpu_torch.kernels import engine as ek  # noqa: E402

CHORD = (48, 55, 60, 63, 67, 70)
VELOCITY = 0.95
# --traffic distinct: (preamp, pa) → (an Engine of them, the 128 states)
_DISTINCT = {}


def _card(device):
    """The card's name and power limit, as nvidia-smi gives them."""
    import subprocess
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = ""
    return smi or torch.cuda.get_device_name(device) + ", power limit " \
        "not read"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--streams", default="8,32,128")
    p.add_argument("--seconds", type=float, default=0.25)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--sr", type=float, default=44100.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--form", choices=("auto", "warp", "half", "thread"),
                   default="auto")
    p.add_argument("--preamp-model", choices=("dk", "melange"),
                   default="dk")
    p.add_argument("--pa-model", choices=("circuit", "behavioral"),
                   default="circuit")
    p.add_argument("--traffic", choices=("chord", "distinct"),
                   default="chord")
    args = p.parse_args(argv)

    pa = args.pa_model
    models = (args.preamp_model, pa)
    if args.traffic == "distinct":
        if args.sr != 44100.0:
            raise SystemExit("--traffic distinct runs at 44100 Hz")
        if models not in _DISTINCT:
            import chip_smoke
            kinds, base = chip_smoke.distinct_engines(
                torch.device(args.device), models)
            _DISTINCT[models] = (kinds[0], base)
        eng, base = _DISTINCT[models]
    else:
        eng = engine.Engine(args.sr, device=args.device,
                            preamp_model=args.preamp_model,
                            pa_model=args.pa_model)
        for note in CHORD:
            eng.note_on(note, VELOCITY)
        base = eng.state
    block = int(args.sr * args.seconds)
    dev = eng.device

    bands = [(d, d[models]) for d in (ek.CHAIN_WARP_MAX_ENGINES,
                                      ek.CHAIN_HALF_MAX_ENGINES)]
    if dev.type == "cuda":
        print("# " + _card(dev), flush=True)
    print("streams,compile_s,wall_s,per_stream_rtf,aggregate_rtf")
    for b in [int(x) for x in args.streams.split(",")]:
        if args.form != "auto":
            ek.CHAIN_WARP_MAX_ENGINES[models] = \
                None if args.form == "warp" else 0
            ek.CHAIN_HALF_MAX_ENGINES[models] = \
                None if args.form == "half" else 0
        form = "plain" if dev.type == "cpu" else ek.chain_form(*models, b)
        if args.traffic == "distinct":
            tiles = -(-b // base.batch)
            st = engine.EngineState(*[
                x.repeat(tiles, *([1] * (x.dim() - 1)))[:b].contiguous()
                for x in base])
        else:
            st = engine.broadcast_state(base, b)
        try:
            _sync(dev)
            t0 = time.time()
            st, out = engine.render_states(eng, st, block)
            _sync(dev)
            compile_s = time.time() - t0
            t0 = time.time()
            for _ in range(args.reps):
                st, out = engine.render_states(eng, st, block)
            _sync(dev)
            wall = time.time() - t0
        finally:
            for d, widest in bands:
                d[models] = widest
        rtf = args.reps * b * args.seconds / wall
        print(f"{b},{compile_s:.0f},{wall:.3f},{rtf/b:.1f},{rtf:.1f}",
              flush=True)
        print(f"# {b} engines: E2<{args.preamp_model}, {pa}> {form}",
              file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
