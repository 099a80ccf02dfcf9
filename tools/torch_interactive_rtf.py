#!/usr/bin/env python3
"""Sustained realtime factor of the PyTorch port's interactive path on an
NVIDIA GPU: the counterpart of tools/interactive_rtf.py.

Simulates a live session on FastEngine: precompile, then render a stream
in audio-callback-sized chunks with notes arriving continuously, and
report the sustained throughput and the per-chunk wall times.

    python tools/torch_interactive_rtf.py --seconds 10 --lookahead 1
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--sr", type=float, default=44100.0)
    p.add_argument("--chunk", type=int, default=1024,
                   help="render() request size (audio-callback block)")
    p.add_argument("--lookahead", type=int, default=1)
    p.add_argument("--notes-per-s", type=float, default=3.0)
    p.add_argument("--noise", action="store_true",
                   help="compile thermal noise in (kernel K5)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np

    from chip_smoke import card_line, run_session, session_stats
    from openwurli_tpu_torch.fast_engine import FastEngine

    if args.device.startswith("cuda"):
        print(f"device: {card_line()}", flush=True)
    eng = FastEngine(args.sr, lookahead=args.lookahead, noise=args.noise,
                     device=args.device)
    t0 = time.perf_counter()
    eng.precompile()
    print(f"# precompile {time.perf_counter() - t0:.1f}s", flush=True)

    rng = np.random.default_rng(0)
    chunk = args.chunk
    n_chunks = -(-int(args.seconds * args.sr) // chunk)
    note_period = int(args.sr / args.notes_per_s)
    script, ring, next_note = {}, [], 0
    for k in range(n_chunks):
        if k * chunk >= next_note:
            note = int(rng.integers(40, 90))
            vel = float(rng.uniform(0.4, 1.0))
            off = int(rng.integers(0, chunk))
            calls = [lambda e, n=note, v=vel, o=off: e.note_on(n, v,
                                                               offset=o)]
            ring.append(note)
            if len(ring) > 8:
                calls.append(lambda e, n=ring.pop(0): e.note_off(n))
            script[k] = calls
            next_note += note_period
    audio, walls = run_session(eng, script, n_chunks, chunk)
    if not np.isfinite(audio).all():
        raise SystemExit("torch_interactive_rtf: the output is not finite")
    s = session_stats(walls, chunk, args.sr)
    print(f"rendered {s['seconds']:.1f}s in {s['wall_s']:.1f}s: sustained "
          f"{s['rtf']:.3f}x realtime (chunk {s['chunk_ms']:.1f} ms; "
          f"p50 {s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms, "
          f"max {s['max_ms']:.0f} ms; {s['over_budget'] * 100:.1f}% of "
          f"chunks over budget; peak {np.abs(audio).max():.3f})", flush=True)
    return s


if __name__ == "__main__":
    main()
