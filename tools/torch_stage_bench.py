#!/usr/bin/env python3
"""Per-stage per-sample cost of the PyTorch port's f64 path on the card.

The counterpart of `tools/stage_bench.py`: the same four stages on the
same inputs, a batch of `--batch` streams over `--samples` samples each,
printed in the same lines:

    python tools/torch_stage_bench.py --batch 32 --samples 2000

  * voices: `voice.step` on `voice.note_on_params(linspace(40, 90, b),
    0.8, 44100)` through kernel E4 (`kernels/render.py` voice_render);
  * preamp twin: the twin DK preamp's step at 88.2 kHz at R_ldr = 50 kΩ,
    main − shadow, on a 0.05 V, 1 kHz sine, through E7 (`dk_scan`, tap
    "diff");
  * tremolo: `tremolo.step` at 88.2 kHz, depth 0.5, from the settled
    oscillator, through E8 (`kernels/engine.py` tremolo_scan);
  * power amp: `power_amp.step` at 88.2 kHz with rail sag on, on the
    sine, through E9 (`power_amp_scan`).

Each stage is one kernel call over the whole buffer from the stage's
initial state, timed with the device synchronised before and after, best
of `--reps` calls after one untimed call (the kernels' build, when the
process has not built them yet, and the first launch). `--device cpu`
runs the kernels' plain versions. A stage that fails raises: the tool
exits non-zero.

`--newton N` adds, after the four lines, the Newton work of the tremolo's
and the power amp's plain versions over the first N samples of one
stream (their streams are alike): Newton calls per step and
eliminations per call (`circuits/mna.NEWTON_COUNTS`).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from openwurli_tpu_torch import voice  # noqa: E402
from openwurli_tpu_torch.circuits import mna  # noqa: E402
from openwurli_tpu_torch.kernels import engine as ek  # noqa: E402
from openwurli_tpu_torch.kernels import render as kr  # noqa: E402

STAGE_SR = 88_200.0
VOICE_SR = 44_100.0
R_LDR = 50_000.0
DEPTH = 0.5


def sine(n, device):
    """The bench's input: a 0.05 V, 1 kHz sine at STAGE_SR, (n,)."""
    t = torch.arange(n, dtype=torch.float64, device=device)
    return 0.05 * torch.sin(2 * np.pi * 1000 * t / STAGE_SR)


def stages(b, n, device):
    """{name: (call, initial state tensors)}, in the reference's order:
    each call takes fresh copies of its state tensors."""
    notes = np.linspace(40.0, 90.0, b)
    vels = np.full((b,), 0.8)
    vp, det = voice.note_on_params(notes, vels, VOICE_SR)
    vs = voice.init_state(vp, det, vels, VOICE_SR,
                          voice.default_note_seed(notes))
    xs = sine(n, device)[:, None].repeat(1, b).contiguous()
    r_ldr = torch.full((n, b), R_LDR, dtype=torch.float64, device=device)
    depth = torch.full((b,), DEPTH, dtype=torch.float64, device=device)
    return {
        "voices": (lambda *s: kr.voice_render(*s, n),
                   kr.voice_columns(vp, vs, device)),
        "preamp twin": (lambda s: kr.dk_scan(STAGE_SR, xs, r_ldr, s, "diff"),
                        (kr.init_dk_scan_state(STAGE_SR, b, device),)),
        "tremolo": (lambda s: ek.tremolo_scan(STAGE_SR, s, depth, n),
                    (ek.init_tremolo_scan_state(STAGE_SR, b, device),)),
        "power amp": (lambda s: ek.power_amp_scan(STAGE_SR, xs, s),
                      (ek.init_power_amp_scan_state(STAGE_SR, b, device),)),
    }


def time_stage(call, state, reps, device):
    """→ (best seconds of `reps` calls, the last call's output)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = call(*[s.clone() for s in state])
    best = float("inf")
    for _ in range(reps):
        fresh = [s.clone() for s in state]
        sync()
        t0 = time.perf_counter()
        out = call(*fresh)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, out


def newton_work(n, device):
    """{stage: (Newton calls per step, eliminations per call)} of the
    plain tremolo and power-amp scans over n samples of one stream."""
    x = sine(n, device)[:, None].contiguous()
    runs = {
        "tremolo": (ek.M_T, lambda: ek.tremolo_scan_plain(
            STAGE_SR, ek.init_tremolo_scan_state(STAGE_SR, 1, device),
            torch.full((1,), DEPTH, dtype=torch.float64, device=device), n)),
        "power amp": (ek.M_PA, lambda: ek.power_amp_scan_plain(
            STAGE_SR, x, ek.init_power_amp_scan_state(STAGE_SR, 1, device))),
    }
    work = {}
    for name, (m, run) in runs.items():
        c0 = dict(mna.NEWTON_COUNTS)
        run()
        solves = mna.NEWTON_COUNTS[m, "solves"] - c0.get((m, "solves"), 0)
        iters = (mna.NEWTON_COUNTS[m, "iterations"]
                 - c0.get((m, "iterations"), 0))
        work[name] = (solves / n, iters / max(solves, 1))
    return work


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--samples", type=int, default=2000)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--newton", type=int, default=0, metavar="N")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    b, n = args.batch, args.samples

    print(f"batch={b} samples={n} (us per sample, best of {args.reps})")
    for name, (call, state) in stages(b, n, device).items():
        best, out = time_stage(call, state, args.reps, device)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"stage {name}: non-finite output")
        print(f"  {name:12s} {best / n * 1e6:9.1f} us/sample", flush=True)
    if args.newton:
        for name, (calls, elims) in newton_work(args.newton, device).items():
            print(f"  {name:12s} Newton over {args.newton} samples: "
                  f"{calls:.2f} calls per step, {elims:.2f} eliminations "
                  "per call")


if __name__ == "__main__":
    main()
