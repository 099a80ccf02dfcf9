#!/usr/bin/env python3
"""Where one mna step's time goes on an NVIDIA GPU when a warp runs it.

Builds tools/mna_breakdown.cu (the one-thread mna step, the warp step
`mna_step_warp` and a copy of it stamped with the SM's cycle counter
between the step's parts) with the port's nvcc flags into
build/mna_breakdown/, at two sizes:

  * the tremolo oscillator, <7, 4, 2, 4> (E3, E2's tremolo): E3's layout,
    one circuit from the settle's perturbed start at 88.2 kHz; every
    variant checked bit for bit against E3 (`kernels.engine.settle`), from
    that start and from one with a NaN node;
  * the power amp, <21, 16, 8, 16> (E6, E2's power amp): E9's layout, the
    stage bench's 0.05 V, 1 kHz sine at 88.2 kHz over each of --pa-streams
    streams (a warp each, four to a block, as E6 and E9); every variant
    checked bit for bit against E9 (`kernels.engine.power_amp_scan`, the
    warp step since its redesign, the one-thread step before), there and
    on 4 streams with a 200 V spike, a NaN and loud rails.

It times each variant with CUDA events (µs per step) and splits the
stamped one's step into its parts: each part's share of the stamped
cycles times the stamped variant's µs per step, with the Newton
evaluations (residual passes), iterations (eliminations) and BE replays
per step. Beside them, E8 (the stage bench's tremolo scan) before its warp
redesign (a thread per circuit) and now, at --e8-circuits × --e8-steps,
both checked bit for bit against the library's, timed thread, warp, warp,
thread. Run on a machine with a card:

    python tools/torch_mna_breakdown.py [--trem-steps 8192]
        [--pa-samples 512] [--pa-streams 1,512] [--reps 3]
        [--e8-circuits 32,512] [--e8-steps 2000] [--sections trem,pa,e8]

With --e8-bound it only computes E8's bound at each --e8-circuits ×
--e8-steps, as chip_smoke.py's phase 29 does (the bytes moved and the f64
operations that the plain version's own Newton counts give, over the
card's rates), running the plain version on the CPU; it needs no card.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

# mna_breakdown.cu's Part, in order: seven parts of each pass (the
# trapezoidal one, then the BE replay), the commit, the power amp's own
# work around the step; then the counts
PASS_PARTS = ("history", "linear", "currents", "derivs", "elim", "limit",
              "fold")
TIMED = ([f"trap {p}" for p in PASS_PARTS] + [f"be {p}" for p in PASS_PARTS]
         + ["commit", "around"])
COUNTS = ("evaluations", "iterations", "be_replays")
TREM_VARIANTS = [("one thread: mna_step (E3 before)", False),
                 ("warp: E3 (tremolo_settle_kernel)", False),
                 ("warp: E3, stamped", True)]
PA_VARIANTS = [("one thread: power_amp_step (E9 before)", False),
               ("warp: power_amp_step_warp, a warp per stream (E6's)", False),
               ("warp: stamped", True)]
SR = 88200.0  # the chain's oversampled rate, the stage bench's


def build():
    from openwurli_tpu_torch import _build

    out_dir = os.path.join(REPO, "build", "mna_breakdown")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libmb.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
           os.path.join(REPO, "tools", "mna_breakdown.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.mb_trem_launch.argtypes = [i, p, i, p, p, i, p]
    dll.mb_pa_launch.argtypes = [i, p, i, p, p, p, p, i, i, p]
    dll.mb_e8_launch.argtypes = [i, p, i, p, p, p, i, i, p]
    for f in (dll.mb_trem_launch, dll.mb_pa_launch, dll.mb_e8_launch,
              dll.mb_parts,
              dll.mb_trem_count, dll.mb_pa_count):
        f.restype = i
    if (dll.mb_parts() != len(TIMED) + len(COUNTS)
            or dll.mb_trem_count() != len(TREM_VARIANTS)
            or dll.mb_pa_count() != len(PA_VARIANTS)):
        raise RuntimeError("the tool's lists and mna_breakdown.cu differ")
    return dll, proc.stdout + proc.stderr


def split(parts, us_per_step, steps):
    """parts (N_PARTS, G) int64 → µs per step of each timed part (mean over
    the columns), and the counts per step."""
    cyc = parts[:len(TIMED)].double().cpu()
    share = cyc / cyc.sum(0)
    us = (share * us_per_step).mean(1)
    counts = parts[len(TIMED):].double().cpu().mean(1) / steps
    return dict(zip(TIMED, us.tolist())), dict(zip(COUNTS, counts.tolist()))


def summary(us, counts):
    """The parts folded: the trapezoidal pass's history and rhs, linear
    solve, Newton (per evaluation and per iteration), fold; the BE
    replay's whole share; the commit; around."""
    newton = sum(us[f"trap {p}"] for p in ("currents", "derivs", "elim",
                                            "limit"))
    ev, it = counts["evaluations"], counts["iterations"]
    return {
        "history": us["trap history"], "linear": us["trap linear"],
        "newton": newton, "fold": us["trap fold"],
        "be_replay": sum(us[f"be {p}"] for p in PASS_PARTS),
        "commit": us["commit"], "around": us["around"],
        "currents_per_evaluation": (us["trap currents"]
                                    + us["be currents"]) / ev if ev else 0.0,
        "iteration": ((sum(us[f"{k} {p}"] for k in ("trap", "be")
                           for p in ("derivs", "elim", "limit")) / it)
                      if it else 0.0),
        "elim_per_iteration": ((us["trap elim"] + us["be elim"]) / it
                               if it else 0.0)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trem-steps", type=int, default=8192)
    ap.add_argument("--pa-samples", type=int, default=512)
    ap.add_argument("--pa-streams", default="1,512")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--e8-circuits", default="32,512")
    ap.add_argument("--e8-steps", type=int, default=2000)
    ap.add_argument("--sections", default="trem,pa,e8",
                    help="which of trem, pa, e8 to run")
    ap.add_argument("--e8-bound", action="store_true",
                    help="only E8's bound, on the CPU")
    args = ap.parse_args(argv)
    sections = args.sections.split(",")
    if args.e8_bound:
        return e8_bound(args)

    import numpy as np
    import torch

    from openwurli_tpu_torch.circuits import tremolo
    from openwurli_tpu_torch.kernels import engine as ek

    if not torch.cuda.is_available():
        raise SystemExit("torch_mna_breakdown: no CUDA device")
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dll, log = build()
    stream = torch.cuda.current_stream().cuda_stream
    n_parts = len(TIMED) + len(COUNTS)

    def bits(a):
        return a.contiguous().view(torch.int64)

    def same(a, b):
        return torch.equal(bits(a), bits(b))

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

    trem_rows, pa_rows, nt, n = [], {}, args.trem_steps, args.pa_samples
    if "trem" in sections:
        # ── the tremolo oscillator: E3's layout ──
        block = ek._trem_block_on(SR, dev)

        def trem(w, st, n):
            parts = torch.zeros(n_parts, dtype=torch.int64, device=dev)
            err = dll.mb_trem_launch(w, block.data_ptr(), block.numel(),
                                     st.data_ptr(), parts.data_ptr(), n, stream)
            if err:
                raise RuntimeError(f"tremolo variant {w}: cudaError {err}")
            return parts

        start = ek.osc_flat(tremolo.perturbed_start(tremolo.make_params(SR),
                                                    dev))
        nan_start = start.clone()
        nan_start[2] = float("nan")
        nt = args.trem_steps
        for st0 in (start, nan_start):
            ref = ek.settle(SR, st0.clone(), nt)
            for w, (name, _) in enumerate(TREM_VARIANTS):
                st = st0.clone()
                trem(w, st, nt)
                if not same(st, ref):
                    raise RuntimeError(f"tremolo {name} differs from E3")
        trem_rows = [{"variant": "E3 through kernels.engine.settle",
                      "us_per_step": ms_of(lambda: ek.settle(
                          SR, start.clone(), nt)) * 1e3 / nt}]
        for w, (name, stamped) in enumerate(TREM_VARIANTS):
            row = {"variant": name, "us_per_step": ms_of(
                lambda: trem(w, start.clone(), nt)) * 1e3 / nt}
            if stamped:
                us, counts = split(trem(w, start.clone(), nt)[:, None],
                                   row["us_per_step"], nt)
                row.update(parts_us_per_step=us, counts_per_step=counts,
                           summary=summary(us, counts))
            trem_rows.append(row)

    if "pa" in sections:
        # ── the power amp: E9's layout ──
        consts = torch.from_numpy(ek.scan_consts(SR, "power_amp")).to(dev)

        def pa(w, x, st):
            out = torch.empty_like(x)
            parts = torch.zeros((n_parts, x.shape[1]), dtype=torch.int64,
                                device=dev)
            err = dll.mb_pa_launch(w, consts.data_ptr(), consts.numel(),
                                   x.data_ptr(), st.data_ptr(), out.data_ptr(),
                                   parts.data_ptr(), x.shape[0], x.shape[1],
                                   stream)
            if err:
                raise RuntimeError(f"power-amp variant {w}: cudaError {err}")
            return out, parts

        def kicked(n=64, g=4):
            rng = np.random.default_rng(15)
            t = np.arange(n)[:, None]
            x = rng.uniform(0.02, 0.4, g) * np.sin(2 * np.pi * 1000 * t / SR)
            x[:, 3] *= 6.0
            x[n // 3, 1] = 200.0
            x[n // 4, 2] = np.nan
            st = ek.init_power_amp_scan_state(SR, g, dev)
            r0 = ek.CHAIN_OFF["pa_rails"][0] - ek.CHAIN_OFF["pa_v"][0]
            st[r0:r0 + 4, 3] = torch.tensor([21.0, 21.8, 0.3, 0.1],
                                            dtype=torch.float64, device=dev)
            return torch.as_tensor(x, device=dev).contiguous(), st

        n = args.pa_samples
        t = torch.arange(n, dtype=torch.float64, device=dev)
        sine = 0.05 * torch.sin(2 * np.pi * 1000 * t / SR)
        widths = [int(g) for g in args.pa_streams.split(",")]
        cases = [kicked()] + [
            (sine[:, None].repeat(1, g).contiguous(),
             ek.init_power_amp_scan_state(SR, g, dev)) for g in widths]
        for x, st0 in cases:
            ref_st = st0.clone()
            ref = ek.power_amp_scan(SR, x, ref_st)
            for w, (name, _) in enumerate(PA_VARIANTS):
                st = st0.clone()
                out, _ = pa(w, x, st)
                if not (same(out, ref) and same(st, ref_st)):
                    raise RuntimeError(f"power amp {name} differs from E9")
        pa_rows = {}
        for g, (x, st0) in zip(widths, cases[1:]):
            rows = []
            for w, (name, stamped) in enumerate(PA_VARIANTS):
                row = {"variant": name, "us_per_step": ms_of(
                    lambda: pa(w, x, st0.clone())) * 1e3 / n}
                if stamped:
                    us, counts = split(pa(w, x, st0.clone())[1],
                                       row["us_per_step"], n)
                    row.update(parts_us_per_step=us, counts_per_step=counts,
                               summary=summary(us, counts))
                rows.append(row)
            pa_rows[g] = rows

    # ── E8: the tremolo scan, before and now ──
    e8_rows = {}
    if "e8" in sections:
        e8_rows = e8_abba(args, dll, ek, dev, stream, same, ms_of)

    def show(rows):
        for row in rows:
            print(f"{row['us_per_step']:10.3f} us  {row['variant']}")
            if "summary" in row:
                s, c = row["summary"], row["counts_per_step"]
                print("            " + ", ".join(
                    f"{k} {v:.3f}" for k, v in s.items()
                    if not k.endswith(("evaluation", "iteration")))
                    + f" us per step; currents {s['currents_per_evaluation']:.3f} "
                    f"us per evaluation, {s['iteration']:.3f} us per "
                    f"iteration (elim {s['elim_per_iteration']:.3f}); "
                    f"per step {c['evaluations']:.2f} evaluations, "
                    f"{c['iterations']:.2f} iterations, "
                    f"{c['be_replays']:.3f} BE replays")

    if trem_rows:
        print(f"{card}; tremolo <7, 4, 2, 4>: 1 circuit x {nt} steps at "
              f"{SR:g} Hz, {args.reps} reps; every variant bit-identical to "
              "E3 there and from a NaN start")
        show(trem_rows)
    for g, rows in pa_rows.items():
        print(f"power amp <21, 16, 8, 16>: {g} streams x {n} samples of the "
              f"stage bench's sine; every variant bit-identical to E9 there "
              "and on 4 kicked streams")
        show(rows)
    for g, row in e8_rows.items():
        print(f"{card}; E8 {g} circuits x {args.e8_steps} steps at {SR:g} "
              "Hz (seeded starts, depths 0 / 0.5 / 1), both bit-identical "
              "to the library's tremolo_scan, thread / warp / warp / thread: "
              + " / ".join(f"{u:.3f}" for u in row["us_per_step"])
              + " us per step")
    ptxas = [" ".join(line.split()) for line in log.splitlines()
             if "mb_" in line or "mna_step" in line or "Used" in line
             or "stack frame" in line]
    print(json.dumps({"card": card, "trem_steps": nt, "trem": trem_rows,
                      "pa_samples": n, "pa": pa_rows,
                      "e8_steps": args.e8_steps, "e8": e8_rows,
                      "ptxas": ptxas}))
    return trem_rows, pa_rows


def e8_abba(args, dll, ek, dev, stream, same, ms_of):
    """E8 before (a thread per circuit) and now (the library's, a warp per
    circuit) at each of --e8-circuits: both checked bit for bit, output
    and state, against `kernels.engine.tremolo_scan` from seeded starts at
    depths 0 / 0.5 / 1, then timed thread, warp, warp, thread; µs per
    step, by width."""
    import numpy as np
    import torch

    consts = torch.from_numpy(ek.scan_consts(SR, "tremolo")).to(dev)
    n = args.e8_steps

    def run(w, st, depth):
        out = torch.empty((n, st.shape[1]), dtype=torch.float64, device=dev)
        err = dll.mb_e8_launch(w, consts.data_ptr(), consts.numel(),
                               st.data_ptr(), depth.data_ptr(),
                               out.data_ptr(), n, st.shape[1], stream)
        if err:
            raise RuntimeError(f"E8 variant {w}: cudaError {err}")
        return out

    rows = {}
    for g in [int(x) for x in args.e8_circuits.split(",")]:
        rng = np.random.default_rng(29)
        st0 = ek.init_tremolo_scan_state(SR, g, dev)
        st0[:ek.N_T] += torch.as_tensor(
            rng.uniform(-0.05, 0.05, (ek.N_T, g)), device=dev)
        depth = torch.tensor([(0.0, 0.5, 1.0)[j % 3] for j in range(g)],
                             dtype=torch.float64, device=dev)
        ref_st = st0.clone()
        ref = ek.tremolo_scan(SR, ref_st, depth, n)
        for w in (0, 1):
            st = st0.clone()
            if not (same(run(w, st, depth), ref) and same(st, ref_st)):
                raise RuntimeError(f"E8 variant {w} at {g} circuits differs "
                                   "from the library's tremolo_scan")
        st = st0.clone()
        rows[g] = {"us_per_step": [
            ms_of(lambda w=w: run(w, st, depth)) * 1e3 / n
            for w in (0, 1, 1, 0)]}
    return rows


def e8_bound(args):
    """E8's bound at each --e8-circuits × --e8-steps from the seeded starts
    of e8_abba, as chip_smoke.py's compare_tremolo_scan counts it: each
    input read once and each output written once over the card's memory
    rate, against the plain version's Newton calls and eliminations and
    each step's vactrol over its f64 rate. → {circuits: (ms, bound by)}."""
    import runpy

    import numpy as np
    import torch

    from openwurli_tpu_torch.circuits import mna
    from openwurli_tpu_torch.kernels import engine as ek

    smoke = runpy.run_path(os.path.join(REPO, "chip_smoke.py"),
                           run_name="chip_smoke")
    n, rows = args.e8_steps, {}
    for g in [int(x) for x in args.e8_circuits.split(",")]:
        rng = np.random.default_rng(29)
        st = ek.init_tremolo_scan_state(SR, g, "cpu")
        st[:ek.N_T] += torch.as_tensor(rng.uniform(-0.05, 0.05, (ek.N_T, g)))
        depth = torch.tensor([(0.0, 0.5, 1.0)[j % 3] for j in range(g)],
                             dtype=torch.float64)
        n_bytes = (2 * st.numel() + depth.numel() + n * g
                   + ek.scan_consts(SR, "tremolo").size) * 8
        n0 = dict(mna.NEWTON_COUNTS)
        ek.tremolo_scan_plain(SR, st, depth, n)
        count = {k: mna.NEWTON_COUNTS[k] - n0.get(k, 0)
                 for k in mna.NEWTON_COUNTS}
        solves = count.get((ek.M_T, "solves"), 0)
        iters = count.get((ek.M_T, "iterations"), 0)
        ops = n * g * smoke["E8_OPS_STEP"] + smoke["mna_ops"](
            ek.N_T, ek.M_T, ek.NB_T, solves, iters)
        rows[g] = smoke["bound64"](n_bytes, ops)
        print(f"E8 {g} circuits x {n} steps at {SR:g} Hz (seeded starts, "
              f"depths 0 / 0.5 / 1): {solves} Newton calls, {iters} "
              f"eliminations, bound {rows[g][0]:.5f} ms ({rows[g][1]}), "
              f"{rows[g][0] * 1e3 / n:.6f} us per step")
    return rows


if __name__ == "__main__":
    main()
