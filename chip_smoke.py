"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from openwurli_tpu_torch/csrc, compares each
kernel with its plain torch version on the card, checks the tonal anchor
against the reference's golden harmonics, then drives the port's paths,
each with the launch counts set to 0 just before it and read just after:

  * `render_grid`: the headline grid (128 streams × 64 voices, 43·1024
    samples at 44.1 kHz) through K1 (voice bank) and K2 (mono chain);
  * `render_events`: a short event-scheduled render, block-streamed with
    carried state, through K3 (voice bank with events) and K2 at one stream;
  * `render_events_parallel`: a 36 s, 120-note song at the renderer's
    defaults through K3, K4 (tremolo pre-roll) and K2 over 120 segments;
  * the interactive path: a live note_on / note_off / set_sustain session
    on `fast_engine.FastEngine` at its defaults (128 lanes, blocks of 1024)
    through K3 and K2, once more with thermal noise compiled in (K5, at
    gain 0 and at level 8), and the same engine behind
    `stream_host.StreamHost`'s NDJSON commands;
  * `tools/torch_probe.py`: the probe kernel (P1) over its list of probes;
  * `render_grid` at a 32 kHz base rate, whose 64 kHz tremolo state is not
    in the package data and is settled on the card by E3;
  * the f64 engine: `engine.Engine(44100)` warmed up, a scripted session
    (a chord, sustain, 65 notes with a steal, a pedal lift) and the
    reference's 1 s peak-invariant chord, through E1 (voice slots) and E2
    (the f64 chain); `host.WurliPlugin.process` with events; and
    `stream_host.StreamHost(engine="f64")`;
  * the DI path: `di.render_di` over the calibration grid (MIDI 33-96 × 8
    velocities, 2 s at 44.1 kHz) through E4 (voice render) and E5<dk>
    (the 2×-oversampled DK preamp);
  * the f64 engine's other models: `host.WurliPlugin(preamp_model=
    "melange")` with authentic noise on the reference's peak-invariant
    chord, and `Engine` sessions with the behavioral power amp, through
    E1 and E2's other three instantiations; and the melange preamp's
    physics gates (noise RMS against the ngspice anchor, noise gain, gain
    against the DK preamp) through E5<melange> at 88.2 kHz;
  * the calibration pipeline: `calib.calibrate.run_calibrate` over all 64
    keys × 8 velocities (0.5 s) through E4<tap> (reed and pickup taps),
    E5<dk> and E6 (power amp and speaker), timed by stage; the 7-stage
    `calib.pipeline.main` through stage 6 on a three-note recording
    rendered by the port (stage 4 through E4 and E5<dk>); and the onset
    extractors on the fixture mixture;
  * the CLI: every one of `openwurli_tpu_torch.cli`'s 21 subcommands
    through `cli.main(["--device", "cuda", ...])`, each timed and its
    output checked (WAV specs and signal, printed rows, CSV schemas, the
    intermod worst note): the preamp and pump measurements through E7
    (the DK preamp at the input's rate), the renders through E4, E5<dk>,
    K1-K5 and E1/E2, the calibration subcommands through E4<tap>, E5<dk>
    and E6; and the alias-audit sweep through `alias-audit --note N -o`
    (the f64 engine, E1 and E2), against its golden baseline;
  * the f64 stage breakdown: `tools/torch_stage_bench.py`'s `main` (the
    reference's `tools/stage_bench.py` stages: voices through E4, the
    preamp twin through E7, the tremolo through E8, the power amp through
    E9), before the alias sweep;
  * the f64 engine batched: `engine.render_states` over B engine states
    (E1 a cluster of eight blocks per engine, or a thread per slot above
    `kernels.engine.VOICES_LANES_MAX_ENGINES`; E2 a warp, a half-warp or a
    thread per engine, in the bands of `kernels.engine.chain_form`): an
    8-engine batch, each engine against its own `Engine.render`, the
    throughput from the reference perf sweep's broadcast chord at 1-128
    engines, and the chord at 8192 and 16384 engines (and inside each
    band of E2 those miss) against one engine, for each instantiation;
  * the multi-device path on one card: `fast.render_grid_sharded` over a
    one-rank NCCL group at the headline width (K1, K2), bit for bit
    `render_grid`; `parallel.mesh.sharded_grid_render` over the
    calibration grid (E4), bit for bit `voice.render`; and
    `parallel.dryrun.main(1, device="cuda")`, a spawned NCCL rank running
    the sharded training step and the sharded fused kernels;
  * `entry.entry()`'s forward step (8 streams × 64 voices, one block of
    1024 through K1 and K2);
  * `tools/torch_train_onset_model.py` at its usage line's size (20
    mixtures, 200 steps): its pool through K1 and K2, the loss, the
    weights reloaded as format 3, the fixture mixture scored.

E3 is held to its plain version over 512 steps and its full 2 s settle at
88.2 and 96 kHz to the package data; E1 and E2 to theirs with NaN and inf
voice slots, live steal fades, a tremolo BE replay, a power-amp Newton
failure and NaN guard #2 (at the first sample, and midway after a NaN
input), and on one chunk of the engine session; E4
and E5<dk> on `render_di`'s own inputs (all 512 voices, the first 1000
samples, against `render_di`'s output) and at 133 ragged voices with NaN
and inf ones (E5<dk> also at 1, 5 and 33 of them), E5<melange> at noise scales 0, 1 and 30, E2's other
instantiations on a kicked chunk and on 64 samples of the melange
plugin's chunk; E4<tap> and E6 on `run_calibrate`'s own inputs (all 512
streams, the first 1000 and 128 samples) and on 133 ragged streams with
NaN and inf columns; E7 on the CLI's `sweep` (25 streams) and
`pump-sinusoid` (a resistance per sample) calls, the first 1000 steps, and
on 133 ragged streams with NaN and inf inputs (and at 1 and 33 of them),
both taps; E1 and E2 over
five distinct engines (rail sag off, a NaN slot, steal fades, guard #2),
over 128 distinct ones (32 E2 blocks of four warps) and each other
instantiation over two (noise on one) against their batched plain
versions; E8 on 33 circuits from seeded starts at three depths (a kicked
and a NaN circuit) and E9 on 33 streams (a 200 V spike, a NaN and an inf
stream). E5 and E7 run a warp per stream, E8 a warp per circuit and E3
one warp (the melange, DK and mna steps on a warp; the melange and DK
steps also in E2). E2 runs a warp, a half-warp or a thread per engine by width: the warp and
thread forms are held to each other bit for bit on the kicked, guard #2
(at the first sample and midway), session, melange plugin, behavioral
session and 128-engine chunks and timed there in turns (thread, warp,
warp, thread), the half and thread forms on the chord at 8192 and 16384
engines in every instantiation and on 8192 engines tiled from the 128
distinct ones (thread, half, half, thread), the half form against its
plain version over 64 samples of each; E6 and E9 (both on the warp step) leave
the same power-amp rows on run_calibrate's call and on the ragged
streams, timed in turns the same way. E4 and E4<tap> (eight threads per
voice) are also held to their plain versions at 1, 5, 33 and 133 voices,
each voice at its own sample count (mid-onset, a damper mid-ramp); E1
(eight threads per slot on E4's group body) at 1, 5 and 128 engines.
K1 and K3 (eight threads per voice lane) are also held to their plain
versions at a ragged lane count, with non-finite parameters in some lanes
and with the pickup driven past its knee, and K1 is timed across widths.

Each kernel is held bit for bit to its plain version at the shapes those
paths give it, on the calls' own arguments, which the script records
while it drives the path (the plain versions over a prefix where the
whole span would take minutes). Any failed check raises: the script exits non-zero
and prints no result. It needs one CUDA device and imports nothing of JAX.

Output: the card's name and power limit (nvidia-smi), one line per phase,
a JSON line with the kernels' numbers, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import collections
import json
import subprocess
import sys
import time

import numpy as np
import torch

SR = 44100.0
# Golden H1-H6 (dB re 1.0) of note 72 at v=120, 6144-sample render,
# window [2048:6144] — copied from tests/test_quick_gates.py.
TONAL_GOLDEN_DB = [-54.396, -60.032, -69.685, -81.232, -95.447, -101.946]
TONAL_TOL_DB = [1.0, 1.0, 1.0, 1.5, 3.0, 10.0]
# Peak of stream 127 of the phase-5 grid (64 voices, notes 36-99, velocity
# 1.0135) over its first 11264 samples, rendered by the JAX package's
# voice kernel (interpret mode) and `render_cpu` on a CPU: 1.3724635.
REF_PEAK_127 = 1.3724635
# Gate of E3's full 2 s tremolo settle against data/tremolo_settled.npz
# (volts, on v and v_nl): twice the JAX package's own spread there, its
# settle at 88.2 kHz from its start and from that start moved by 1 ulp
# differing from the npz by 1.99e-7 V and 8.2e-8 V on an x86-64 CPU
# (tests/test_torch_settle.py).
E3_SETTLE_GATE = 4.0e-7
# Depths (samples) of the plain replays that dominate the script's time,
# cut so that every phase fits the aim (SCRIPT_LIMIT_S): K2 against its
# plain version on the grid's and render_events' calls (phases 6, 9), K5
# on the grid's call (phase 12), K2 and K5 on a FastEngine block (phases
# 14, 15), E2 on phase 21's chunk (the kicked tremolo's BE replay and
# guard #2 both act within it), on the engine session's and the melange
# plugin's chunks (phases 22, 25), E6 on run_calibrate's call (phase 26);
# K2 and K5 from init_state at 1, 33 and 1024 streams (phase 18), K2 on
# entry()'s block (phase 32, LANES_REPLAY_N). Each
# replay keeps its call's full width. K2, K5, the engine block and E2 went
# from 128 to 64 samples when phase 29 came in (a slower host had started
# the alias sweep at 765 s, too late for its three notes).
K2_REPLAY_N = 64
LANES_REPLAY_N = 32
K5_REPLAY_N = 64
BLOCK_REPLAY_N = 64
E2_REPLAY_N = 64
E6_REPLAY_N = 128


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def first_diff(a, b):
    """Where two equal-shaped tensors first differ, for a failure message."""
    idx = (a != b).nonzero()
    if idx.numel() == 0:
        return "none"
    i = tuple(int(k) for k in idx[0])
    return (f"{idx.shape[0]} elements, first at {i}: {a[i].item()!r} vs "
            f"{b[i].item()!r}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps=1):
    """Mean device time of fn() over reps calls (CUDA events), after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


# The card's published peaks (NVIDIA H100 SXM data sheet): float32 outside
# the tensor cores, and device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# float32 operations per voice lane, read off csrc/voice_bank.cu (an add,
# a multiply, a division or a transcendental counts as one; selects,
# integer work and conversions count as none). What a lane's data needs:
# the damper's ramp terms only in groups that touch the lane's ramp, the
# onset row and the attack noise only on the lane's own samples inside
# its ramp and its burst.
VB_OPS_REFRESH = 7 * (11 + 7 * 10 + 6 * 4 + 7)  # jitter + powers, per 16
VB_OPS_FAST_GROUP = 7 * (2 + 2 + 7 * 4 + 2 + 8)  # P/Q, 8 mode sums, env, R^8
VB_OPS_LEGACY_GROUP = 8 * (3 + 7 * 10) + 7 * 8   # damper sub-steps, R^8
VB_OPS_RAMP_GROUP = 8 * (1 + 7 * 3)    # + the ramp's division, inst, exp
VB_OPS_PICKUP = 20                                # per sample
VB_OPS_ONSET = 6                                  # per sample in the ramp
VB_OPS_NOISE = 22                                 # per sample in the burst

# float32 operations of csrc/mono_chain.cu per stream, from its loop
# extents: one tremolo update (the LDR tail included, as K2 runs it; K4
# runs the tail only in an interval's last two updates); one oversampled
# preamp step; one oversampled power-amp step.
GP_DERIVS_OPS, GP_CURRENTS_OPS = 70, 35
TREM_TAIL_OPS = 12  # log, 2 exp, the divider's parallel, 1/max(...)
TREM_UPDATE_OPS = (11 * 11 * 2
                   + 3 * (2 * GP_DERIVS_OPS + 4 * 4 * 2 + 4 * 4 + 4 * 4 * 4
                          + 100 + 4 * 8)
                   + 2 * GP_CURRENTS_OPS + 13 + TREM_TAIL_OPS)
PREAMP_STEP_OPS = (16 * 16 * 2 + 2 * 8 * 4 * 20 + 4 * 16 * 2 + 5 * 2 * 40
                   + 16 * 8 + 60)
PA_STEP_OPS = (37 * 37 * 2 + 37 * 6
               + 8 * (8 * GP_DERIVS_OPS + 16 * 16 * 2 + 10 * 16 * 4 + 1300
                      + 6 * 10 * 2 + 16 * 8)
               + 8 * GP_CURRENTS_OPS + 16 * 16 * 2 + 120)
CHAIN_SAMPLE_OPS = 2 * (PREAMP_STEP_OPS + PA_STEP_OPS) + 4 * 12 + 60


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take, the
    larger of bytes over its memory rate and operations over its float32
    peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def voice_bank_bound(params, samples, n0, steady, min_release=None):
    """Bound of one voice-bank call: params and state read once, output
    and state written once; operations of this call's groups (warm-phase
    rows before `steady`, legacy groups past `min_release`) as each lane's
    schedule needs them."""
    from openwurli_tpu_torch.kernels import voice_bank as vb

    p = params.detach().cpu().numpy()

    def row(r, i):  # one float row in float64 (some rows hold bit patterns)
        return p[r, i].astype(np.float64)

    lanes = p.shape[-1]
    n_bytes = 4 * lanes * (13 * 8 + 2 * 48 + samples)
    groups = np.arange(n0, n0 + samples, 8)
    events = min_release is not None
    onset = row(vb.ROW_EVT, vb.EVT_ONSET_F) if events else np.zeros(lanes)

    def count(lo, hi):  # integers in [lo, hi) within the call, per lane
        return np.clip(np.minimum(hi, n0 + samples)
                       - np.maximum(lo, n0), 0, None).sum()

    def warm_end(limit):  # first sample of the first group past `limit`
        return n0 + 8 * int((groups < limit).sum())

    legacy = np.zeros(len(groups), bool)
    if events and min_release < 0.5e12:
        legacy = groups + 8 > min_release
    g = groups[legacy][:, None]
    release = row(vb.ROW_EVT, vb.EVT_RELEASE_F)
    ramp_groups = int(((g + 7 - release + 1 >= 1)
                       & (g - release + 1 <= row(vb.ROW_EVT, vb.EVT_RAMP)))
                      .sum())
    ops = (samples // 16 * VB_OPS_REFRESH * lanes
           + int((~legacy).sum()) * VB_OPS_FAST_GROUP * lanes
           + int(legacy.sum()) * VB_OPS_LEGACY_GROUP * lanes
           + ramp_groups * VB_OPS_RAMP_GROUP
           + samples * VB_OPS_PICKUP * lanes
           + count(onset, np.minimum(warm_end(steady[0]),
                                     onset + row(vb.ROW_SCAL, 0)))
           * VB_OPS_ONSET
           + count(onset, np.minimum(warm_end(steady[1]),
                                     onset + row(vb.ROW_NOISE, 2)))
           * VB_OPS_NOISE)
    return bound(n_bytes, ops)


def chain_bound(streams, samples, noise=False):
    """Bound of one chain call: audio in, audio out, state in and out,
    controls and constants once; with `noise`, the thermal-noise branch's
    operations on top (its nz_ rows are in the state's bytes already)."""
    n_bytes = 4 * (streams * (2 * samples + 2 * 328 + 19) + 3312 + 68)
    ops = streams * samples * (CHAIN_SAMPLE_OPS + TREM_UPDATE_OPS / 2)
    return bound(n_bytes, ops + (noise_ops(streams, samples) if noise
                                 else 0))


def preroll_bound(n_captures, stride):
    """Bound of one pre-roll call: no update follows the last capture, and
    a capture reads the LDR tail of its interval's last two updates."""
    n_bytes = 4 * (3312 + 68 + 19 + 328 + n_captures * 19)
    steps = stride // 2
    return bound(n_bytes, (n_captures - 1) * (
        steps * (TREM_UPDATE_OPS - TREM_TAIL_OPS)
        + min(steps, 2) * TREM_TAIL_OPS))


def ptxas_lines(log):
    """{entry function: (registers, stack bytes, spill stores, spill
    loads)} from nvcc's -Xptxas -v output."""
    found, name = {}, None
    for line in (log or "").splitlines():
        words = line.replace(",", " ").split()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "stack frame" in line and name not in found:
            # the entry's own line; its noinline callees' follow
            found[name] = [None, int(words[0]), int(words[4]), int(words[8])]
        elif name and "Used" in words and name in found:
            found[name][0] = int(words[words.index("Used") + 1])
    return {k: tuple(v) for k, v in found.items()}


# The kernels built around the warp-cooperative mna, melange and DK steps,
# and the steps' __noinline__ functions
WARP_KERNELS = ("E2<dk, circuit> warp", "E2<melange, circuit> warp",
                "E2<dk, behavioral> warp", "E2<melange, behavioral> warp",
                "E6", "E5<melange>", "E5<dk>", "E7<diff>", "E7<shadow>",
                "E3", "E8", "E9")
HALF_KERNELS = ("E2<dk, circuit> half", "E2<melange, circuit> half",
                "E2<dk, behavioral> half", "E2<melange, behavioral> half")
HALF_STEP = ("mna_step_segILi21ELi16ELi8ELi16E", "mna_step_segILi7ELi4ELi2ELi4E",
             "power_amp_step_seg", "tremolo_step_seg", "dk_step_seg",
             "melange_step_seg")
WARP_STEP = ("mna_step_warpILi21ELi16ELi8ELi16E", "mna_step_warpILi7ELi4ELi2ELi4E",
             "power_amp_step_warp", "tremolo_step_warp", "melange_step_warp",
             "dk_step_warp")
# the steps of E2's behavioral thread form (a thread's values in
# registers, its rows in shared memory)
THREAD_STEP = ("tremolo_step_reg", "dk_step_reg", "melange_step_reg")


def function_frames(log, key):
    """[(stack bytes, spill stores, spill loads)] of every device function
    whose mangled name holds `key`, from nvcc's -Xptxas -v output (one
    entry per kernel that calls it)."""
    found, name = [], None
    for line in (log or "").splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif name and "stack frame" in line:
            if key in name:
                words = line.replace(",", " ").split()
                found.append((int(words[0]), int(words[4]), int(words[8])))
            name = None
    return found


class StageTimer:
    """Wraps functions of modules so that each call is timed with the
    device synchronised before and after; times in ms by key. With
    `keep`, the arguments of every call are kept too, by key."""

    def __init__(self):
        self.ms = {}
        self.calls = {}
        self._saved = []

    def wrap(self, mod, name, key, keep=False):
        fn = getattr(mod, name)

        def timed(*args, **kw):
            if keep:
                self.calls.setdefault(key, []).append((args, kw))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            torch.cuda.synchronize()
            self.ms[key] = self.ms.get(key, 0.0) \
                + (time.perf_counter() - t0) * 1e3
            return result

        self._saved.append((mod, name, fn))
        setattr(mod, name, timed)

    def restore(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []


def reset_counts(vb, mc):
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import probe

    from openwurli_tpu_torch.kernels import render as kr

    ek.SETTLE_LAUNCHES = 0
    for key in ek.VOICES_LAUNCHES_BY_FORM:
        ek.VOICES_LAUNCHES_BY_FORM[key] = 0
    ek.VOICES_PLAIN_CALLS = ek.CHAIN_PLAIN_CALLS = ek.SETTLE_PLAIN_CALLS = 0
    for key in ek.CHAIN_LAUNCHES_BY_FORM:
        ek.CHAIN_LAUNCHES_BY_FORM[key] = 0
    kr.VOICE_RENDER_LAUNCHES = kr.VOICE_RENDER_PLAIN_CALLS = 0
    kr.PREAMP_SCAN_PLAIN_CALLS = 0
    kr.VOICE_TAP_LAUNCHES = kr.VOICE_TAP_PLAIN_CALLS = 0
    kr.PA_SPEAKER_LAUNCHES = kr.PA_SPEAKER_PLAIN_CALLS = 0
    kr.DK_SCAN_PLAIN_CALLS = 0
    ek.TREMOLO_SCAN_LAUNCHES = ek.TREMOLO_SCAN_PLAIN_CALLS = 0
    ek.POWER_AMP_SCAN_LAUNCHES = ek.POWER_AMP_SCAN_PLAIN_CALLS = 0
    for counter in (kr.PREAMP_SCAN_LAUNCHES, kr.DK_SCAN_LAUNCHES):
        for key in counter:
            counter[key] = 0
    vb.KERNEL_LAUNCHES = vb.PLAIN_CALLS = 0
    for name in vb.LAUNCHES_BY_KERNEL:
        vb.LAUNCHES_BY_KERNEL[name] = 0
    mc.KERNEL_LAUNCHES = mc.NOISE_KERNEL_LAUNCHES = mc.PLAIN_CALLS = 0
    mc.PREROLL_KERNEL_LAUNCHES = mc.PREROLL_PLAIN_CALLS = 0
    probe.KERNEL_LAUNCHES = probe.PLAIN_CALLS = 0


def read_counts(vb, mc):
    """Kernel launches by kernel name since reset_counts, and the calls
    that any plain version served."""
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import probe
    from openwurli_tpu_torch.kernels import render as kr

    by_form = ek.CHAIN_LAUNCHES_BY_FORM
    return {**vb.LAUNCHES_BY_KERNEL, "mono_chain": mc.KERNEL_LAUNCHES,
            "mono_chain_noise": mc.NOISE_KERNEL_LAUNCHES,
            "trem_preroll": mc.PREROLL_KERNEL_LAUNCHES,
            "probe": probe.KERNEL_LAUNCHES,
            # E1: the cluster form under the name E1 had, the thread form
            # with "_thread" appended
            "engine_voices": ek.VOICES_LAUNCHES_BY_FORM["lanes"],
            "engine_voices_thread": ek.VOICES_LAUNCHES_BY_FORM["thread"],
            # E2: the warp form under the names the instantiations had,
            # the thread and half forms with "_thread" and "_half"
            # appended
            **{"engine_chain" + ("" if (p, a) == ("dk", "circuit")
                                 else f"_{p}_{a}")
               + ("" if f == "warp" else f"_{f}"): by_form[p, a, f]
               for p, a, f in by_form},
            "tremolo_settle": ek.SETTLE_LAUNCHES,
            "voice_render": kr.VOICE_RENDER_LAUNCHES,
            "preamp_scan_dk": kr.PREAMP_SCAN_LAUNCHES["dk"],
            "preamp_scan_melange": kr.PREAMP_SCAN_LAUNCHES["melange"],
            "voice_render_tap": kr.VOICE_TAP_LAUNCHES,
            "pa_speaker_scan": kr.PA_SPEAKER_LAUNCHES,
            "dk_scan": sum(kr.DK_SCAN_LAUNCHES.values()),
            "tremolo_scan": ek.TREMOLO_SCAN_LAUNCHES,
            "power_amp_scan": ek.POWER_AMP_SCAN_LAUNCHES,
            "plain": vb.PLAIN_CALLS + mc.PLAIN_CALLS
            + mc.PREROLL_PLAIN_CALLS + probe.PLAIN_CALLS
            + ek.VOICES_PLAIN_CALLS + ek.CHAIN_PLAIN_CALLS
            + ek.SETTLE_PLAIN_CALLS + kr.VOICE_RENDER_PLAIN_CALLS
            + kr.PREAMP_SCAN_PLAIN_CALLS + kr.VOICE_TAP_PLAIN_CALLS
            + kr.PA_SPEAKER_PLAIN_CALLS + kr.DK_SCAN_PLAIN_CALLS
            + ek.TREMOLO_SCAN_PLAIN_CALLS + ek.POWER_AMP_SCAN_PLAIN_CALLS}


def bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def compare_chain(mc, call, t_cmp, what):
    """K2 (K5 where the call asked for noise) against its plain version
    over the first t_cmp samples of one recorded `mc.render` call (its
    controls, its starting state, its audio): output and state bit for
    bit. Returns the comparison's numbers for the kernels line."""
    (sr, ctrl, st0, audio), kw = call
    noise = bool(kw.get("noise", False))
    a_cmp = audio[:t_cmp].contiguous()
    out, st = mc.render(sr, ctrl, st0, a_cmp, noise=noise)
    plain_ms, (p_out, p_st) = host_ms(lambda: mc.render_chain_plain(
        mc.pack_consts(sr), ctrl, st0, a_cmp, noise=noise))
    ms = cuda_ms(lambda: mc.render(sr, ctrl, st0, a_cmp, noise=noise))
    err = float((out - p_out).abs().max())
    what = ("K5 " if noise else "K2 ") + what
    check(torch.isfinite(out).all().item(), f"{what}: output not finite")
    # the state compared as bit patterns: its nz_lcg rows hold u32 LCG
    # words, some of which read as NaN floats
    st_bits, p_st_bits = st.view(torch.int32), p_st.view(torch.int32)
    check(torch.equal(out, p_out) and torch.equal(st_bits, p_st_bits),
          f"{what}: max abs err {err:.3e} against the plain version; "
          f"differing {first_diff(out, p_out)}, state "
          f"{first_diff(st_bits, p_st_bits)}")
    return {"shape": f"{audio.shape[1]} streams x {t_cmp}", "inputs": what,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "peak_in": float(a_cmp.abs().max())}


def noise_ops(streams, samples):
    """float32 operations the thermal-noise branch adds to a chain call,
    read off csrc/mono_chain.cu: per oversampled step 40 uniforms (2
    operations each), 10 Irwin-Hall sums (3 adds, 2 multiplies), the
    two-draw stamp (9 adds), the (8, 9) and (2, 9) matvecs and 13 adds into
    the solver. The ~400 integer operations of the 40 LCG steps and hashes
    count as none, as everywhere in this file."""
    return streams * samples * 2 * (40 * 2 + 10 * 5 + 9 + 10 * 17 + 13)


def run_session(eng, script, n_chunks, chunk):
    """Drive a live session: before chunk k the calls script[k] (each a
    function of the engine) are made, then `chunk` samples are rendered,
    timed on the host clock (render returns host memory, so the card has
    finished) → (audio (n_chunks·chunk,), wall seconds per chunk)."""
    pieces, walls = [], []
    for k in range(n_chunks):
        for call in script.get(k, ()):
            call(eng)
        t0 = time.perf_counter()
        pieces.append(eng.render(chunk))
        walls.append(time.perf_counter() - t0)
    return np.concatenate(pieces), np.asarray(walls)


def session_stats(walls, chunk, sr):
    """Per-chunk wall times → the sustained realtime factor and the
    percentiles a host's audio callback cares about."""
    chunk_s = chunk / sr
    seconds, wall = len(walls) * chunk_s, float(walls.sum())
    return {"seconds": seconds, "wall_s": wall, "rtf": seconds / wall,
            "chunk_ms": chunk_s * 1e3,
            "p50_ms": float(np.percentile(walls, 50)) * 1e3,
            "p99_ms": float(np.percentile(walls, 99)) * 1e3,
            "max_ms": float(walls.max()) * 1e3,
            "over_budget": float((walls > chunk_s).mean())}


# The interactive phase's session, in blocks of 1024: note-ons at in-block
# offsets, a pedal hold, a release under the pedal, a pedal lift mid-block,
# a re-strike. SESSION_SCHEDULE is what it amounts to, per voice in note-on
# order: (midi, velocity, onset, release) in samples.
SESSION_BLOCKS = 9
SESSION_SCRIPT = {
    0: [lambda e: e.note_on(60, 0.9, offset=48)],
    1: [lambda e: e.note_on(64, 0.7, offset=1024 - 16),
        lambda e: e.set_sustain(True)],
    2: [lambda e: e.note_off(60, offset=100)],          # held by the pedal
    3: [lambda e: e.set_sustain(False, offset=32),      # lifts it mid-block
        lambda e: e.note_on(67, 0.8, offset=512)],
    4: [lambda e: e.note_on(64, 0.5, offset=256)],      # re-strike
    5: [lambda e: e.note_off(64), lambda e: e.note_off(67, offset=700)],
}
SESSION_SCHEDULE = [
    (60.0, 0.9, 48.0, 3 * 1024 + 32.0),
    (64.0, 0.7, 1024 + 1008.0, 4 * 1024 + 256.0),
    (67.0, 0.8, 3 * 1024 + 512.0, 5 * 1024 + 700.0),
    (64.0, 0.5, 4 * 1024 + 256.0, 5 * 1024.0),
]


def drive_session(vb, mc, eng, what):
    """precompile the engine, run the session with the launch counts
    zeroed and every kernel call recorded → dict of its audio, counts,
    calls, times and the chain state after the warm-up."""
    chain_ms = []
    render = mc.render

    def timed(*args, **kw):
        ms, result = host_ms(lambda: render(*args, **kw))
        chain_ms.append(ms)
        return result

    mc.render = timed
    try:
        pre_ms, _ = host_ms(eng.precompile)
    finally:
        mc.render = render
    # precompile's chain calls: the throwaway block, then the warm-up
    check(len(chain_ms) == 2, f"{what}: precompile's chain calls")
    warm_ms = chain_ms[1]
    warm_state = eng._chain_state.clone()
    log = StageTimer()
    log.wrap(vb, "render_voice_bank", "K3", keep=True)
    log.wrap(mc, "render", "chain", keep=True)
    reset_counts(vb, mc)
    try:
        audio, walls = run_session(eng, SESSION_SCRIPT, SESSION_BLOCKS,
                                   eng.block)
    finally:
        log.restore()
    counts = read_counts(vb, mc)
    check(audio.shape == (SESSION_BLOCKS * eng.block,)
          and np.isfinite(audio).all(), f"{what}: shape or finiteness")
    n = len(SESSION_SCHEDULE)
    got = list(zip(eng._midis[:n], eng._vels[:n], eng._onsets[:n],
                   eng._releases[:n]))
    check(eng._n_used == n and got == SESSION_SCHEDULE,
          f"{what}: the engine's schedule {got}")
    return {"audio": audio, "walls": walls, "counts": counts,
            "calls": log.calls, "stage_ms": dict(log.ms),
            "precompile_ms": pre_ms, "warm_ms": warm_ms,
            "warm_state": warm_state,
            "stats": session_stats(walls, eng.block, eng.sample_rate)}


def session_block_loop(vb, mc, eng, warm_state, noise=False):
    """The session's schedule, known from t=0, through the engine's block
    written out: K3 with the engine's two pins, the lane sum, the chain,
    from `warm_state` → (SESSION_BLOCKS·block,) array."""
    midis, vels, onsets, releases = (list(x) for x in zip(*SESSION_SCHEDULE))
    params, _ = vb.make_kernel_params(midis, vels, eng.sample_rate,
                                      onsets=onsets, releases=releases,
                                      lanes=128, device=eng.device)
    vstate, state, outs = vb.init_bank_state(params), warm_state, []
    for b in range(SESSION_BLOCKS):
        voices, vstate = vb.render_voice_bank(
            params, eng.block, steady=None, state=vstate, n0=b * eng.block,
            return_state=True, events=True, min_release=0.0)
        out, state = mc.render(eng.sample_rate, eng._controls(), state,
                               voices.sum(-1, keepdim=True), noise=noise)
        outs.append(out[:, 0])
    return torch.cat(outs).cpu().numpy()


def song_schedule(seconds=36.0, n_notes=120, seed=7):
    """The reference bench's pseudo-song (bench.py `_child_song`): onsets
    from 0.5 s to 4 s before the end, midi 36-95, velocity 0.4-1.0,
    durations 0.2-3.0 s."""
    rng = np.random.default_rng(seed)
    onsets = np.sort(rng.uniform(0.5, seconds - 4.0, n_notes)) * SR
    midis = rng.integers(36, 96, n_notes).astype(np.float64)
    vels = rng.uniform(0.4, 1.0, n_notes)
    durs = rng.uniform(0.2, 3.0, n_notes) * SR
    return midis, vels, onsets, onsets + durs


def harmonics_db(seg, f0, sr, n=6, span_hz=5.0, steps=21):
    """Single-bin DFT magnitudes of H1..Hn after refining f0 by a ±span
    scan (calib/goertzel.py's harmonic_ladder, in NumPy)."""
    seg = np.asarray(seg, np.float64)
    t = np.arange(seg.size) / sr

    def mags(freqs):
        ph = 2.0 * np.pi * np.asarray(freqs)[:, None] * t[None]
        re = (seg[None] * np.cos(ph)).sum(-1)
        im = (seg[None] * np.sin(ph)).sum(-1)
        return 2.0 * np.sqrt(re ** 2 + im ** 2) / seg.size

    cands = f0 + np.linspace(-span_hz, span_hz, steps)
    f0r = cands[np.argmax(mags(cands))]
    amps = mags(f0r * np.arange(1, n + 1))
    return 20 * np.log10(np.maximum(amps, 1e-12))


# ── the f64 engine (phases 20-22): bounds, comparisons, the recorder ──

# The card's published float64 peak outside the tensor cores (NVIDIA H100
# SXM data sheet, 34 TFLOP/s); the engine kernels compute in float64.
PEAK_F64_FLOPS = 34e12
LIBM_OPS = 20  # one f64 exp / log1p / cos / pow / tanh counted as 20
# float64 operations read off csrc/engine.cu, libm calls as LIBM_OPS:
# one voice slot's sample without its libm calls (reed damper, onset,
# rotation of 7 modes, output, the noise biquad, the pickup, the gates and
# its share of the slot sum), the jitter draws every 16th sample; the libm
# calls are counted where the data needs them (VoiceLibm)
E1_OPS_SLOT_SAMPLE = 7 * 14 + 7 * 4 + 12 + 12 + 14 + 6
E1_OPS_JITTER = 7 * 6


class VoiceLibm:
    """While active, counts the libm calls that the plain voice step's
    data needs, summed over voices and samples: the damper's 7 exps in a
    voice's release ramp, the onset's cos (and its pow, for a shape
    neither 1 nor 2) before the ramp ends, the attack noise's fade cos
    while the burst fades in, the pickup's tanh past its knee. The step
    functions that `voice.step` calls are wrapped; `calls` is read after
    the run (one read-back)."""

    def __init__(self):
        from openwurli_tpu_torch import hammer, pickup, reed
        self.mods = (reed, hammer, pickup)
        self.orig = (reed.step, hammer.noise_step, pickup.step)
        self.total = 0

    def _add(self, mask):
        self.total = self.total + mask.sum()

    def __enter__(self):
        reed, hammer, pickup = self.mods
        r_step, n_step, p_step = self.orig

        def reed_step(params, state):
            rel = torch.where(state.damper_active,
                              state.damper_release_count + 1.0,
                              state.damper_release_count)
            in_ramp = (state.damper_active & ~state.damper_ramp_done
                       & ~(rel > state.damper_ramp_samples))
            self._add(in_ramp * 7)
            onset = state.n < params.onset_ramp_samples
            e = params.onset_shape_exp
            self._add(onset * (1 + ((e > 1.001) & (e < 1.999))))
            return r_step(params, state)

        def noise_step(params, state):
            self._add((state.remaining > 0) & (state.fade_in_remaining > 0))
            return n_step(params, state)

        def pickup_step(params, state, x):
            self._add(~(torch.abs(x * params.displacement_scale)
                        < pickup.PICKUP_KNEE_Y))
            return p_step(params, state, x)

        reed.step, hammer.noise_step, pickup.step = (reed_step, noise_step,
                                                     pickup_step)
        return self

    def __exit__(self, *exc):
        reed, hammer, pickup = self.mods
        reed.step, hammer.noise_step, pickup.step = self.orig

    @property
    def calls(self):
        return int(self.total)
# the chain's fixed work per base sample outside its Newton solves: the
# smoothers, the oversampler's four branches, two tremolo tails and LDR
# conductances, the speaker and the post gain (a coefficient design, when
# the character moves, counts separately)
E2_OPS_SAMPLE = 9 + 48 + 2 * (30 + 2 + 2 * LIBM_OPS) + 25 + LIBM_OPS + 2
E2_OPS_DESIGN = 30 + 4 * LIBM_OPS
PREAMP_OPS_STEP = 2 * (64 * 2 + 12 + 64 * 2 + 16 + 8 * 5 + 2 * LIBM_OPS) + 8
PREAMP_OPS_PASS = 2 * (2 * (6 + LIBM_OPS) + 28)


def mna_ops(n, m, nb, solves, iterations):
    """float64 operations of the mna steps that ran `solves` Newton calls
    (one per integration, the BE replays included) with `iterations`
    eliminations: per call the history, the linear solve, the port
    projection, the node update and the ladder's checks; per current
    evaluation (one per iteration, one more per call) the GP currents
    (4 limexp each), K·i and the residual; per iteration the derivatives,
    the Jacobian, the f32 elimination and the junction limit."""
    per_call = 4 * n * n + 6 * n * m + 12 * n + 5
    per_eval = nb * (20 + 4 * LIBM_OPS) + 2 * m * m + 3 * m
    per_iter = (nb * (40 + 4 * LIBM_OPS) + 4 * m * m + 2 * m ** 3 // 3
                + m * m + m * (8 + LIBM_OPS))
    return (solves * (per_call + per_eval)
            + iterations * (per_eval + per_iter))


# the melange preamp's float64 work per step outside its Newton
# iterations (csrc/engine.cu melange_step): ten normals (the erfinv
# polynomial, its log1p and sqrt), the noise stamp, two rows of history,
# predictor, Sherman-Morrison and port projection, the corrected kernel,
# one current evaluation per row and the node update; per residual pass
# both rows' currents and residuals; per row update its Jacobian, f32
# elimination and clipped step
MEL_OPS_STEP = (10 * (50 + 2 * LIBM_OPS + 4) + 130 * 2 + 2 * (
    169 * 2 + 16 + 65 * 2 + 13 + 169 * 2 + 13 * 3 + 65 * 2) + 50
                + 2 * (2 * (20 + 4 * LIBM_OPS) + 6 + 65 * 2 + 5 * 2 + 13 * 4))
MEL_OPS_CHECK = 2 * (2 * (20 + 4 * LIBM_OPS) + 6 + LIBM_OPS + 25 * 2 + 15)
MEL_OPS_UPDATE = 2 * (40 + 4 * LIBM_OPS) + 25 * 3 + 2 * 125 // 3 + 40
BEHAVIORAL_OPS = 8 * (30 + 2 * LIBM_OPS) + 6  # 8 Newton iterations


def melange_ops(counts):
    """Operations of the melange steps behind melange_preamp.NEWTON_COUNTS
    deltas, each twin pair's own Newton work: its steps, its residual
    passes (both rows) and its row updates."""
    return (counts["steps"] * MEL_OPS_STEP + counts["checks"] * MEL_OPS_CHECK
            + counts["updates"] * MEL_OPS_UPDATE)


def bound64(n_bytes, n_ops):
    """bound() with the card's float64 peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F64_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def same_bits(a, b):
    """Equal bit patterns (f64 / i64 / f32), any NaN equal to any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        if not torch.equal(na, nb):
            return False
        view = torch.int64 if a.dtype == torch.float64 else torch.int32
        return torch.equal(a[~na].contiguous().view(view),
                           b[~nb].contiguous().view(view))
    return torch.equal(a, b)


class EngineRecorder:
    """Wraps the engine kernels' wrappers so that every call's inputs are
    kept as clones taken before the call (the wrappers update the state
    tensors in place). `Engine.render`'s calls, batches of one engine, are
    kept in the one-engine form (no engine axis, the flags as Python
    numbers)."""

    def __init__(self, ek):
        self.ek, self.voices, self.chain = ek, [], []
        self._v, self._c = ek.render_voices, ek.render_chain

        def voices(*args, **kw):
            one = args[0].dim() == 3 and args[0].shape[0] == 1
            self.voices.append(tuple(
                (a[0] if one else a).clone() if torch.is_tensor(a) else a
                for a in args))
            return self._v(*args, **kw)

        def chain(cp, mono, state, sag, noise_scale=0.0):
            if mono.dim() == 2 and mono.shape[0] == 1:
                self.chain.append((cp, mono[0].clone(), state[0].clone(),
                                   bool(sag[0]), float(noise_scale[0])))
            else:
                self.chain.append((cp, mono.clone(), state.clone(), sag,
                                   noise_scale))
            return self._c(cp, mono, state, sag, noise_scale)

        ek.render_voices, ek.render_chain = voices, chain

    def restore(self):
        self.ek.render_voices, self.ek.render_chain = self._v, self._c


def compare_voices(ek, call, what):
    """E1 against its plain version on one recorded call's inputs (one
    engine, or B engines with a leading axis): mono and the updated state
    bit for bit; → numbers for the kernels line."""
    vpar, vst, vsti, eng_i, n, fade_len, sr = call
    engines = vpar.shape[0] if vpar.dim() == 3 else 1
    ins = [x.clone() for x in (vpar, vst, vsti, eng_i)]
    mono = ek.render_voices(*ins, n, fade_len, sr)
    pins = [x.clone() for x in (vpar, vst, vsti, eng_i)]
    with VoiceLibm() as libm:
        plain_ms, p_mono = host_ms(lambda: ek.voices_plain(*pins, n,
                                                           fade_len, sr))
    names = ("mono", "vst", "vsti", "eng_i")
    for name, a, b in zip(names, (mono, *ins[1:]), (p_mono, *pins[1:])):
        check(same_bits(a, b), f"E1 {what}: {name} differs from the plain "
              f"version: {first_diff(a, b)}")
    ms = cuda_ms(lambda: ek.render_voices(
        *[x.clone() for x in (vpar, vst, vsti, eng_i)], n, fade_len, sr),
        reps=3)
    n_bytes = (vpar.numel() + 2 * (vst.numel() + vsti.numel()
                                   + eng_i.numel()) + engines * n) * 8
    ops = (engines * (n * ek.SLOTS * E1_OPS_SLOT_SAMPLE + (n // 16)
                      * ek.SLOTS * E1_OPS_JITTER) + libm.calls * LIBM_OPS)
    shape = f"{ek.SLOTS} slots x {n}"
    return {"shape": (f"{engines} engines x {shape}" if vpar.dim() == 3
                      else shape),
            "inputs": f"E1 {what}",
            "max_abs_err": float((mono - p_mono).abs().nan_to_num().max()),
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops)}


def compare_chain_f64(ek, call, what, plain_rows=None):
    """E2 against its plain version on one recorded call's inputs (one
    engine, or B engines: mono (B, n), chain (B, CHAIN_ROWS) and the flags
    as (B,) tensors): output and chain state bit for bit, in the form that
    render_chain picks for B and in the other two forced (each timed);
    the plain run's Newton counts, summed over the engines, give the
    operations this chunk needed (for the bound). With `plain_rows`, the
    kernels run at B and the plain version on the first plain_rows
    engines, whose rows are compared: for a batch whose rows repeat with
    that period (a broadcast or tiled state), whose operations scale with
    B / plain_rows."""
    from openwurli_tpu_torch.circuits import dk_preamp, melange_preamp, mna

    cp, mono, state, sag = call[:4]
    scale = call[4] if len(call) > 4 else 0.0
    check(plain_rows is None or mono.shape[0] % plain_rows == 0,
          f"E2 {what}: {plain_rows} plain rows of {mono.shape[0]}")
    st = state.clone()
    out = ek.render_chain(cp, mono, st, sag, scale)
    rows = slice(None) if plain_rows is None else slice(0, plain_rows)
    p_st = state[rows].clone()
    n0 = dict(mna.NEWTON_COUNTS)
    passes0 = dk_preamp.NEWTON_PASSES[0]
    mel0 = dict(melange_preamp.NEWTON_COUNTS)
    plain_ms, p_out = host_ms(lambda: ek.chain_plain(
        cp, mono[rows], p_st, sag[rows] if plain_rows else sag,
        scale[rows] if plain_rows else scale))
    count = {k: mna.NEWTON_COUNTS[k] - n0.get(k, 0)
             for k in mna.NEWTON_COUNTS}
    passes = dk_preamp.NEWTON_PASSES[0] - passes0
    mel = {k: melange_preamp.NEWTON_COUNTS[k] - mel0[k] for k in mel0}
    check(same_bits(out[rows], p_out) and same_bits(st[rows], p_st),
          f"E2 {what}: output {first_diff(out[rows], p_out)}, state "
          f"{first_diff(st[rows], p_st)} against the plain version")
    # every form of E2 on the same call, forced: the routed form's bits,
    # and each form's time
    models = (cp.preamp_model, cp.pa_model)
    n = mono.shape[-1]
    b = mono.shape[0] if mono.dim() == 2 else 1
    form = ek.chain_form(*models, b)
    ms_by_form = {}
    for f in ek.CHAIN_FORMS:
        restore = force_chain_form(ek, models, f)
        try:
            if f != form:
                s_f = state.clone()
                o_f = ek.render_chain(cp, mono, s_f, sag, scale)
                check(same_bits(o_f, out) and same_bits(s_f, st),
                      f"E2 {what}: the {f} form against the {form} form: "
                      f"output {first_diff(o_f, out)}, state "
                      f"{first_diff(s_f, st)}")
            ms_by_form[f] = cuda_ms(lambda: ek.render_chain(
                cp, mono, state.clone(), sag, scale), reps=2)
        finally:
            restore()
    ms = ms_by_form[form]
    if plain_rows is not None:  # the operations of all B engines
        per = b // plain_rows
        count = {k: v * per for k, v in count.items()}
        passes *= per
        mel = {k: v * per for k, v in mel.items()}
    a, _ = ek.CHAIN_OFF["sm_char"]
    rems = state.reshape(b, ek.CHAIN_ROWS)[:, a + ek.SM_REM].tolist()
    designs = sum(1 + min(int(rem), n) for rem in rems)
    steps = b * n * (2 if cp.oversample else 1)
    melange = cp.preamp_model == "melange"
    ops = (b * n * E2_OPS_SAMPLE + designs * E2_OPS_DESIGN
           + (0 if melange else steps * PREAMP_OPS_STEP)
           + passes * PREAMP_OPS_PASS
           + melange_ops(mel)
           + (steps * BEHAVIORAL_OPS if cp.pa_model == "behavioral" else 0)
           + mna_ops(ek.N_T, ek.M_T, ek.NB_T, count.get((4, "solves"), 0),
                     count.get((4, "iterations"), 0))
           + mna_ops(ek.N_PA, ek.M_PA, ek.NB_PA,
                     count.get((16, "solves"), 0),
                     count.get((16, "iterations"), 0)))
    n_bytes = cp.flat.size * 8 + b * (n * 12 + 2 * ek.CHAIN_ROWS * 8)
    return {"shape": f"{b} engine{'s' if b > 1 else ''} x {n}",
            "inputs": f"E2 {what}",
            "models": [cp.preamp_model, cp.pa_model], "form": form,
            "max_abs_err": float((out[rows] - p_out).abs().nan_to_num()
                                 .max()),
            "ms": ms, "ms_by_form": ms_by_form, "plain_ms": plain_ms,
            "bound": bound64(n_bytes, ops),
            "newton": {"tremolo": [count.get((4, "solves"), 0),
                                   count.get((4, "iterations"), 0)],
                       "power_amp": [count.get((16, "solves"), 0),
                                     count.get((16, "iterations"), 0)],
                       "preamp_passes": passes},
            "us_per_base_sample": ms * 1e3 / n}


def force_chain_form(ek, models, form):
    """Routes E2<models> to `form` ("warp", "half" or "thread") at every
    width; → a function that puts the wrapper's bands back."""
    saved = [(d, d[models]) for d in (ek.CHAIN_WARP_MAX_ENGINES,
                                      ek.CHAIN_HALF_MAX_ENGINES)]
    ek.CHAIN_WARP_MAX_ENGINES[models] = None if form == "warp" else 0
    ek.CHAIN_HALF_MAX_ENGINES[models] = None if form == "half" else 0

    def restore():
        for d, widest in saved:
            d[models] = widest
    return restore


def chain_forms(ek, call, what, forms=("thread", "warp")):
    """Two of E2's forms on one recorded call (a thread per engine,
    engine_chain_kernel; a warp per engine, engine_chain_warp_kernel; a
    half-warp per engine, engine_chain_half_kernel) give the same output
    and state bit for bit; timed A B B A (CUDA events). → numbers."""
    cp, mono, state, sag = call[:4]
    scale = call[4] if len(call) > 4 else 0.0
    models = (cp.preamp_model, cp.pa_model)

    def run(form, st):
        restore = force_chain_form(ek, models, form)
        try:
            return ek.render_chain(cp, mono, st, sag, scale)
        finally:
            restore()

    a, b = forms
    sa, sb = state.clone(), state.clone()
    oa, ob = run(a, sa), run(b, sb)
    check(same_bits(oa, ob) and same_bits(sa, sb),
          f"E2 {what}: the {b} form against the {a} form: output "
          f"{first_diff(ob, oa)}, state {first_diff(sb, sa)}")
    times = [cuda_ms(lambda f=f: run(f, state.clone()))
             for f in (a, b, b, a)]
    n = mono.shape[-1]
    return {"inputs": f"E2 {what}", "models": [cp.preamp_model,
                                                cp.pa_model],
            f"{a}_ms": [times[0], times[3]], f"{b}_ms": times[1:3],
            "us_per_base_sample": {a: times[0] * 1e3 / n,
                                   b: times[1] * 1e3 / n}}


def voices_forms(ek, call, what):
    """E1's two forms on one call: a cluster of blocks per engine
    (engine_voices_kernel) and a thread per slot (engine_voices_thread_
    kernel) give the same mono and state bit for bit; timed thread,
    lanes, lanes, thread (CUDA events). → numbers."""
    cols, rest = call[:4], call[4:]
    widest = ek.VOICES_LANES_MAX_ENGINES

    def run(lanes, st):
        ek.VOICES_LANES_MAX_ENGINES = None if lanes else 0
        try:
            return ek.render_voices(*st, *rest)
        finally:
            ek.VOICES_LANES_MAX_ENGINES = widest

    sl, stt = [x.clone() for x in cols], [x.clone() for x in cols]
    ml, mt = run(True, sl), run(False, stt)
    check(same_bits(ml, mt) and all(same_bits(a, b)
                                    for a, b in zip(sl, stt)),
          f"E1 {what}: the cluster form against the thread form: mono "
          f"{first_diff(ml, mt)}")
    times = [cuda_ms(lambda: run(f, [x.clone() for x in cols]))
             for f in (False, True, True, False)]
    return {"inputs": f"E1 {what}", "thread_ms": [times[0], times[3]],
            "lanes_ms": times[1:3]}


def voice_tool():
    """tools/torch_voice_breakdown.py's namespace: its build() makes
    tools/voice_breakdown.cu, which holds E1's thread form before its
    votes (voice_sample on every slot) beside the library's kernels."""
    import os
    import runpy
    return runpy.run_path(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools", "torch_voice_breakdown.py"))


def e1_against_parent(tool, dll, ek, cols, n, fade, what):
    """E1's thread form (render_voices above VOICES_LANES_MAX_ENGINES)
    and its parent, the same kernel before its votes (the tool's
    e1b_thread_kernel<1, false>), on the same slots: bit for bit (mono
    and every slot row), then timed thread form, parent, parent, thread
    form (CUDA events; each call on its own copy of the slots, made
    before the timed calls). → numbers."""
    b = cols[0].shape[0]
    check(b > ek.VOICES_LANES_MAX_ENGINES, f"E1 {what}: in the thread band")
    stream = torch.cuda.current_stream().cuda_stream
    before = tool["E1_VARIANTS"].index(
        "E1 thread form without votes (before)")

    def parent(a):
        mono = torch.empty((b, n), dtype=torch.float64, device=a[0].device)
        err = dll.e1b_launch(before, *[x.data_ptr() for x in a],
                             mono.data_ptr(), n, b, fade, SR, stream)
        check(err == 0, f"E1 {what}: the parent kernel, cudaError {err}")
        return mono

    def library(a):
        return ek.render_voices(*a, n, fade, SR)

    sa, sp = [x.clone() for x in cols], [x.clone() for x in cols]
    ma, mp = library(sa), parent(sp)
    check(same_bits(ma, mp) and all(same_bits(x, y)
                                    for x, y in zip(sa, sp)),
          f"E1 {what}: the thread form against its parent: mono "
          f"{first_diff(ma, mp)}")
    del sa, sp

    def timed(fn):
        copies = [[x.clone() for x in cols] for _ in range(3)]
        fn(copies.pop())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for a in copies:
            fn(a)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / len(copies)

    times = [timed(f) for f in (library, parent, parent, library)]
    return {"inputs": f"E1 {what}", "ms": [times[0], times[3]],
            "parent_ms": times[1:3]}


def abba_line(forms):
    """chain_forms' times as printed: thread, warp, warp, thread (ms), and
    µs per base sample of each form."""
    us = forms["us_per_base_sample"]
    return (f"thread {forms['thread_ms'][0]:.3f}, warp "
            + " / ".join(f"{t:.3f}" for t in forms["warp_ms"])
            + f", thread {forms['thread_ms'][1]:.3f} ms ({us['warp']:.2f} "
            f"against {us['thread']:.2f} us per base sample)")


def engine_phases(dev, card, launches, vb, mc, fast, ptxas):
    """Phases 20-22: E3 (the tremolo settle), E1 and E2 against their
    plain versions, and the f64 engine driven through its entry points.
    Adds its paths' launch counts to `launches`; → the three kernels'
    measurements."""
    from openwurli_tpu_torch import host, stream_host
    from openwurli_tpu_torch.circuits import mna
    from openwurli_tpu_torch.circuits import tremolo as trm
    from openwurli_tpu_torch.engine import Engine
    from openwurli_tpu_torch.kernels import engine as ek

    # ── phase 20: E3 against its plain version, the full settle against
    # the package data, and render_grid at a base rate the data lacks ──
    t_p = time.perf_counter()
    sr_os = 2 * SR
    st0 = ek.osc_flat(trm.perturbed_start(trm.make_params(sr_os), dev))
    a = ek.settle(sr_os, st0.clone(), 512)
    b = st0.clone()
    n0 = dict(mna.NEWTON_COUNTS)
    e3_plain_ms, _ = host_ms(lambda: ek.settle_plain(sr_os, b, 512))
    e3_count = [mna.NEWTON_COUNTS[4, k] - n0.get((4, k), 0)
                for k in ("solves", "iterations")]
    check(same_bits(a, b), f"E3 512 steps: {first_diff(a, b)}")
    e3_err = float((a - b).abs().max())
    e3_ms = cuda_ms(lambda: ek.settle(sr_os, st0.clone(), 512), reps=3)
    e3_bound = bound64((ek.solver_block_size(ek.N_T, ek.M_T, ek.NB_T)
                        + 2 * ek.OSC_ROWS) * 8,
                       mna_ops(ek.N_T, ek.M_T, ek.NB_T, *e3_count))
    full = {}
    with np.load(trm.SETTLED_PATH) as z:
        for sr in (88200.0, 96000.0):
            start = trm.perturbed_start(trm.make_params(sr), dev)
            n_steps = trm.settle_steps(sr)
            ms, st = host_ms(lambda: ek.tremolo_settle(sr, start, n_steps))
            key = f"sr{int(sr)}"
            dv = float(np.abs(st.v.cpu().numpy() - z[key + "_v"]).max())
            dvnl = float(np.abs(st.v_nl.cpu().numpy()
                                - z[key + "_vnl"]).max())
            check(max(dv, dvnl) <= E3_SETTLE_GATE,
                  f"E3 settle at {sr:g} Hz: {dv:.3g} / {dvnl:.3g} V from "
                  f"the npz (gate {E3_SETTLE_GATE:g})")
            full[key] = {"steps": n_steps, "ms": ms, "dv": dv, "dv_nl": dvnl,
                         "us_per_step": ms * 1e3 / n_steps}
    # the path: render_grid at a 32 kHz base rate, whose 64 kHz tremolo
    # state is not in the package data and is settled on the card
    sr32 = 32000.0
    reset_counts(vb, mc)
    g32_ms, g32 = host_ms(lambda: fast.render_grid(
        np.array([[48.0, 55.0, 60.0, 64.0], [60.0, 67.0, 72.0, 76.0]]),
        0.8, 0.5, sr32, device=dev))
    path = "render_grid at 32 kHz (tremolo settled by E3)"
    launches[path] = counts = read_counts(vb, mc)
    check(counts["tremolo_settle"] == 1 and counts["voice_bank"] >= 1
          and counts["mono_chain"] >= 1 and counts["plain"] == 0, counts)
    g = g32.cpu().numpy()
    check(np.isfinite(g).all() and (np.abs(g).max(0) > 1e-3).all(),
          f"render_grid at 32 kHz: finite and audible, peaks "
          f"{np.abs(g).max(0)}")
    e3_us = e3_ms * 1e3 / 512
    e3_ptx = ptxas.get("E3")
    print(f"phase 20 E3 (one warp): 512 steps at 88.2 kHz bit-identical to "
          f"its plain version, kernel {e3_ms:.3f} ms = {e3_us:.3f} us per "
          f"step, plain {e3_plain_ms:.1f} ms; ptxas "
          + (f"{e3_ptx['registers']} registers, {e3_ptx['stack']} bytes "
             f"stack, {e3_ptx['spill_stores']} / {e3_ptx['spill_loads']} "
             "bytes spilled" if e3_ptx else "not in the build log")
          + "; full settles " + ", ".join(
              f"{k}: {v['steps']} steps {v['ms']:.0f} ms = "
              f"{v['us_per_step']:.3f} us per step, {v['dv']:.3g} V "
              f"from the npz" for k, v in full.items())
          + f" (gate {E3_SETTLE_GATE:g} V); render_grid at 32 kHz "
          f"{g.shape[1]} streams x {g.shape[0]} in {g32_ms:.0f} ms "
          f"(settle included), launches {counts} [{card}] "
          f"({time.perf_counter() - t_p:.0f} s)", flush=True)

    # ── phase 21: E1 and E2 against their plain versions, with NaN and inf
    # voice slots, live steal fades, a BE replay and guard #2 ──
    t_p = time.perf_counter()
    eng = Engine(SR, device=dev)
    for k, note in enumerate((41, 48, 55, 60, 64, 67, 72, 79, 84, 93)):
        eng.note_on(note, 0.35 + 0.06 * k)
    eng.note_off(60)
    eng.set_sustain(True)
    eng.note_off(64)
    eng.render(2048)                 # some history for the voices
    for note in range(33, 97):       # fills the bank; steals with fades
        eng.note_on(note, 0.5)
    eng.vst[ek.S_S, 5] = float("nan")
    eng.vst[ek.S_ENV + 2, 9] = float("inf")
    eng.vst[ek.S_S, ek.MAX_VOICES + 7] = float("nan")
    fades = eng.eng_i[ek.MAX_VOICES:ek.SLOTS]
    check(int((fades > 0).sum()) > 0, "phase 21 has live steal fades")
    call = (eng.vpar, eng.vst, eng.vsti, eng.eng_i, 256, eng.fade_len,
            eng.sample_rate)
    e1_cmp = [compare_voices(ek, tuple(x.clone() if torch.is_tensor(x)
                                       else x for x in call),
                             "128 slots x 256, NaN/inf slots, steal fades")]
    mono = ek.render_voices(*call)[:E2_REPLAY_N].contiguous()
    eng.render(4096 - 256)           # a warmed chain
    kick = eng.chain.clone()
    kick[ek.CHAIN_OFF["trem_v"][0]] += 70.0  # tremolo rings: BE replay
    spiked = mono.clone()
    spiked[40] = 30.0                # the power amp past its Newton budget
    e2_cmp = [compare_chain_f64(ek, (eng.params, spiked, kick, True),
                                f"{E2_REPLAY_N} from a warmed state, "
                                "tremolo kicked, input spike")]
    diag = kick.clone()
    ek.render_chain(eng.params, spiked, diag, True)
    a, b = ek.CHAIN_OFF["trem_diag"]
    trem_diag = diag[a:b].tolist()
    check(trem_diag[4] > 0 and trem_diag[1] > 0,
          f"the kick reached the BE replay: tremolo diag {trem_diag}")
    e2_forms = [chain_forms(ek, (eng.params, spiked, kick, True),
                            "kicked chunk")]
    nan_state = eng.chain.clone()
    nan_state[ek.CHAIN_OFF["spk"][0]] = float("nan")
    e2_cmp.append(compare_chain_f64(
        ek, (eng.params, mono, nan_state, True),
        f"{E2_REPLAY_N}, NaN in the speaker state (guard #2)"))
    g2 = nan_state.clone()
    out2 = ek.render_chain(eng.params, mono, g2, True)
    check(float(out2[0]) == 0.0 and torch.isfinite(g2).all().item(),
          "guard #2 fired and reset the chain")
    e2_us = {}
    for sag in (True,):
        st = eng.chain.clone()
        m2 = torch.zeros(2048, dtype=torch.float64, device=dev)
        e2_us["2048 base samples"] = cuda_ms(
            lambda: ek.render_chain(eng.params, m2, st, sag)) * 1e3 / 2048
    e1_us = {n: cuda_ms(lambda: ek.render_voices(
        *[x.clone() for x in call[:4]], n, eng.fade_len, eng.sample_rate),
        reps=2) * 1e3 for n in (256, 2048, 16384)}
    e2_forms.append(chain_forms(ek, (eng.params, mono, nan_state, True),
                                "NaN speaker state (guard #2)"))
    # guard #2 midway: a NaN in mono at sample 4 (the DK preamp resets on
    # each later step), the volume smoother reaching a NaN target at
    # sample 9 (guard #2 fires from there, resetting the warp's rows)
    mid = eng.chain.clone()
    a_vol, _ = ek.CHAIN_OFF["sm_volume"]
    mid[a_vol + 1:a_vol + 4] = torch.tensor([float("nan"), 0.0, 10.0],
                                            dtype=torch.float64, device=dev)
    mid_mono = mono.clone()
    mid_mono[4] = float("nan")
    e2_cmp.append(compare_chain_f64(
        ek, (eng.params, mid_mono, mid, True),
        f"{E2_REPLAY_N}, a NaN in mono at 4, guard #2 from sample 9"))
    g3 = mid.clone()
    out3 = ek.render_chain(eng.params, mid_mono, g3, True)
    check(bool(torch.isfinite(out3).all()) and bool((out3[9:] == 0).all())
          and bool((out3[:9] != 0).any()),
          f"guard #2 fired from sample 9 on, not before: {out3[:12]}")
    e2_forms.append(chain_forms(ek, (eng.params, mid_mono, mid, True),
                                "NaN mono, guard #2 midway"))
    print(f"phase 21 E1 and E2 bit-identical to their plain versions: "
          + "; ".join(f"{c['inputs']} kernel {c['ms']:.3f} ms plain "
                      f"{c['plain_ms']:.0f} ms" for c in e1_cmp + e2_cmp)
          + "; E2's warp and thread forms bit-identical on the three "
          "chunks"
          + f"; tremolo diag after the kick {trem_diag}; E2 "
          f"{e2_us['2048 base samples']:.1f} us per base sample; E1 per "
          f"chunk (us) {e1_us} [{card}] ({time.perf_counter() - t_p:.0f} s)",
          flush=True)

    # ── phase 22: the engine driven through its entry points ──
    t_p = time.perf_counter()
    reset_counts(vb, mc)
    rec = EngineRecorder(ek)
    try:
        eng = Engine(SR, device=dev)
        warm_ms, _ = host_ms(eng.warm_up)
        outs = []
        for n in (60, 64, 67):
            eng.note_on(n, 0.9)
        outs.append(eng.render(4096))
        eng.set_sustain(True)
        eng.note_off(64)
        for note in range(33, 97):
            eng.note_on(note, 0.7)
        eng.note_on(90, 1.0)                     # the 65th: steals
        check(eng.has_steal_voice_for(90), "phase 22 steals a voice")
        outs.append(eng.render(4096))
        eng.note_off(60)
        eng.set_sustain(False)                   # pedal lift
        for note in range(33, 97):
            eng.note_off(note)
        outs.append(eng.render(4096))
        audio = torch.cat(outs).cpu().numpy()
        check(np.isfinite(audio).all() and np.abs(audio).max() > 0,
              "session output finite and sounding")
        pa_diag = eng.power_amp_diag()
        check(all(v == 0 for v in pa_diag.values()),
              f"power_amp_diag {pa_diag}")
        check(eng.nan_guard_fires() == 0, "no NaN guard fired")
        # tests/test_engine.py's peak invariant: the loudest documented
        # chord at volume 1, tremolo depth 1, MLP on; a 1 s render
        inv = Engine(SR, device=dev)
        inv.set_volume(1.0)
        inv.set_tremolo_depth(1.0)
        inv.render(1536)
        for n in (48, 55, 60, 63, 67, 70):
            inv.note_on(n, 0.95)
        n_calls = len(rec.chain)
        sec_ms, sec = host_ms(lambda: inv.render(int(SR)))
        loud = next(c for c in rec.chain[n_calls:] if c[1].shape[-1] == 256)
        sec = sec.cpu().numpy()
        peak = float(np.abs(sec).max())
        check(np.isfinite(sec).all() and 0.15 < peak <= 1.02,
              f"engine peak {peak} at volume 1 (the reference's bounds "
              "0.15 < peak <= 1.0 + 0.02)")
        check(all(v == 0 for v in inv.power_amp_diag().values()),
              f"power_amp_diag {inv.power_amp_diag()}")
        launches["Engine session"] = counts = read_counts(vb, mc)
        check(counts["engine_voices"] > 0
              and counts[chain_kernel(ek, "dk", "circuit", 1)] > 0
              and counts["plain"] == 0, counts)
        # replay the first 256-sample chunk of the 1 s render
        idx = next(i for i, c in enumerate(rec.chain)
                   if c[1].shape[-1] == 256)
        e1_cmp.append(compare_voices(ek, rec.voices[idx],
                                     "Engine session chunk (256)"))
        cp_, mono_, st_, sag_, sc_ = rec.chain[idx]
        e2_cmp.append(compare_chain_f64(
            ek, (cp_, mono_[:E2_REPLAY_N].contiguous(), st_, sag_, sc_),
            f"Engine session chunk (first {E2_REPLAY_N} of 256)"))
    finally:
        rec.restore()
    # the main path's own call in E2's two forms, A B B A: the loud 1 s
    # render's first 256-sample chunk (tools/torch_engine_chunk.py's)
    e2_forms.append(chain_forms(ek, loud, "the 1 s chord's first "
                                "256-sample chunk"))
    abba = e2_forms[-1]
    rtf = 1000.0 / sec_ms
    # the plugin, with events at in-block offsets
    reset_counts(vb, mc)
    plug = host.WurliPlugin(SR, device=dev)
    blocks = [plug.process(512, [host.MidiEvent(100, "note_on", 60, 0.8),
                                 host.MidiEvent(300, "note_on", 64, 0.7)]),
              plug.process(512, [host.MidiEvent(0, "cc", cc=64, value=127),
                                 host.MidiEvent(200, "note_off", 60)]),
              plug.process(512)]
    launches["WurliPlugin.process"] = counts = read_counts(vb, mc)
    pcm = np.concatenate(blocks)
    check(pcm.shape == (1536, 2) and np.isfinite(pcm).all()
          and np.abs(pcm).max() > 0
          and counts[chain_kernel(ek, "dk", "circuit", 1)] >= 4
          and counts["plain"] == 0, f"WurliPlugin {counts}")
    # the transport over it
    reset_counts(vb, mc)
    h = stream_host.StreamHost(SR, block=512, engine="f64", device=dev)
    buf = __import__("io").BytesIO()
    h.serve(['{"cmd": "param", "name": "volume", "value": 0.8}\n',
             json.dumps({"cmd": "events", "events": [
                 {"offset": 10, "kind": "note_on", "note": 57,
                  "velocity": 0.9}]}) + "\n",
             '{"cmd": "render", "blocks": 3}\n', '{"cmd": "quit"}\n'],
            buf, err=__import__("io").StringIO())
    launches["StreamHost(engine='f64')"] = counts = read_counts(vb, mc)
    pcm = np.frombuffer(buf.getvalue(), dtype=np.float32)
    check(pcm.size == 3 * 512 * 2 and np.isfinite(pcm).all()
          and np.abs(pcm).max() > 0
          and counts[chain_kernel(ek, "dk", "circuit", 1)] >= 3
          and counts["plain"] == 0, f"StreamHost f64 {counts}")
    print(f"phase 22 Engine(44100): warm_up {warm_ms / 1e3:.2f} s "
          f"({int(SR * 0.6)} samples), session of 3 x 4096 (chord, 65 "
          f"notes with a steal, pedal lift) then 1 s in "
          f"{sec_ms / 1e3:.2f} s = {rtf:.3f}x realtime, peak {peak:.4f}, "
          f"power_amp_diag all 0; chunk replays bit-identical; E2 on "
          f"the 1 s render's first 256-sample chunk, A B B A: thread "
          f"{abba['thread_ms'][0]:.3f} ms, warp "
          + " / ".join(f"{t:.3f}" for t in abba["warp_ms"])
          + f" ms, thread {abba['thread_ms'][1]:.3f} ms "
          f"({abba['us_per_base_sample']['warp']:.1f} against "
          f"{abba['us_per_base_sample']['thread']:.1f} us per base "
          f"sample); "
          f"WurliPlugin 3 blocks of 512 and StreamHost(engine='f64') 3 "
          f"blocks: launches {counts} [{card}] "
          f"({time.perf_counter() - t_p:.0f} s)", flush=True)
    return {"E1": {"cmp": e1_cmp, "us_per_chunk": e1_us},
            "E2": {"cmp": e2_cmp, "forms": e2_forms,
                   "us_per_base_sample": e2_us,
                   "warm_up_ms": warm_ms, "one_second_ms": sec_ms,
                   "realtime_factor": rtf},
            "E3": {"ms": e3_ms, "plain_ms": e3_plain_ms, "bound": e3_bound,
                   "max_abs_err": e3_err, "full_settle": full,
                   "us_per_step": e3_us}}


# ── the render paths and the engine's other models (phases 23-25) ──

# float64 operations of csrc/engine.cu: one voice's sample in E4 (E1's
# without the gates and the slot sum; its libm calls counted from the
# data, VoiceLibm), one E5<dk> sample's oversampler (four branches of
# three sections)
E4_OPS_SAMPLE = 7 * 14 + 7 * 4 + 12 + 14
E5_OS_OPS = 4 * 3 * 4 + 2


def staggered_voices(cols, g, seed=19):
    """Copies of the first g packed voice columns, each voice at its own
    sample count (every other one mid-onset, the rest up to past 1024),
    every third voice's damper mid-ramp: the voices of one E4 warp then
    differ in their onset, jitter, renorm and damper conditions."""
    from openwurli_tpu_torch import reed
    from openwurli_tpu_torch.kernels import engine as ek

    vpar, vst, vsti = (c[:, :g].clone() for c in cols)
    rng = np.random.default_rng(seed)
    nn = rng.integers(0, 1100, g)
    nn[::2] = rng.integers(0, 60, (g + 1) // 2)
    vsti[ek.I_N] = torch.as_tensor(nn, device=vsti.device)
    rate, mult, ramp, _ = reed.damper_constants(vpar[ek.P_MIDI], SR)
    d = slice(1, None, 3)
    vst[ek.S_DRATE:ek.S_DRATE + 7, d] = rate[d].T
    vst[ek.S_DMULT:ek.S_DMULT + 7, d] = mult[d].T
    vst[ek.S_DRAMP, d] = ramp[d]
    vst[ek.S_DCOUNT, d] = ramp[d] * 0.5
    vsti[ek.I_DACT, d] = 1
    return [vpar, vst, vsti]


def compare_voice_render(kr, cols, n, what):
    """E4 against its plain version on packed voice columns: output and
    end state bit for bit; the plain run gives the libm calls the data
    needed (for the bound). → (numbers, kernel output)."""
    from openwurli_tpu_torch.kernels import engine as ek

    a = [c.clone() for c in cols]
    out = kr.voice_render(*a, n)
    b = [c.clone() for c in cols]
    with VoiceLibm() as libm:
        plain_ms, ref = host_ms(lambda: kr.voice_render_plain(*b, n))
    check(same_bits(out, ref) and all(same_bits(x, y) for x, y in zip(a, b)),
          f"E4 {what}: {first_diff(out, ref)}")
    ms = cuda_ms(lambda: kr.voice_render(*[c.clone() for c in cols], n),
                 reps=3)
    g = cols[0].shape[1]
    n0 = cols[2][ek.I_N]
    jitter = int(((n0 + n + 15) // 16 - (n0 + 15) // 16).sum())  # nn % 16 == 0
    n_bytes = (cols[0].numel() + 2 * (cols[1].numel() + cols[2].numel())
               + n * g) * 8
    ops = n * g * E4_OPS_SAMPLE + jitter * E1_OPS_JITTER \
        + libm.calls * LIBM_OPS
    return {"shape": f"{g} voices x {n}", "inputs": f"E4 {what}",
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops),
            "libm_calls": libm.calls,
            "max_abs_err": float((out - ref).abs().nan_to_num().max())}, out


def compare_preamp_scan(kr, kind, sr, x, state, g_ldr, what, scale=None):
    """E5<kind> against its plain version on one scan's inputs: output and
    state bit for bit; the plain run's Newton counts, each stream's own,
    give the operations the data needed (for the bound). → (numbers,
    kernel output)."""
    from openwurli_tpu_torch.circuits import dk_preamp, melange_preamp

    a, b = state.clone(), state.clone()
    out = kr.preamp_scan(kind, sr, x, a, g_ldr, scale)
    passes0 = dk_preamp.NEWTON_PASSES[0]
    mel0 = dict(melange_preamp.NEWTON_COUNTS)
    plain_ms, ref = host_ms(lambda: kr.preamp_scan_plain(kind, sr, x, b,
                                                         g_ldr, scale))
    passes = dk_preamp.NEWTON_PASSES[0] - passes0
    mel = {k: melange_preamp.NEWTON_COUNTS[k] - mel0[k] for k in mel0}
    check(same_bits(out, ref) and same_bits(a, b),
          f"E5<{kind}> {what}: {first_diff(out, ref)}, state "
          f"{first_diff(a, b)}")
    ms = cuda_ms(lambda: kr.preamp_scan(kind, sr, x, state.clone(), g_ldr,
                                        scale), reps=3)
    n, g = x.shape
    n_bytes = (2 * x.numel() + 2 * state.numel() + g_ldr.numel()
               + (0 if scale is None else scale.numel())
               + kr.preamp_consts(kind, float(sr)).size) * 8
    if kind == "dk":
        ops = (n * g * (E5_OS_OPS + 2 * PREAMP_OPS_STEP)
               + passes * PREAMP_OPS_PASS)
        newton = {"stream_passes": passes}
    else:
        ops = melange_ops(mel)
        newton = mel
    return {"shape": f"{g} streams x {n}", "inputs": f"E5<{kind}> {what}",
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops),
            "newton": newton,
            "max_abs_err": float((out - ref).abs().nan_to_num().max())}, out


def zero_cross_hz(x, sr):
    """f0 from the rising zero crossings of x (mean removed), each placed
    by linear interpolation between its two samples."""
    x = x - x.mean()
    i = np.flatnonzero((x[:-1] < 0.0) & (x[1:] >= 0.0))
    t = i + x[i] / (x[i] - x[i + 1])
    return (len(t) - 1) / ((t[-1] - t[0]) / sr)


def model_phases(dev, card, launches, vb, mc, ptxas):
    """Phases 23-25: E4, E5 and E2's other instantiations against their
    plain versions; the DI path at the calibration grid's full width; the
    melange preamp's physics gates through E5<melange>, and the melange
    plugin. Adds its paths' launch counts to `launches`; → the kernels'
    measurements."""
    from openwurli_tpu_torch import di, host, voice
    from openwurli_tpu_torch.circuits import dk_preamp, melange_preamp
    from openwurli_tpu_torch.engine import Engine
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    # ── phase 23: the kernels against their plain versions, bit for bit ──
    t_p = time.perf_counter()
    g_v = 133
    rng = np.random.default_rng(23)
    m = rng.integers(33, 97, g_v).astype(np.float64)
    v = rng.uniform(0.05, 1.0, g_v)
    vp, det = voice.note_on_params(m, v, SR, mlp_enabled=True)
    vs = voice.init_state(vp, det, v, SR, voice.default_note_seed(m))
    cols = kr.voice_columns(vp, vs, dev)
    cols[0][ek.P_AMP + 2, 7] = float("nan")
    cols[1][ek.S_C, 50] = float("inf")
    n4 = 1100
    e4, out4 = compare_voice_render(kr, cols, n4,
                                    f"{g_v} ragged voices, NaN and inf")
    # eight threads per voice, four voices per warp: one voice, a partial
    # warp, partial blocks, the voices at their own sample counts
    e4_geo = [compare_voice_render(
        kr, staggered_voices(cols, g), 300,
        f"{g} staggered voice(s)" + (", NaN and inf" if g > 50 else ""))[0]
        for g in (1, 5, 33, 133)]

    n5 = 600
    x5 = out4[:n5].clone()
    x5[100:, 9] = float("inf")
    os_sr = 2 * SR
    g5 = torch.full((g_v,), 1e-6, dtype=torch.float64, device=dev)
    g5[::5] = 1.0 / 19_000.0
    e5dk, _ = compare_preamp_scan(
        kr, "dk", os_sr, x5, kr.init_dk_state(os_sr, g_v, dev), g5,
        f"{g_v} ragged streams, NaN and inf voices, two g")
    # a warp per stream, four to a block: one stream, fewer streams than a
    # block's warps, a partial last block (133 above and 512 in phase 24
    # are partial and whole), each with the inf stream
    e5dk_geo = []
    for g in (1, 5, 33):
        xg = x5[:200, :g].clone()
        xg[100:, g - 1] = float("inf")
        e5dk_geo.append(compare_preamp_scan(
            kr, "dk", os_sr, xg, kr.init_dk_state(os_sr, g, dev),
            g5[:g].contiguous(), f"{g} stream(s), an inf stream")[0])

    sr_m = 88200.0
    t = torch.arange(160, dtype=torch.float64, device=dev)
    xm = 0.002 * torch.sin(t[:, None] * torch.tensor(
        [0.01, 0.05, 0.03, 0.07, 0.02, 0.04], dtype=torch.float64,
        device=dev))
    xm[40, 5] = float("nan")
    gm = torch.tensor([1e-6, 1e-5, 1.0 / 19e3, 1e-6, 1e-5, 1.0 / 19e3],
                      dtype=torch.float64, device=dev)
    scm = torch.tensor([0.0, 1.0, 30.0, 30.0, 1.0, 0.0], dtype=torch.float64,
                       device=dev)
    e5mel, _ = compare_preamp_scan(
        kr, "melange", sr_m, xm, kr.init_melange_state(sr_m, 6, dev), gm,
        "noise scales 0, 1 and 30, a NaN input", scm)

    # E2's new instantiations on one 64-sample chunk each, from a warmed
    # chain, with the tremolo kicked (its BE replay) and an input spike
    e2_cmp, beh_forms = [], []
    for models in (("melange", "circuit"), ("dk", "behavioral"),
                   ("melange", "behavioral")):
        eng = Engine(SR, device=dev, preamp_model=models[0],
                     pa_model=models[1])
        for k, note in enumerate((48, 55, 60, 64, 67, 72, 93)):
            eng.note_on(note, 0.4 + 0.08 * k)
        eng.render(512)
        mono = ek.render_voices(eng.vpar, eng.vst, eng.vsti, eng.eng_i, 64,
                                eng.fade_len, eng.sample_rate).clone()
        kick = eng.chain.clone()
        kick[ek.CHAIN_OFF["trem_v"][0]] += 70.0
        clean = mono.clone()
        mono[40] = 30.0
        e2_cmp.append(compare_chain_f64(
            ek, (eng.params, mono, kick, True, 30.0),
            f"<{models[0]}, {models[1]}> 64 from a warmed state, tremolo "
            "kicked, input spike, noise scale 30"))
        if models[1] == "behavioral":
            # the behavioral warp form against the plain version and the
            # thread form: kicked; a NaN in mono at 4 and guard #2 from 9
            # (its power-amp rows, moved off rest, reset by the guard)
            tag = f"<{models[0]}, behavioral>"
            beh_forms.append(chain_forms(
                ek, (eng.params, mono, kick, True, 30.0),
                f"{tag} kicked, noise scale 30"))
            mid = eng.chain.clone()
            a_vol, _ = ek.CHAIN_OFF["sm_volume"]
            mid[a_vol + 1:a_vol + 4] = torch.tensor(
                [float("nan"), 0.0, 10.0], dtype=torch.float64, device=dev)
            lo, hi = ek.CHAIN_OFF["pa_v"][0], ek.CHAIN_OFF["pa_last"][1]
            rest = mid[lo:hi].clone()
            mid[lo:hi] += 1.0
            clean[4] = float("nan")
            call = (eng.params, clean, mid, True, 30.0)
            e2_cmp.append(compare_chain_f64(
                ek, call, f"{tag} 64, a NaN in mono at 4, guard #2 from "
                "sample 9, noise scale 30"))
            g3 = mid.clone()
            out3 = ek.render_chain(*call[:2], g3, *call[3:])
            check(bool((out3[9:] == 0).all()) and same_bits(g3[lo:hi], rest),
                  f"{tag}: guard #2 from sample 9 reset the power-amp rows")
            beh_forms.append(chain_forms(
                ek, call, f"{tag} NaN mono, guard #2 midway"))
    names = ("E1", "E1 thread", "E3", "E4", "E4<tap>", "E5<dk>",
             "E5<melange>", "E6",
             *(f"E2<{p}, {a}> {f}" for p in ("dk", "melange")
               for a in ("circuit", "behavioral")
               for f in ("warp", "thread")))
    print("phase 23 ptxas: " + "; ".join(
        f"{k} {ptxas[k]['registers']} registers, {ptxas[k]['stack']} bytes "
        f"stack, {ptxas[k]['spill_stores']} / {ptxas[k]['spill_loads']} "
        f"bytes spilled" for k in names if k in ptxas), flush=True)
    for k in ("E1", "E1 thread", "E3", "E4", "E4<tap>"):
        if k in ptxas:
            check(ptxas[k]["spill_stores"] == 0, f"{k} spills: {ptxas[k]}")
    print("phase 23 bit-identical to their plain versions: "
          + "; ".join(f"{c['inputs']} {c['shape']} kernel {c['ms']:.3f} ms "
                      f"plain {c['plain_ms']:.0f} ms"
                      for c in (e4, *e4_geo, e5dk, *e5dk_geo, e5mel)) + "; "
          + "; ".join(f"E2{c['models']} kernel {c['ms']:.3f} ms plain "
                      f"{c['plain_ms']:.0f} ms" for c in e2_cmp)
          + "; the behavioral warp and thread forms bit-identical, A B B "
          "A: " + "; ".join(
              f"{f['inputs']} thread {f['thread_ms'][0]:.3f}, warp "
              + " / ".join(f"{t:.3f}" for t in f["warp_ms"])
              + f", thread {f['thread_ms'][1]:.3f} ms" for f in beh_forms)
          + f" [{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)

    # ── phase 24: the DI path at the calibration grid's full width ──
    t_p = time.perf_counter()
    midis = np.arange(33, 97, dtype=np.float64)
    vels = (np.arange(8) + 0.5) / 8
    mg, vg = (a.ravel() for a in np.meshgrid(midis, vels, indexing="ij"))
    dur = 2.0
    reset_counts(vb, mc)
    di_ms, grid = host_ms(lambda: di.render_di(mg, vg, dur, SR,
                                               mlp_enabled=False,
                                               device=dev))
    launches["render_di 512 voices x 2 s"] = counts = read_counts(vb, mc)
    check(counts["voice_render"] == 1 and counts["preamp_scan_dk"] == 1
          and counts["plain"] == 0, f"render_di launches {counts}")
    n = int(dur * SR)
    check(grid.shape == (n, 512) and np.isfinite(grid).all(),
          f"render_di grid {grid.shape} finite")
    col69 = int(np.flatnonzero((mg == 69.0) & (vg == vels[-1]))[0])
    f0 = zero_cross_hz(grid[int(0.5 * SR):, col69], SR)
    cents = 1200 * np.log2(f0 / 440.0)
    check(abs(cents) < 1.0, f"note 69 f0 {f0:.4f} Hz, {cents:.3f} cents")
    # the stages, timed apart: note-on and packing on the host, E4, E5
    pack_ms, packed = host_ms(lambda: kr.voice_columns(*(
        lambda pd: (pd[0], voice.init_state(
            pd[0], pd[1], vg, SR, voice.default_note_seed(mg))))(
                voice.note_on_params(mg, vg, SR, mlp_enabled=False)), dev))
    cols = [c.clone() for c in packed]
    e4_grid_ms, audio = host_ms(lambda: kr.voice_render(*packed, n))
    st_g = kr.init_dk_state(2 * SR, 512, dev)
    g_g = torch.full((512,), 1e-6, dtype=torch.float64, device=dev)
    e5_grid_ms, _ = host_ms(lambda: kr.preamp_scan("dk", 2 * SR, audio,
                                                   st_g.clone(), g_g))
    di_stages = {"host packing": pack_ms, "E4": e4_grid_ms,
                 "E5<dk>": e5_grid_ms}
    # both kernels against their plain versions on these inputs, all 512
    # columns over the first n_p samples, and render_di's own output
    # prefix against the plain chain's
    n_p = 1000
    e4_main, a_p = compare_voice_render(
        kr, cols, n_p, f"render_di's 512 voices, first {n_p}")
    e5_main, y_p = compare_preamp_scan(
        kr, "dk", 2 * SR, a_p, st_g, g_g,
        f"render_di's 512 streams, first {n_p}")
    check(same_bits(a_p, audio[:n_p]) and same_bits(
        y_p, torch.from_numpy(grid[:n_p]).to(dev)),
          "render_di's first samples differ from the plain chain's")
    print(f"phase 24 render_di 64 notes x 8 velocities x {dur} s at "
          f"{SR:g} Hz (512 x {n}, {grid.nbytes / 1e6:.0f} MB): "
          f"{di_ms / 1e3:.2f} s = {512 * dur / (di_ms / 1e3):.1f} voice "
          f"seconds per second; stages (ms) {di_stages}; E5<dk> "
          f"{e5_grid_ms * 1e3 / (2 * n):.3f} us per DK step (two per "
          f"sample, a warp per stream); finite; note 69 f0 "
          f"{f0:.4f} Hz ({cents:+.3f} cents); launches {counts}; its first "
          f"{n_p} samples bit-identical to the plain chain's (E4 kernel "
          f"{e4_main['ms']:.3f} ms plain {e4_main['plain_ms']:.0f} ms, E5<dk> "
          f"kernel {e5_main['ms']:.3f} ms plain {e5_main['plain_ms']:.0f} ms)"
          f" [{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)
    del grid, audio

    # ── phase 25: the melange preamp's physics gates through E5<melange>
    # at 88.2 kHz (tests/test_melange_preamp.py at full length), then the
    # melange plugin ──
    t_p = time.perf_counter()
    n_s = int(sr_m * 1.2)
    tt = torch.arange(n_s, dtype=torch.float64, device=dev) / sr_m
    sine = 0.001 * torch.sin(2 * np.pi * 1000.0 * tt)
    zero = torch.zeros_like(sine)
    # streams: sine at 1 MΩ, 19 kΩ and 12 kΩ (no noise); silence at
    # 100 kΩ (noise 1x), at 1 MΩ (noise 1x and 4x)
    xs = torch.stack([sine, sine, sine, zero, zero, zero], dim=1)
    r = [1e6, 19e3, 12e3, 1e5, 1e6, 1e6]
    gs = torch.tensor([1.0 / max(x, 1000.0) for x in r], dtype=torch.float64,
                      device=dev)
    sc = torch.tensor([0.0, 0.0, 0.0, 1.0, 1.0, 4.0], dtype=torch.float64,
                      device=dev)
    reset_counts(vb, mc)
    gate_ms, ym = host_ms(lambda: kr.preamp_scan(
        "melange", sr_m, xs, kr.init_melange_state(sr_m, 6, dev), gs, sc))
    ym = ym.cpu().numpy()

    def gain(y, settle=1.0):
        seg = y[int(sr_m * settle):]
        return (seg.max() - seg.min()) / 2 / 0.001

    def rms(y):
        return float(np.sqrt(((y - y.mean()) ** 2).mean()))

    g_mel = {r_: 20 * np.log10(gain(ym[:, k])) for k, r_ in
             ((0, 1e6), (1, 19e3), (2, 12e3))}
    n1 = int(sr_m * 1.0)
    noise_rms = rms(ym[n1 // 3:n1, 3])
    n02 = int(sr_m * 0.2)
    ratio = rms(ym[n02 // 2:n02, 5]) / rms(ym[n02 // 2:n02, 4])
    # the DK preamp's gain at the same points: E5<dk>'s steps run at twice
    # its 44.1 kHz input's rate, the allpass flat at 1 kHz
    n_dk = int(SR * 1.2)
    tdk = torch.arange(n_dk, dtype=torch.float64, device=dev) / SR
    sdk = (0.001 * torch.sin(2 * np.pi * 1000.0 * tdk))[:, None].repeat(
        1, 2).contiguous()
    ydk = kr.preamp_scan("dk", sr_m, sdk, kr.init_dk_state(sr_m, 2, dev),
                         torch.tensor([1e-6, 1.0 / 19e3], dtype=torch.float64,
                                      device=dev)).cpu().numpy()
    launches["melange physics gates (E5 scans)"] = counts = read_counts(vb,
                                                                        mc)
    g_dk = {1e6: 20 * np.log10((ydk[int(SR):, 0].max()
                                - ydk[int(SR):, 0].min()) / 2 / 0.001),
            19e3: 20 * np.log10((ydk[int(SR):, 1].max()
                                 - ydk[int(SR):, 1].min()) / 2 / 0.001)}
    check(8.08e-6 * 0.65 < noise_rms < 8.08e-6 * 1.35,
          f"melange noise RMS {noise_rms:.4g} V at 100 kΩ (8.08 µV ± 35 %)")
    check(3.0 < ratio < 5.3, f"noise gain 4x → RMS ratio {ratio:.3f}")
    for r_ in (1e6, 19e3):
        check(abs(g_mel[r_] - g_dk[r_]) < 2.0,
              f"gain at {r_:g} Ω: melange {g_mel[r_]:.2f} dB, DK "
              f"{g_dk[r_]:.2f} dB")
    check(g_mel[19e3] > g_mel[1e6] + 20 * np.log10(1.2),
          "gain rises with the tremolo")
    check(abs(g_mel[12e3] - 15.0) < 2.5, f"12 kΩ gain {g_mel[12e3]:.2f} dB "
          "vs the ngspice deck's 15 dB")
    print(f"phase 25 melange gates through E5<melange> (6 streams x {n_s} "
          f"at 88.2 kHz, {gate_ms / 1e3:.2f} s): noise RMS at 100 kΩ "
          f"{noise_rms * 1e6:.3f} µV (ngspice 8.08 µV ± 35 %), noise 4x "
          f"ratio {ratio:.3f} (3.0-5.3), gain dB melange / DK: 1 MΩ "
          f"{g_mel[1e6]:.2f} / {g_dk[1e6]:.2f}, 19 kΩ {g_mel[19e3]:.2f} / "
          f"{g_dk[19e3]:.2f}, 12 kΩ {g_mel[12e3]:.2f} (deck 15 ± 2.5); "
          f"launches {counts} [{card}]", flush=True)

    # the melange plugin with authentic noise, and the behavioral power
    # amp's two instantiations through Engine sessions
    rec = EngineRecorder(ek)
    try:
        reset_counts(vb, mc)
        plug = host.WurliPlugin(SR, preamp_model="melange", device=dev)
        plug.params.authentic_noise = True
        plug.params.volume = 1.0
        plug.params.tremolo_depth = 1.0
        warm_ms, _ = host_ms(plug.engine.warm_up)
        plug.process(1536)
        ev = [host.MidiEvent(0, "note_on", n_, 0.95)
              for n_ in (48, 55, 60, 63, 67, 70)]
        sec_ms, sec = host_ms(lambda: plug.process(int(SR), ev))
        peak = float(np.abs(sec).max())
        check(np.isfinite(sec).all() and 0.15 < peak <= 1.0,
              f"melange plugin peak {peak} at volume 1 (0.15 < peak <= 1)")
        check(plug.engine.noise_enabled and plug.engine.nan_guard_fires() == 0
              and all(v_ == 0 for v_ in plug.engine.power_amp_diag()
                      .values()), "melange plugin: noise on, no guard, "
              f"power_amp_diag {plug.engine.power_amp_diag()}")
        launches["WurliPlugin(preamp_model='melange')"] = counts = \
            read_counts(vb, mc)
        check(counts[chain_kernel(ek, "melange", "circuit", 1)] > 0
              and counts["plain"] == 0, f"melange plugin {counts}")
        # replay the first 256 samples of the last 2048-sample chunk of
        # the 1 s render (the chord sounding)
        idx = max(i for i, c in enumerate(rec.chain)
                  if c[1].shape[0] == 2048)
        cp_, mono_, st_, sag_, sc_ = rec.chain[idx]
        e2_cmp.append(compare_chain_f64(
            ek, (cp_, mono_[:E2_REPLAY_N].contiguous(), st_, sag_, sc_),
            f"<melange, circuit> melange plugin chunk (first "
            f"{E2_REPLAY_N})"))
        mel_forms = chain_forms(
            ek, (cp_, mono_[:E2_REPLAY_N].contiguous(), st_, sag_, sc_),
            f"<melange, circuit> melange plugin chunk (first "
            f"{E2_REPLAY_N})")
        beh = {}
        for models in (("dk", "behavioral"), ("melange", "behavioral")):
            reset_counts(vb, mc)
            eng = Engine(SR, device=dev, preamp_model=models[0],
                         pa_model=models[1])
            for n_ in (48, 55, 60, 63, 67, 70):
                eng.note_on(n_, 0.95)
            eng.set_noise_enabled(True)
            b_ms, out = host_ms(lambda: eng.render(4096))
            out = out.cpu().numpy()
            check(np.isfinite(out).all() and np.abs(out).max() > 0,
                  f"Engine{models} finite and sounding")
            key = f"Engine(preamp_model='{models[0]}', pa_model='behavioral')"
            launches[key] = counts = read_counts(vb, mc)
            name = chain_kernel(ek, *models, 1)
            check(counts[name] > 0 and counts["plain"] == 0, counts)
            beh[key] = {"ms_4096": b_ms, "peak": float(np.abs(out).max())}
            # the session's first chunk (256 samples of it) in E2's two
            # forms, A B B A
            cp_, mono_, st_, sag_, sc_ = next(
                c for c in rec.chain if c[0].pa_model == "behavioral"
                and c[0].preamp_model == models[0])
            beh[key]["forms"] = chain_forms(
                ek, (cp_, mono_[:256].contiguous(), st_, sag_, sc_),
                f"<{models[0]}, behavioral> session chunk (first 256)")
    finally:
        rec.restore()
    rtf = 1000.0 / sec_ms
    print(f"phase 25 WurliPlugin(44100, preamp_model='melange') with "
          f"authentic noise: warm_up {warm_ms / 1e3:.2f} s ({int(SR * 0.6)} "
          f"samples), the chord's 1 s block in {sec_ms / 1e3:.2f} s = "
          f"{rtf:.3f}x realtime, peak {peak:.4f}; chunk replay "
          f"bit-identical; E2's two forms bit-identical on it, "
          f"A B B A: thread {mel_forms['thread_ms'][0]:.3f}, warp "
          + " / ".join(f"{t:.3f}" for t in mel_forms["warp_ms"])
          + f", thread {mel_forms['thread_ms'][1]:.3f} ms; behavioral "
          f"sessions (4096 samples): "
          + ", ".join(f"{k} {v['ms_4096']:.0f} ms peak {v['peak']:.4f}, "
                      f"its first 256 samples in E2's two forms "
                      f"bit-identical, A B B A: {abba_line(v['forms'])}"
                      for k, v in beh.items())
          + f" [{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)
    return {"E4": {**e4_main, "compared": [e4_main, e4, *e4_geo],
                   "us_per_sample": e4_grid_ms * 1e3 / n,
                   "main_path_ms": {"render_di 512 x 88200": e4_grid_ms}},
            "E5<dk>": {**e5_main, "compared": [e5_main, e5dk, *e5dk_geo],
                       "us_per_dk_step": e5_grid_ms * 1e3 / (2 * n),
                       "main_path_ms": {"render_di 512 x 88200":
                                        e5_grid_ms}},
            "E5<melange>": {**e5mel, "main_path_ms": {
                f"physics gates 6 x {n_s}": gate_ms}},
            "E2": e2_cmp, "di_stages_ms": di_stages, "di_ms": di_ms,
            "melange_plugin": {"warm_up_ms": warm_ms, "one_second_ms": sec_ms,
                               "realtime_factor": rtf, "peak": peak},
            "melange_forms": mel_forms,
            "behavioral": beh, "behavioral_forms": beh_forms}


# ── the calibration pipeline (phase 26) ──

# float64 operations of csrc/engine.cu: one E4<tap> sample (E4's without
# the attack noise's biquad; libm calls counted from the data,
# VoiceLibm); one E6 sample outside the power amp's Newton solves (volume²,
# the sources and the two-tier guard, the rails, the speaker with its tanh,
# the post-speaker gain), its one speaker design per stream
E4_TAP_OPS_SAMPLE = 7 * 14 + 7 * 4 + 14
E6_OPS_SAMPLE = 2 + 21 + 40 + 25 + LIBM_OPS + 1
# BASELINE.json config 4: all 64 keys (MIDI 33-96) × 8 velocities, the
# calibrate CLI's defaults 40, 80 and 127 among them
CALIB_NOTES = tuple(range(33, 97))
CALIB_VELOCITIES = (1, 20, 40, 60, 80, 100, 120, 127)
# the golden alias-audit baseline and the Rust reference's own values
# (tests/test_alias_audit_regression.py)
ALIAS_BASELINE = "tests/baselines/alias_audit_v0_1_0.json"
ALIAS_STEP_UP_TOL_DB, ALIAS_HF_TOL_DB = 1.5, 2.0
ALIAS_RUST = {72: (7.951, -52.647), 84: (8.183, -47.809),
              91: (6.862, -39.164)}
ALIAS_RUST_HF_TOL_DB = 8.0
# the onset extractors on tests/test_onset_model.py's 4-note fixture
# mixture, as the JAX package scores them on a CPU: the spectral path 1
# hit and 6 spurious; the network finds nothing, the shipped weights
# lacking the format-3 tag (both packages' load_params() return None)
ONSET_EVENTS = ((0.4, 48, 0.0), (1.6, 67, -6.0), (2.9, 48, -12.0),
                (4.1, 67, 0.0))
ONSET_SPECTRAL_REF = (1, 6)
# The alias sweep shrinks to note 84 when it would end past SCRIPT_LIMIT_S
# (the script must end within 1200 s); a note takes ALIAS_NOTE_S (7.2-7.9 s
# measured on an NVIDIA H100 80GB HBM3 at 700 W with E2 a warp per engine,
# 45-49 s with a thread: 67686 loud samples through E2).
SCRIPT_LIMIT_S = 1000.0
ALIAS_NOTE_S = 12.0
T_START = time.perf_counter()


def compare_voice_tap(kr, cols, n, what):
    """E4<tap> against its plain version on packed columns: both outputs
    and the end state bit for bit; the plain run's libm calls give the
    bound. → (numbers, kernel outputs)."""
    from openwurli_tpu_torch.kernels import engine as ek

    a = [c.clone() for c in cols]
    out, reed = kr.voice_tap(*a, n)
    b = [c.clone() for c in cols]
    with VoiceLibm() as libm:
        plain_ms, (ref, ref_reed) = host_ms(
            lambda: kr.voice_tap_plain(*b, n))
    check(same_bits(out, ref) and same_bits(reed, ref_reed)
          and all(same_bits(x, y) for x, y in zip(a, b)),
          f"E4<tap> {what}: {first_diff(out, ref)}, reed "
          f"{first_diff(reed, ref_reed)}")
    ms = cuda_ms(lambda: kr.voice_tap(*[c.clone() for c in cols], n),
                 reps=3)
    g = cols[0].shape[1]
    n0 = cols[2][ek.I_N]
    jitter = int(((n0 + n + 15) // 16 - (n0 + 15) // 16).sum())
    n_bytes = (cols[0].numel() + 2 * (cols[1].numel() + cols[2].numel())
               + 2 * n * g) * 8
    ops = n * g * E4_TAP_OPS_SAMPLE + jitter * E1_OPS_JITTER \
        + libm.calls * LIBM_OPS
    err = max(float((out - ref).abs().nan_to_num().max()),
              float((reed - ref_reed).abs().nan_to_num().max()))
    return {"shape": f"{g} streams x {n}", "inputs": f"E4<tap> {what}",
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops),
            "libm_calls": libm.calls, "max_abs_err": err}, (out, reed)


def compare_pa_speaker(kr, x, state, volume, character, what):
    """E6 against its plain version on one scan's inputs: output and state
    bit for bit; the plain run's power-amp Newton counts, each stream's
    own, give the bound. → numbers."""
    from openwurli_tpu_torch.circuits import mna
    from openwurli_tpu_torch.kernels import engine as ek

    sr = 44100.0
    a, b = state.clone(), state.clone()
    out = kr.pa_speaker_scan(sr, x, a, volume, character)
    n0 = dict(mna.NEWTON_COUNTS)
    plain_ms, ref = host_ms(lambda: kr.pa_speaker_scan_plain(
        sr, x, b, volume, character))
    count = {k: mna.NEWTON_COUNTS[k] - n0.get(k, 0)
             for k in mna.NEWTON_COUNTS}
    check(same_bits(out, ref) and same_bits(a, b),
          f"E6 {what}: {first_diff(out, ref)}, state {first_diff(a, b)}")
    ms = cuda_ms(lambda: kr.pa_speaker_scan(sr, x, state.clone(), volume,
                                            character), reps=2)
    n, g = x.shape
    n_bytes = (2 * x.numel() + 2 * state.numel()
               + kr.pa_speaker_consts(sr).size) * 8
    solves = count.get((16, "solves"), 0)
    iters = count.get((16, "iterations"), 0)
    ops = (n * g * E6_OPS_SAMPLE + g * E2_OPS_DESIGN
           + mna_ops(ek.N_PA, ek.M_PA, ek.NB_PA, solves, iters))
    return {"shape": f"{g} streams x {n}", "inputs": f"E6 {what}",
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops),
            "newton": {"power_amp": [solves, iters]},
            "us_per_sample": ms * 1e3 / n,
            "max_abs_err": float((out - ref).abs().nan_to_num().max())}


def pa_step_forms(kr, x, state, volume, character):
    """E6 and E9 (both the warp step, power_amp_step_warp; E9 without
    volume² and the speaker) on the same input x · volume · volume from the
    same power-amp rows leave the same rows bit for bit; timed E9, E6, E6,
    E9 (CUDA events). → ms."""
    from openwurli_tpu_torch.kernels import engine as ek

    sr = 44100.0
    x9 = x * volume * volume  # the kernel's own product, in its order
    a = state.clone()
    kr.pa_speaker_scan(sr, x, a, volume, character)
    b = state[:ek.PA_ROWS].clone()
    ek.power_amp_scan(sr, x9, b)
    check(same_bits(a[:ek.PA_ROWS], b),
          f"E6's power-amp rows against E9's: {first_diff(a[:ek.PA_ROWS], b)}")
    e9 = lambda: ek.power_amp_scan(sr, x9, state[:ek.PA_ROWS].clone())
    e6 = lambda: kr.pa_speaker_scan(sr, x, state.clone(), volume, character)
    times = [cuda_ms(f) for f in (e9, e6, e6, e9)]
    return {"e9_ms": [times[0], times[3]], "e6_ms": [times[1], times[2]]}


def fixture_mixture():
    """tests/test_onset_model.py:100-118: the fixture's two clips at four
    staggered onsets and gains, with seeded noise → (audio, sr)."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(repo, "tests", "baselines",
                              "onset_test_clips.npz")) as z:
        clips = {48: z["note48"], 67: z["note67"]}
        sr_f = float(z["sr"])
    mix = np.zeros(int(6.0 * sr_f))
    for onset_s, midi, gain_db in ONSET_EVENTS:
        seg = clips[midi].astype(np.float64).copy()
        n_f = int(0.05 * sr_f)
        seg[-n_f:] *= np.linspace(1.0, 0.0, n_f)
        i0 = int(onset_s * sr_f)
        k = min(len(seg), len(mix) - i0)
        mix[i0:i0 + k] += 10.0 ** (gain_db / 20.0) * seg[:k]
    mix += 1e-5 * np.random.default_rng(0).normal(size=len(mix))
    return mix, sr_f


def fixture_scores(weights_path, device="cuda"):
    """The fixture mixture scored as tests/test_onset_model.py scores it:
    {"network": (hits of 4, spurious) of the format-3 weights at
    weights_path, "spectral": the spectral path's, "wins": the JAX test's
    nn_h >= max(sp_h, 4) and nn_fp <= sp_fp}.

        python3 -c "import chip_smoke as c; print(c.fixture_scores(PATH))"
    """
    from openwurli_tpu_torch.calib import notes, onset_model

    params = onset_model.load_params(weights_path)
    check(params is not None, f"{weights_path}: no format-3 weights")
    mix, sr_f = fixture_mixture()
    nn = onset_score(onset_model.nn_extract_notes(
        mix, sr_f, params=params, min_duration=0.15, device=device))
    spectral = onset_score(notes.extract_notes(
        mix, sr_f, min_duration=0.15, method="spectral", device=device))
    return {"network": nn, "spectral": spectral,
            "wins": nn[0] >= max(spectral[0], 4) and nn[1] <= spectral[1]}


def onset_score(found):
    """(hits, spurious) as tests/test_onset_model.py scores them."""
    used, hits = set(), 0
    for onset_s, midi, _ in ONSET_EVENTS:
        ok = [i for i, f in enumerate(found)
              if i not in used and abs(f["onset_s"] - onset_s) < 0.1
              and abs(f["midi_note"] - midi) <= 1]
        if ok:
            used.add(ok[0])
            hits += 1
    return hits, len(found) - len(used)


def calib_phases(dev, card, launches, vb, mc):
    """Phase 26: the calibration pipeline. E4<tap> and E6 against their
    plain versions; run_calibrate at BASELINE config 4, timed by stage;
    the pipeline's stages 1-6 through `main` (BASELINE config 5); the
    onset extractors on the fixture mixture. Adds its paths' launch counts
    to `launches`; → the kernels' measurements."""
    import contextlib
    import io
    import os
    import re
    import shutil

    from openwurli_tpu_torch import di, tables, voice
    from openwurli_tpu_torch.calib import (alias_audit, calibrate, notes,
                                           onset_model, pipeline)
    from openwurli_tpu_torch.io import wav
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    repo = os.path.dirname(os.path.abspath(__file__))
    t_p = time.perf_counter()
    # ── run_calibrate at config 4, its calls recorded (inputs cloned) ──
    rec = {}
    timer = StageTimer()
    timer.wrap(calibrate, "pack_taps", "host packing")
    timer.wrap(kr, "voice_tap", "E4<tap>")
    timer.wrap(kr, "preamp_scan", "E5<dk>")
    timer.wrap(kr, "pa_speaker_scan", "E6")
    tap_fn, e6_fn = kr.voice_tap, kr.pa_speaker_scan

    def tap_rec(*cols_n):
        rec["tap"] = [c.clone() for c in cols_n[:3]]
        return tap_fn(*cols_n)

    def e6_rec(sr, x, state, volume, character):
        rec["e6"] = (x, state.clone(), volume, character)
        return e6_fn(sr, x, state, volume, character)

    kr.voice_tap, kr.pa_speaker_scan = tap_rec, e6_rec
    reset_counts(vb, mc)
    try:
        cal_ms, rows = host_ms(lambda: calibrate.run_calibrate(
            CALIB_NOTES, CALIB_VELOCITIES, device=dev))
    finally:
        kr.voice_tap, kr.pa_speaker_scan = tap_fn, e6_fn
        timer.restore()
    launches["run_calibrate 64 x 8 x 0.5 s"] = counts = read_counts(vb, mc)
    check(counts["voice_render_tap"] == 1 and counts["preamp_scan_dk"] == 1
          and counts["pa_speaker_scan"] == 1 and counts["plain"] == 0,
          f"run_calibrate launches {counts}")
    grid = (len(CALIB_NOTES), len(CALIB_VELOCITIES))
    for k, v in rows.items():
        check(v.shape == grid and np.isfinite(v).all(),
              f"run_calibrate column {k}: shape {v.shape}, finite")
    stages = dict(timer.ms)
    stages["metrics and glue"] = cal_ms - sum(stages.values())
    i60 = CALIB_NOTES.index(60)
    shown = [CALIB_VELOCITIES.index(v) for v in (40, 80, 127)]
    print(f"phase 26 run_calibrate {grid[0]} notes x {grid[1]} velocities "
          f"x {calibrate.DURATION_S} s ({grid[0] * grid[1]} streams x "
          f"{int(calibrate.DURATION_S * calibrate.BASE_SR)}): "
          f"{cal_ms / 1e3:.3f} s; stages (ms) "
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + f"; every column finite; launches {counts} [{card}]",
          flush=True)
    for j in shown:
        r = {k: float(v[i60, j]) for k, v in rows.items()}
        print("phase 26 calibrate row " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items()), flush=True)

    # ── E4<tap> and E6 against their plain versions: on run_calibrate's
    # own inputs at full width (a prefix), and on 133 ragged streams with
    # a NaN and an inf column ──
    n_tap = 1000
    tap_main, (t2_p, _) = compare_voice_tap(
        kr, rec["tap"], n_tap, f"run_calibrate's 512 streams, first {n_tap}")
    x6, st6, vol6, chr6 = rec["e6"]
    n_e6 = E6_REPLAY_N
    e6_main = compare_pa_speaker(
        kr, x6[:n_e6].contiguous(), st6, vol6, chr6,
        f"run_calibrate's 512 streams, first {n_e6}")
    rng = np.random.default_rng(26)
    g_r = 133
    gm = rng.integers(33, 97, g_r).astype(np.float64)
    gv = rng.integers(1, 128, g_r) / 127.0
    taps = calibrate.pack_taps(gm, gv, tables.CalibrationConfig(), dev)
    cols = [c.clone() for c in taps.cols]
    cols[0][ek.P_AMP + 1, 5] = float("nan")
    cols[1][ek.S_S + 2, 77] = float("inf")
    cols[0][ek.P_DS, 9] *= 40.0            # the pickup past its knee
    tap_r, (t2_r, _) = compare_voice_tap(
        kr, cols, 1100, f"{g_r} ragged streams, NaN and inf columns")
    tap_geo = [compare_voice_tap(
        kr, staggered_voices(cols, g), 300,
        f"{g} staggered stream(s)" + (", NaN and inf" if g > 80 else ""))[0]
        for g in (1, 5, 33, 133)]
    x_r = di.preamp_di(t2_r[:, :] * taps.out_scale, calibrate.BASE_SR,
                       device=dev)[-160:].contiguous()
    x_r[:, 5] = float("nan")
    x_r[20:, 77] = float("inf")
    x_r[:, 31] *= 400.0                    # driven into the rails
    e6_r = compare_pa_speaker(
        kr, x_r, kr.init_pa_speaker_state(calibrate.BASE_SR, g_r, dev), 0.4,
        1.0, f"{g_r} ragged streams, NaN and inf columns, rails")
    forms = pa_step_forms(kr, x6[:n_e6].contiguous(), st6, vol6, chr6)
    pa_step_forms(kr, x_r, kr.init_pa_speaker_state(calibrate.BASE_SR, g_r,
                                                    dev), 0.4, 1.0)
    e6_main["abba"] = forms
    print("phase 26 E4<tap> and E6 bit-identical to their plain versions: "
          + "; ".join(f"{c['inputs']} {c['shape']} kernel {c['ms']:.3f} ms "
                      f"plain {c['plain_ms']:.0f} ms"
                      for c in (tap_main, tap_r, *tap_geo, e6_main, e6_r))
          + f"; E6 and E9 leave the same power-amp rows on both calls; "
          f"A B B A on run_calibrate's call (512 x {n_e6}): E9 (no "
          f"speaker) {forms['e9_ms'][0]:.3f} ms, E6 "
          + " / ".join(f"{t:.3f}" for t in forms["e6_ms"])
          + f" ms, E9 {forms['e9_ms'][1]:.3f} ms"
          f" [{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)

    # ── the pipeline, stages 1-6 through main, on the three-note
    # recording of tests/test_calib_pipeline.py:84-122 (rendered here by
    # the port on the card) ──
    t_p = time.perf_counter()
    work = os.path.join(repo, "build", "chip_smoke_calib")
    shutil.rmtree(work, ignore_errors=True)
    rec_dir, data_dir = os.path.join(work, "recordings"), \
        os.path.join(work, "ml_data")
    os.makedirs(rec_dir)
    sr = 44100.0
    takes = [(60, 0.8), (67, 0.7), (72, 0.9)]
    chunks = [np.zeros(int(0.3 * sr))]
    for midi, vel in takes:
        a = voice.render_note(midi, vel, 1.2, sr, device=dev).cpu().numpy()
        chunks += [a / max(np.abs(a).max(), 1e-12) * 0.5,
                   np.zeros(int(0.4 * sr))]
    wav.write_wav(os.path.join(rec_dir, "test.wav"), np.concatenate(chunks),
                  sr, bits=24)
    reset_counts(vb, mc)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pipe_ms, _ = host_ms(lambda: pipeline.main(
            ["--input-dir", rec_dir, "--data-dir", data_dir,
             "--through-stage", "6", "--epochs", "50", "--model-seconds",
             "1.2", "--device", dev]))
    launches["pipeline stages 1-6"] = counts = read_counts(vb, mc)
    log = buf.getvalue()
    stage_s = dict(zip([f"stage {k}" for k in range(1, 7)],
                       [float(x) for x in re.findall(r"\(([\d.]+)s\)",
                                                     log)]))
    found = json.load(open(os.path.join(data_dir, "notes.json")))
    midis = sorted({n_["midi_note"] for n_ in found})
    check(len(found) >= 3 and all(any(abs(m - midi) <= 1 for m in midis)
                                  for midi, _ in takes),
          f"pipeline notes: {midis}")
    with np.load(os.path.join(data_dir, "training_data.npz")) as z:
        check(z["inputs"].shape[1] == 2 and z["targets"].shape[1] == 11
              and z["mask"].any(), "pipeline training data")
        n_obs = z["inputs"].shape[0]
    with np.load(os.path.join(data_dir, "model_weights.npz")) as z:
        check(z["w1"].shape == (16, 2) and all(np.isfinite(z[k]).all()
                                               for k in z.files),
              "pipeline weights")
    check(counts["voice_render"] == 1 and counts["preamp_scan_dk"] == 1
          and counts["plain"] == 0, f"pipeline launches {counts}")
    print(f"phase 26 pipeline stages 1-6 on a 3-note recording: "
          f"{pipe_ms / 1e3:.2f} s; per stage (s) {stage_s}; notes {midis}; "
          f"{n_obs} observations; weights finite; launches {counts} "
          f"[{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)
    shutil.rmtree(work, ignore_errors=True)

    # ── the onset extractors on the 4-note fixture mixture
    # (tests/test_onset_model.py:79-128) ──
    mix, sr_f = fixture_mixture()
    weights = onset_model.load_params()
    nn = onset_score(notes.extract_notes(mix, sr_f, min_duration=0.15,
                                         method="nn", device=dev))
    spectral = onset_score(notes.extract_notes(mix, sr_f, min_duration=0.15,
                                               method="spectral",
                                               device=dev))
    check(spectral == ONSET_SPECTRAL_REF,
          f"spectral onsets {spectral} vs the reference's "
          f"{ONSET_SPECTRAL_REF}")
    check(weights is not None or nn == (0, 0),
          f"the network found notes without weights: {nn}")
    if weights is not None:  # the JAX test's assertions
        check(nn[0] >= max(spectral[0], 4) and nn[1] <= spectral[1],
              f"NN {nn} vs spectral {spectral}")
    print(f"phase 26 onsets on the 4-note fixture mixture (hits of 4, "
          f"spurious): spectral {spectral} (reference {ONSET_SPECTRAL_REF}),"
          f" network {nn} "
          + ("(shipped weights lack the format-3 tag: none loaded)"
             if weights is None else "") + f" [{card}]", flush=True)

    n_cal = int(calibrate.DURATION_S * calibrate.BASE_SR)
    return {"E4<tap>": {**tap_main, "compared": [tap_main, tap_r, *tap_geo],
                        "us_per_sample": stages["E4<tap>"] * 1e3 / n_cal,
                        "main_path_ms": {"run_calibrate 512 x 22050":
                                         stages["E4<tap>"]}},
            "E6": {**e6_main, "compared": [e6_main, e6_r],
                   "main_path_ms": {"run_calibrate 512 x 22050":
                                    stages["E6"]}},
            "calibrate": {"ms": cal_ms, "stages_ms": stages},
            "pipeline": {"ms": pipe_ms, "stages_s": stage_s},
            "onsets": {"spectral": spectral, "network": nn,
                       "weights": weights is not None}}


# ── the CLI (phase 27) ──

# float64 operations of one E7 step beyond the twin DK step's own
# (PREAMP_OPS_STEP): the sample's LDR conductance, one division
E7_OPS_SAMPLE = PREAMP_OPS_STEP + 1
# `intermod-audit`'s last line (stderr), as the JAX package's CLI prints it
# on a CPU; tests/test_torch_cli.py holds the port's text to the reference's
INTERMOD_WORST = "# worst: MIDI 38 max_risk 0.00338"
# render-midi's song: (onset s, release s, midi, velocity) and a pedal
# held from 0.15 s to 0.35 s
CLI_SONG = ((0.0, 0.2, 60, 100), (0.05, 0.3, 64, 90), (0.1, 0.4, 67, 80))
CLI_PEDAL = (0.15, 0.35)


def write_smf(path, notes, pedal, tpq=480):
    """A format-0 SMF at 120 bpm (960 ticks per second): note-ons and
    note-offs of `notes`, CC64 down and up at `pedal`."""
    import struct

    ev = [(on, 0x90, m, v) for on, _, m, v in notes]
    ev += [(off, 0x80, m, 0) for _, off, m, _ in notes]
    ev += [(pedal[0], 0xB0, 64, 127), (pedal[1], 0xB0, 64, 0)]
    track, last = bytearray(), 0
    for t, status, d1, d2 in sorted(ev):
        tick = int(round(t * 2 * tpq))
        delta, last = tick - last, tick
        var = [delta & 0x7F]
        delta >>= 7
        while delta:
            var.append((delta & 0x7F) | 0x80)
            delta >>= 7
        track += bytes(reversed(var)) + bytes([status, d1, d2])
    track += bytes([0x00, 0xFF, 0x2F, 0x00])
    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, tpq))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))


def wav_spec(path):
    """(sample rate, bits, channels, frames, samples) of a PCM WAV written
    by io.wav.write_wav."""
    import struct

    from openwurli_tpu_torch.io import wav

    with open(path, "rb") as f:
        head = f.read(44)
    _tag, ch, sr, _rate, _block, bits = struct.unpack("<HHIIHH", head[20:36])
    x, sr_read = wav.read_wav(path)
    check(sr_read == sr, f"{path}: sample rate")
    return sr, bits, ch, len(x), x


def compare_dk_scan(kr, sr, x, r, state, tap, what):
    """E7 against its plain version on one scan's inputs: output and state
    bit for bit; the plain run's Newton passes, each stream's own, give
    the operations the data needed (for the bound). → numbers."""
    from openwurli_tpu_torch.circuits import dk_preamp

    a, b = state.clone(), state.clone()
    out = kr.dk_scan(sr, x, r, a, tap)
    passes0 = dk_preamp.NEWTON_PASSES[0]
    plain_ms, ref = host_ms(lambda: kr.dk_scan_plain(sr, x, r, b, tap))
    passes = dk_preamp.NEWTON_PASSES[0] - passes0
    check(same_bits(out, ref) and same_bits(a, b),
          f"E7<{tap}> {what}: {first_diff(out, ref)}, state "
          f"{first_diff(a, b)}")
    ms = cuda_ms(lambda: kr.dk_scan(sr, x, r, state.clone(), tap), reps=3)
    n, g = x.shape
    n_bytes = (3 * x.numel() + 2 * state.numel()
               + kr.preamp_consts("dk", float(sr)).size) * 8
    ops = n * g * E7_OPS_SAMPLE + passes * PREAMP_OPS_PASS
    return {"shape": f"{g} streams x {n}", "inputs": f"E7<{tap}> {what}",
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops),
            "newton": {"stream_passes": passes},
            "us_per_step": ms * 1e3 / n,
            "max_abs_err": float((out - ref).abs().nan_to_num().max())}


def cli_phases(dev, card, launches, vb, mc, ptxas):
    """Phase 27: every subcommand of the port's CLI through `cli.main` on
    the card, each timed, its output checked and its launches counted;
    the alias-audit sweep through `alias-audit --note N -o`; E7 against
    its plain version on the calls' own inputs and on ragged streams with
    NaN and inf inputs. Adds the CLI's launch counts to `launches`; → the
    measurements."""
    import contextlib
    import io
    import os
    import shutil

    from openwurli_tpu_torch import cli, voice
    from openwurli_tpu_torch.calib import alias_audit
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    e2_one = chain_kernel(ek, "dk", "circuit", 1)  # one DK engine's E2
    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def path(name):
        return os.path.join(work, name)

    song = path("song.mid")
    write_smf(song, CLI_SONG, CLI_PEDAL)
    runs = [
        ("gain", []), ("sweep", []), ("harmonics", []),
        ("tremolo-sweep", []),
        ("render", ["-o", path("render.wav")]),
        ("reed-render", ["-o", path("reed_a.wav")]),
        ("reed-render", ["-o", path("reed_b.wav")]),
        ("reed-render", ["-v", "40", "--duration", "0.5",
                         "-o", path("reed_v40.wav")]),
        ("render-poly", ["--duration", "0.25", "--fast",
                         "-o", path("poly_fast.wav")]),
        ("render-poly", ["--duration", "0.25", "-o", path("poly.wav")]),
        ("render-midi", [song, "--tail", "0.25", "--fast",
                         "-o", path("midi_fast.wav")]),
        ("render-midi", [song, "--tail", "0.25", "--fast", "--serial",
                         "-o", path("midi_serial.wav")]),
        ("render-midi", [song, "--tail", "0.25", "-o", path("midi.wav")]),
        ("intermod-audit", []), ("bark-audit", []),
        ("calibrate", ["-o", path("calibrate.csv")]),
        ("sensitivity", ["--ds-grid", "0.85", "-o", path("sens.csv")]),
        ("centroid-track", []), ("overshoot", []),
        ("pump-trace", []), ("pump-sweep", []), ("pump-step", []),
        ("pump-sinusoid", []), ("pump-spike", []),
        ("bench-reed", ["--duration", "0.25"]),
    ]
    # E7's calls, their inputs kept (the state cloned before the call)
    rec = {}
    scan_fn = kr.dk_scan
    current = [None]

    def scan_rec(sr, x, r, state, tap):
        rec.setdefault(current[0], []).append((sr, x, r, state.clone(), tap))
        return scan_fn(sr, x, r, state, tap)

    timer = StageTimer()
    kr.dk_scan = scan_rec
    timer.wrap(kr, "dk_scan", "E7")
    t_p = time.perf_counter()
    out, per_cmd = {}, []
    reset_counts(vb, mc)
    try:
        for name, extra in runs:
            current[0] = name
            before = read_counts(vb, mc)
            so, se = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(so), \
                    contextlib.redirect_stderr(se):
                ms, _ = host_ms(lambda: cli.main(["--device", dev, name,
                                                  *extra]))
            after = read_counts(vb, mc)
            diff = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            check(diff.get("plain", 0) == 0, f"cli {name}: plain calls")
            flags = [a for a in extra if a in ("--fast", "--serial")]
            first = (so.getvalue().strip().splitlines() or [""])[0]
            per_cmd.append({"cmd": " ".join([name, *flags]), "ms": ms,
                            "launches": diff, "first_line": first})
            out.setdefault(name, []).append((so.getvalue(), se.getvalue(),
                                             diff))
    finally:
        kr.dk_scan = scan_fn
        timer.restore()
    cli_ms = (time.perf_counter() - t_p) * 1e3

    def lines(name, k=0):
        return out[name][k][0].strip().splitlines()

    def rows(name, k=0):
        got = [line.split(",") for line in lines(name, k)[1:]]
        check(all(np.isfinite([float(v) for v in r]).all() for r in got),
              f"cli {name}: finite rows")
        return np.array(got, dtype=np.float64)

    def launched(name, *kernels, k=0):
        diff = out[name][k][2]
        check(all(diff.get(kn, 0) >= 1 for kn in kernels),
              f"cli {name} launches {diff}, wanted {kernels}")

    # ── the outputs ──
    gain = lines("gain")[0]
    check(gain.startswith("Gain @ 1000 Hz, R_ldr=1000000 Ω:"), gain)
    for name, n_rows in (("sweep", 25), ("tremolo-sweep", 13),
                         ("pump-sweep", 13), ("pump-spike", 41)):
        r = rows(name)
        check(r.shape == (n_rows, 2), f"cli {name}: {r.shape}")
    check(lines("sweep")[0] == "freq_hz,gain_db", "sweep header")
    trem = rows("tremolo-sweep")
    check(np.allclose(trem[:, 0], np.round(np.geomspace(8e3, 1e6, 13)))
          and np.all(np.diff(trem[:, 1]) <= 0.0)
          and trem[0, 1] > trem[-1, 1] + 10.0,
          f"tremolo-sweep: the gain falls as R_ldr rises: {trem}")
    harm = lines("harmonics")
    check(len(harm) == 6 and harm[0].startswith("H1: ")
          and harm[-1].startswith("THD (H2-H5): "), f"harmonics {harm}")
    for name in ("gain", "sweep", "harmonics", "tremolo-sweep"):
        launched(name, "dk_scan")
    for name in ("pump-trace", "pump-step"):
        r = rows(name)
        check(r.shape[1] == 2 and len(r) >= 2000, f"cli {name} {r.shape}")
        launched(name, "dk_scan")
    for name in ("pump-sweep", "pump-sinusoid", "pump-spike"):
        launched(name, "dk_scan")
    check(lines("pump-sinusoid")[0].startswith(
        "pump pp under 5.5 Hz log-R modulation: "), "pump-sinusoid")
    # WAVs: spec, sample counts, signal
    spec = {}
    for f, frames in (("render.wav", 88200), ("reed_a.wav", 88200),
                      ("reed_b.wav", 88200), ("reed_v40.wav", 22050),
                      ("poly_fast.wav", 11025), ("poly.wav", 11025)):
        sr, bits, ch, n, x = wav_spec(path(f))
        check((sr, bits, ch, n) == (44100, 24, 1, frames)
              and np.abs(x).max() > 1e-3, f"{f}: {(sr, bits, ch, n)}")
        spec[f] = x
    check(np.array_equal(spec["reed_a.wav"], spec["reed_b.wav"]),
          "reed-render twice: bit-identical")
    both = voice.render_note(np.array([60.0, 60.0]),
                             np.array([40 / 127, 120 / 127]), 0.15, SR,
                             device=dev).abs().amax(0)
    check(float(both[1]) > float(both[0]), "velocity ordering")
    song_s = max(off for _, off, _, _ in CLI_SONG) + 0.25
    for f in ("midi_fast.wav", "midi_serial.wav", "midi.wav"):
        sr, bits, ch, n, x = wav_spec(path(f))
        check((sr, bits, ch) == (44100, 24, 1)
              and abs(n - song_s * SR) <= 2048 and np.abs(x).max() > 1e-3,
              f"{f}: {(sr, bits, ch, n)}")
    launched("render", "voice_render", "preamp_scan_dk")
    launched("centroid-track", "voice_render", "preamp_scan_dk")
    launched("overshoot", "voice_render", "preamp_scan_dk")
    launched("reed-render", "voice_render")
    launched("bench-reed", "voice_render")
    launched("render-poly", "voice_bank", "mono_chain")
    launched("render-poly", "engine_voices", e2_one, k=1)
    launched("render-midi", "voice_bank_events", "trem_preroll",
             "mono_chain")
    launched("render-midi", "voice_bank_events", "mono_chain", k=1)
    launched("render-midi", "engine_voices", e2_one, k=2)
    for name in ("bark-audit", "calibrate", "sensitivity"):
        launched(name, "voice_render_tap", "preamp_scan_dk",
                 "pa_speaker_scan")
    check(len(rows("centroid-track")) == 40, "centroid-track rows")
    check(lines("overshoot")[0].startswith("note 60: 0-10ms peak"),
          "overshoot")
    bark = lines("bark-audit")
    check(len(bark) == 4 and bark[0].startswith("t2 H2/H1: "), f"{bark}")
    with open(path("calibrate.csv")) as f:
        cal = f.read().strip().splitlines()
    header = cal[0].split(",")
    check(header[:3] == ["midi", "note_name", "velocity"]
          and len(header) == 21 and len(cal) == 1 + 13 * 3
          and "t5_rms_db" in header and "tanh_compression_db" in header,
          "calibrate CSV schema")
    check(cal[1].split(",")[:3] == ["36", "C2", "40"], "calibrate row")
    check(all(np.isfinite([float(v) for v in line.split(",")[3:]]).all()
              for line in cal[1:]), "calibrate CSV finite")
    with open(path("sens.csv")) as f:
        sens = f.read().strip().splitlines()
    check(len(sens) == 11 and sens[1].startswith("0.85,36,80,"),
          f"sensitivity CSV {sens[:2]}")
    intermod = out["intermod-audit"][0]
    check(len(intermod[0].splitlines()) == 65
          and intermod[1].strip() == INTERMOD_WORST,
          f"intermod-audit: {intermod[1].strip()!r}")
    check(not out["intermod-audit"][0][2], "intermod-audit launches")
    bench = lines("bench-reed")[0]
    check(bench.startswith("64 voices × 0.25s at 44100 Hz: ")
          and bench.endswith("x realtime"), bench)

    # ── the alias-audit sweep (circuit power amp) through the CLI ──
    t_a = time.perf_counter()
    baseline = json.load(open(os.path.join(repo, ALIAS_BASELINE)))
    elapsed = time.perf_counter() - T_START
    sweep = alias_audit.STIMULUS_NOTES
    if elapsed + ALIAS_NOTE_S * len(sweep) + AFTER_ALIAS_S > SCRIPT_LIMIT_S:
        sweep = (84,)
    alias = {}
    for note in sweep:
        before = read_counts(vb, mc)
        so = io.StringIO()
        with contextlib.redirect_stdout(so):
            ms, _ = host_ms(lambda: cli.main(
                ["--device", dev, "alias-audit", "--note", str(note), "-o",
                 path(f"alias_{note}.json")]))
        after = read_counts(vb, mc)
        diff = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
        check(diff.get(e2_one, 0) > 0 and "plain" not in diff,
              f"alias-audit --note {note} launches {diff}")
        per_cmd.append({"cmd": f"alias-audit --note {note}", "ms": ms,
                        "launches": diff})
        (r,) = json.load(open(path(f"alias_{note}.json")))
        b = baseline[str(note)]
        rust_step, rust_hf = ALIAS_RUST[note]
        check(r["note"] == note and r["velocity"]
              == alias_audit.STIMULUS_VELOCITY
              and len(r["harmonic_dbc"]) == alias_audit.NUM_HARMONICS,
              f"alias note {note} report")
        check(r["max_step_up_db"] <= b["max_step_up_db"]
              + ALIAS_STEP_UP_TOL_DB
              and r["hf_band_dbc"] <= b["hf_band_dbc"] + ALIAS_HF_TOL_DB,
              f"alias note {note}: step-up {r['max_step_up_db']:.3f} "
              f"(golden {b['max_step_up_db']:.3f}), hf "
              f"{r['hf_band_dbc']:.3f} (golden {b['hf_band_dbc']:.3f})")
        check(r["max_step_up_db"] <= rust_step + ALIAS_STEP_UP_TOL_DB
              and r["hf_band_dbc"] <= rust_hf + ALIAS_RUST_HF_TOL_DB,
              f"alias note {note} against the Rust reference")
        alias[note] = {"ms": ms, "max_step_up_db": r["max_step_up_db"],
                       "hf_band_dbc": r["hf_band_dbc"], "f0_hz": r["f0_hz"],
                       "golden": [b["max_step_up_db"], b["hf_band_dbc"]]}
    launches["cli 21 subcommands"] = counts = read_counts(vb, mc)
    check(counts["plain"] == 0 and counts["dk_scan"] == 9,
          f"cli launches {counts}")
    which = "all three notes" if len(sweep) == 3 else "note 84 alone"
    for c in per_cmd:
        print(f"phase 27 cli {c['cmd']}: {c['ms'] / 1e3:.3f} s, launches "
              f"{c['launches']}; {c.get('first_line', '')!r}", flush=True)
    print(f"phase 27 cli: {len(runs)} runs of 21 subcommands in "
          f"{cli_ms / 1e3:.1f} s (E7 {timer.ms['E7']:.1f} ms of it) + "
          f"alias-audit {which} ({elapsed:.0f} s into the script): "
          + "; ".join(f"{k}: step-up {v['max_step_up_db']:.3f} dB "
                      f"(golden {v['golden'][0]:.3f}), hf "
                      f"{v['hf_band_dbc']:.3f} dBc (golden "
                      f"{v['golden'][1]:.3f}), {v['ms'] / 1e3:.1f} s"
                      for k, v in alias.items())
          + f"; every output checked; launches {counts} [{card}] "
          f"({time.perf_counter() - t_a:.0f} s)", flush=True)

    # ── E7 against its plain version: on sweep's and pump-sinusoid's
    # own inputs (the first 1000 steps), and on 133 ragged streams with
    # NaN and inf inputs and a NaN resistance ──
    t_p = time.perf_counter()
    n_cmp = 1000
    cmps = []
    for name in ("sweep", "pump-sinusoid"):
        (sr, x, r, st, tap), = rec[name]
        cmps.append(compare_dk_scan(
            kr, sr, x[:n_cmp].contiguous(), r[:n_cmp].contiguous(), st, tap,
            f"{name}'s {x.shape[1]} stream(s), first {n_cmp}"))
    rng = np.random.default_rng(27)
    n_r, g_r = 700, 133
    t = np.arange(n_r)[:, None]
    x = rng.uniform(1e-4, 5e-3, g_r) * np.sin(rng.uniform(0.001, 0.5, g_r)
                                              * t)
    r = np.exp(rng.uniform(np.log(500.0), np.log(2e6), (n_r, g_r)))
    x[n_r // 3, 5] = np.nan
    x[n_r // 2:, 77] = np.inf
    r[n_r // 4, 31] = np.nan
    x, r = (torch.as_tensor(a, device=dev) for a in (x, r))
    for tap in kr.DK_TAPS:
        cmps.append(compare_dk_scan(
            kr, 88200.0, x, r, kr.init_dk_scan_state(88200.0, g_r, dev), tap,
            f"{g_r} ragged streams, NaN and inf"))
        # a warp per stream, four to a block: one stream (the NaN input's)
        # and a partial last block of 33 (the NaN and inf inputs, the NaN
        # resistance)
        for cols, what in (([5], "the NaN input's stream"),
                           (list(range(30)) + [31, 77, 100],
                            "33 of those: NaN and inf inputs, a NaN "
                            "resistance")):
            g = len(cols)
            cmps.append(compare_dk_scan(
                kr, 88200.0, x[:400, cols].contiguous(),
                r[:400, cols].contiguous(),
                kr.init_dk_scan_state(88200.0, g, dev), tap, what))
    e7_ptxas = {k: v for k, v in ptxas.items() if k.startswith("E7")}
    print("phase 27 E7 ptxas: " + "; ".join(
        f"{k} {v['registers']} registers, {v['stack']} bytes stack, "
        f"{v['spill_stores']} / {v['spill_loads']} bytes spilled"
        for k, v in sorted(e7_ptxas.items())), flush=True)
    print("phase 27 E7 bit-identical to its plain version: "
          + "; ".join(f"{c['inputs']} {c['shape']} kernel {c['ms']:.3f} ms "
                      f"({c['us_per_step']:.2f} us per step) plain "
                      f"{c['plain_ms']:.0f} ms bound {c['bound'][0]:.4f} ms"
                      for c in cmps)
          + f" [{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    main_cmp = cmps[0]
    return {"E7": {**main_cmp, "compared": cmps, "ptxas": e7_ptxas,
                   "main_path_ms": {"cli E7 calls": timer.ms["E7"]}},
            "cli": per_cmd, "alias": alias}


# ── the f64 stage breakdown (phase 29) ──

# float64 operations of csrc/engine.cu outside the Newton solves: one E8
# step's vactrol and divider (the LED drive, the envelope, its pow and
# exp, the divider's two parallels); one E9 sample's sources, two-tier
# guard and rails (E6's sample without volume², speaker and post gain)
E8_OPS_STEP = 30 + 2 * LIBM_OPS
E9_OPS_SAMPLE = 21 + 40 + 25
STAGE_SR = 88200.0
# E2's thread forms' ptxas (registers, stack bytes, spill stores, spill
# loads; NVIDIA H100 80GB HBM3, the card machine's nvcc): the circuit
# instantiations as built before E8 and E9 existed (E8 and E9 add callers
# of E2's tremolo and power-amp steps, and must not move the existing
# kernels' allocation; nor must the warp steps beside them), the
# behavioral ones as built with their working set in registers and shared
# memory (before that 255 / 2880 / 208 / 212 and 255 / 3824 / 120 / 136,
# the engine's rows in a local array). E6, E5<melange>, E5<dk>, E7, E9,
# E3 and E8 (a warp per stream or circuit since), E4 and E1's cluster form
# (eight threads per voice), E1's thread form (its libm behind votes) and
# E2's warp and half forms are not in the list.
EARLIER_PTXAS = {
    "E2<dk, circuit> thread": (255, 6912, 80, 136),
    "E2<melange, circuit> thread": (255, 7152, 128, 176),
    "E2<dk, behavioral> thread": (244, 40, 0, 0),
    "E2<melange, behavioral> thread": (254, 40, 0, 0)}
STAGE_NAMES = ("voices", "preamp twin", "tremolo", "power amp")


def compare_tremolo_scan(ek, state, depth, n, what):
    """E8 against its plain version: output and state bit for bit; the
    plain run's oscillator Newton counts, each circuit's own, give the
    bound. → numbers."""
    from openwurli_tpu_torch.circuits import mna

    a, b = state.clone(), state.clone()
    out = ek.tremolo_scan(STAGE_SR, a, depth, n)
    n0 = dict(mna.NEWTON_COUNTS)
    plain_ms, ref = host_ms(lambda: ek.tremolo_scan_plain(
        STAGE_SR, b, depth, n))
    count = {k: mna.NEWTON_COUNTS[k] - n0.get(k, 0)
             for k in mna.NEWTON_COUNTS}
    check(same_bits(out, ref) and same_bits(a, b),
          f"E8 {what}: {first_diff(out, ref)}, state {first_diff(a, b)}")
    ms = cuda_ms(lambda: ek.tremolo_scan(STAGE_SR, state.clone(), depth, n),
                 reps=3)
    g = state.shape[1]
    n_bytes = (2 * state.numel() + depth.numel() + n * g
               + ek.scan_consts(STAGE_SR, "tremolo").size) * 8
    solves = count.get((ek.M_T, "solves"), 0)
    iters = count.get((ek.M_T, "iterations"), 0)
    ops = n * g * E8_OPS_STEP + mna_ops(ek.N_T, ek.M_T, ek.NB_T, solves,
                                         iters)
    return {"shape": f"{g} circuits x {n}", "inputs": f"E8 {what}",
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops),
            "newton": {"tremolo": [solves, iters]},
            "us_per_step": ms * 1e3 / n,
            "max_abs_err": float((out - ref).abs().nan_to_num().max())}


def compare_power_amp_scan(ek, x, state, what):
    """E9 against its plain version: output and state bit for bit; the
    plain run's power-amp Newton counts, each stream's own, give the
    bound. → numbers."""
    from openwurli_tpu_torch.circuits import mna

    a, b = state.clone(), state.clone()
    out = ek.power_amp_scan(STAGE_SR, x, a)
    n0 = dict(mna.NEWTON_COUNTS)
    plain_ms, ref = host_ms(lambda: ek.power_amp_scan_plain(
        STAGE_SR, x, b))
    count = {k: mna.NEWTON_COUNTS[k] - n0.get(k, 0)
             for k in mna.NEWTON_COUNTS}
    check(same_bits(out, ref) and same_bits(a, b),
          f"E9 {what}: {first_diff(out, ref)}, state {first_diff(a, b)}")
    ms = cuda_ms(lambda: ek.power_amp_scan(STAGE_SR, x, state.clone()),
                 reps=3)
    n, g = x.shape
    n_bytes = (2 * x.numel() + 2 * state.numel()
               + ek.scan_consts(STAGE_SR, "power_amp").size) * 8
    solves = count.get((ek.M_PA, "solves"), 0)
    iters = count.get((ek.M_PA, "iterations"), 0)
    ops = n * g * E9_OPS_SAMPLE + mna_ops(ek.N_PA, ek.M_PA, ek.NB_PA,
                                          solves, iters)
    return {"shape": f"{g} streams x {n}", "inputs": f"E9 {what}",
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops),
            "newton": {"power_amp": [solves, iters]},
            "us_per_sample": ms * 1e3 / n,
            "max_abs_err": float((out - ref).abs().nan_to_num().max())}


def stage_phases(dev, card, launches, vb, mc, ptxas):
    """Phase 29: E8 and E9 against their plain versions (33 circuits or
    streams: seeded starts, three depths, a kicked and a NaN circuit; a
    spike, a NaN and an inf stream), their ptxas and E1-E7's against
    EARLIER_PTXAS, and `tools/torch_stage_bench.py`'s `main` as the path.
    Adds the path's launch counts to `launches`; → the measurements."""
    import contextlib
    import io
    import os
    import runpy

    from openwurli_tpu_torch.kernels import engine as ek

    t_p = time.perf_counter()
    g, n8, n9 = 33, 64, 32
    rng = np.random.default_rng(29)
    st = ek.init_tremolo_scan_state(STAGE_SR, g, dev)
    st[:ek.N_T] += torch.as_tensor(rng.uniform(-0.05, 0.05, (ek.N_T, g)),
                                   device=dev)
    trem0 = ek.CHAIN_OFF["trem_v"][0]
    st[ek.CHAIN_OFF["trem_env"][0] - trem0] = torch.as_tensor(
        rng.uniform(0.0, 0.8, g), device=dev)
    st[0, 5] += 70.0                  # kicked: a Newton failure, BE replay
    st[2, g // 2] = float("nan")      # the oscillator's NaN reset
    depth = torch.tensor([(0.0, 0.5, 1.0)[j % 3] for j in range(g)],
                         dtype=torch.float64, device=dev)
    e8 = compare_tremolo_scan(ek, st, depth, n8,
                              f"{g} circuits, seeded starts, depths 0 / "
                              "0.5 / 1, a kicked and a NaN circuit")
    t = np.arange(n9)[:, None]
    x = rng.uniform(0.02, 2.0, g) * np.sin(2 * np.pi * 1000 * t / STAGE_SR)
    x[:, 0] = 0.05 * np.sin(2 * np.pi * 1000 * t[:, 0] / STAGE_SR)
    x[n9 // 3, 1] = 200.0             # the guard's reset, the rails' reset
    x[n9 // 4, 2] = np.nan
    x[n9 // 2:, 3] = np.inf
    e9 = compare_power_amp_scan(
        ek, torch.as_tensor(x, device=dev),
        ek.init_power_amp_scan_state(STAGE_SR, g, dev),
        f"{g} streams, the bench's sine and seeded levels to 2 V, a 200 V "
        "spike, a NaN and an inf stream")
    stage_ptxas = {k: ptxas[k] for k in ("E8", "E9") if k in ptxas}
    check(len(stage_ptxas) == 2 or not ptxas, "E8, E9 not in the build log")
    moved = {k: (tuple(ptxas[k].values()), v)
             for k, v in EARLIER_PTXAS.items()
             if k in ptxas and tuple(ptxas[k].values()) != v}
    check(not moved, f"ptxas moved from EARLIER_PTXAS: {moved}")
    print("phase 29 ptxas: " + "; ".join(
        f"{k} {v['registers']} registers, {v['stack']} bytes stack, "
        f"{v['spill_stores']} / {v['spill_loads']} bytes spilled"
        for k, v in sorted(stage_ptxas.items()))
        + (f"; E2's thread forms ({len(EARLIER_PTXAS)} entries) "
           "as EARLIER_PTXAS holds them"
           if ptxas else "; no build log (library already built)"),
        flush=True)

    # the path: the stage benchmark's main at a short depth
    tool = runpy.run_path(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools", "torch_stage_bench.py"))
    argv = ["--batch", "32", "--samples", "256", "--reps", "2"]
    reset_counts(vb, mc)
    so = io.StringIO()
    with contextlib.redirect_stdout(so):
        bench_ms, _ = host_ms(lambda: tool["main"](argv))
    launches["stage bench"] = counts = read_counts(vb, mc)
    lines = so.getvalue().strip().splitlines()
    check(lines[0] == "batch=32 samples=256 (us per sample, best of 2)"
          and len(lines) == 5, f"stage bench header {lines[:1]}")
    us = {}
    for line, name in zip(lines[1:], STAGE_NAMES):
        words = line.split()
        check(line.startswith(f"  {name:12s} ") and words[-1] == "us/sample"
              and np.isfinite(float(words[-2])) and float(words[-2]) > 0,
              f"stage bench line {line!r}")
        us[name] = float(words[-2])
    check(counts["plain"] == 0 and all(
        counts[k] == 3 for k in ("voice_render", "dk_scan", "tremolo_scan",
                                 "power_amp_scan")),
          f"stage bench launches {counts}")
    print(f"phase 29 E8 and E9 bit-identical to their plain versions: "
          + "; ".join(f"{c['inputs']} {c['shape']} kernel {c['ms']:.3f} ms "
                      f"plain {c['plain_ms']:.0f} ms bound "
                      f"{c['bound'][0]:.5f} ms" for c in (e8, e9))
          + f"; tools/torch_stage_bench.py {' '.join(argv)}: "
          + ", ".join(f"{k} {v} us" for k, v in us.items())
          + f" ({bench_ms / 1e3:.1f} s), launches {counts} [{card}] "
          f"({time.perf_counter() - t_p:.0f} s)", flush=True)
    return {"E8": {**e8, "ptxas": ptxas.get("E8"),
                   "stage_bench_us": us["tremolo"]},
            "E9": {**e9, "ptxas": ptxas.get("E9"),
                   "stage_bench_us": us["power amp"]},
            "stage_bench_us": us}


# ── the multi-device path and the onset trainer (phases 30-33) ──

# The headline width of phase 30's render_grid_sharded (streams x voices)
# and its samples; phase 33's training run (the tool's usage line).
SHARDED_SAMPLES = 8192
ONSET_TOOL_ARGS = ("--clips", "20", "--steps", "200")


def parallel_phases(dev, card, launches, vb, mc):
    """Phases 30-33: `fast.render_grid_sharded` over a one-rank NCCL group
    at the headline width against `render_grid`; `mesh.sharded_grid_render`
    against `voice.render` and `dryrun.main(1, device="cuda")` (a spawned
    NCCL rank); `entry.entry()`'s forward step against the plain K1 and K2;
    `tools/torch_train_onset_model.py` at its usage line's size. Adds the
    paths' launch counts to `launches`; → the paths' numbers."""
    import contextlib
    import io
    import os
    import runpy

    import torch.distributed as dist

    from openwurli_tpu_torch import entry, fast, voice
    from openwurli_tpu_torch.calib import onset_model
    from openwurli_tpu_torch.parallel import dryrun
    from openwurli_tpu_torch.parallel import mesh as meshlib

    repo = os.path.dirname(os.path.abspath(__file__))
    t_p = time.perf_counter()
    # ── phase 30: render_grid_sharded over a one-rank NCCL group ──
    mesh = meshlib.make_mesh()
    check(dist.get_backend() == "nccl" and mesh == meshlib.Mesh(
        0, 1, torch.device("cuda", 0)), f"mesh {mesh} on {dist.get_backend()}")
    streams = 128
    midis = np.tile(np.arange(36, 100, dtype=np.float64), (streams, 1))
    vel = (0.95 + 0.0005 * np.arange(streams))[:, None] \
        * np.ones((1, midis.shape[1]))
    seconds = SHARDED_SAMPLES / SR
    reset_counts(vb, mc)
    cold_ms, sharded = host_ms(lambda: fast.render_grid_sharded(
        mesh, midis, vel, seconds, SR))
    launches["render_grid_sharded"] = counts = read_counts(vb, mc)
    check(counts["voice_bank"] == 1 and counts["mono_chain"] == 1
          and counts["plain"] == 0, f"render_grid_sharded launches {counts}")
    # a warm call, its stages timed (the first one sets up NCCL's
    # communicator at its first collective)
    timer = StageTimer()
    timer.wrap(vb, "render_voice_bank", "K1")
    timer.wrap(mc, "render", "K2")
    wall_ms, _ = host_ms(lambda: fast.render_grid_sharded(
        mesh, midis, vel, seconds, SR))
    timer.restore()
    grid = fast.render_grid(midis, vel, seconds, SR, device=dev)
    check(sharded.shape == (SHARDED_SAMPLES, streams)
          and bits_equal(sharded, grid),
          f"render_grid_sharded vs render_grid: differing "
          f"{first_diff(sharded.view(torch.int32), grid.view(torch.int32))}")
    sharded_ms = {"cold": cold_ms, "wall": wall_ms, **timer.ms}
    print(f"phase 30 render_grid_sharded over a one-rank NCCL group, "
          f"{streams} streams x 64 voices x {SHARDED_SAMPLES}: bit-identical "
          f"to render_grid; first call {cold_ms:.1f} ms, warm call "
          f"{wall_ms:.1f} ms (K1 stage {timer.ms['K1']:.1f} ms, K2 stage "
          f"{timer.ms['K2']:.1f} ms), launches {counts} [{card}]", flush=True)

    # ── phase 31: sharded_grid_render (E4) and the dry run ──
    g = np.repeat(np.arange(33.0, 97.0), 8)
    v = np.tile(np.array([1, 20, 40, 60, 80, 100, 120, 127]) / 127.0, 64)
    reset_counts(vb, mc)
    grid_ms, out = host_ms(lambda: meshlib.sharded_grid_render(
        mesh, g, v, 0.5, SR))
    launches["sharded_grid_render"] = counts = read_counts(vb, mc)
    check(counts["voice_render"] == 1 and counts["plain"] == 0,
          f"sharded_grid_render launches {counts}")
    dist.destroy_process_group()
    vparams, detuned = voice.note_on_params(g, v, SR, mlp_enabled=False)
    state = voice.init_state(vparams, detuned, v, SR,
                             voice.default_note_seed(g))
    _, whole = voice.render(vparams, state, int(0.5 * SR), device=dev)
    check(out.shape == whole.shape == (int(0.5 * SR), 512)
          and torch.equal(out.view(torch.int64), whole.view(torch.int64)),
          f"sharded_grid_render vs voice.render: differing "
          f"{first_diff(out, whole)}")
    # the spawned rank prints its lines itself; rank 0 returns them
    dry_ms, dry = host_ms(lambda: dryrun.main(1, device="cuda"))
    dry_lines = dry["lines"]
    check(len(dry_lines) == 2 and all(ln.endswith("— OK")
                                      for ln in dry_lines)
          and "platform=cuda" in dry_lines[0], f"dry run {dry_lines}")
    launches["dryrun"] = {**{k: 0 for k in counts}, **dry["launches"]}
    check(dry["launches"]["voice_render"] == 2
          and dry["launches"]["voice_bank"] == 2
          and dry["launches"]["mono_chain"] == 2
          and dry["launches"]["plain"] == 0,
          f"dry run launches {dry['launches']}")
    print(f"phase 31 sharded_grid_render 64 notes x 8 velocities x 0.5 s "
          f"(E4, one NCCL rank): {grid_ms:.1f} ms, bit-identical to "
          f"voice.render; dryrun.main(1, device='cuda') in "
          f"{dry_ms / 1e3:.1f} s: " + " | ".join(dry_lines)
          + f" (rank 0 launches {dry['launches']}) [{card}]", flush=True)

    # ── phase 32: entry()'s forward step against the plain K1 and K2 ──
    fn, args = entry.entry()
    params, vstate, ctrl, cstate = args
    timer = StageTimer()
    timer.wrap(mc, "render", "K2", keep=True)
    k1_out = []
    k1 = vb.render_voice_bank

    def recording_k1(*a, **k):
        k1_out.append(k1(*a, **k))
        return k1_out[-1]

    vb.render_voice_bank = recording_k1
    reset_counts(vb, mc)
    try:
        blk, vstate2, cstate2 = fn(*args)
        torch.cuda.synchronize()
    finally:
        vb.render_voice_bank = k1
    launches["entry"] = counts = read_counts(vb, mc)
    timer.restore()
    check(counts["voice_bank"] == 1 and counts["mono_chain"] == 1
          and counts["plain"] == 0, f"entry launches {counts}")
    check(blk.shape == (entry.T_BLOCK, entry.STREAMS)
          and bool(torch.isfinite(blk).all()), "entry block")
    p_voices, p_vst = vb.render_voice_bank_plain(
        params, entry.T_BLOCK, state=vstate, return_state=True)
    check(bits_equal(p_vst, vstate2), "entry: K1's state against its plain "
          f"version: {first_diff(p_vst.view(torch.int32), vstate2.view(torch.int32))}")
    (k1_voices, _), = k1_out
    check(bits_equal(p_voices, k1_voices), "entry: K1's voices against its "
          f"plain version: {first_diff(p_voices, k1_voices)}")
    (call,) = timer.calls["K2"]
    p_audio = p_voices.reshape(entry.T_BLOCK, entry.STREAMS,
                               entry.N_VOICES).sum(-1)
    check(torch.equal(call[0][3], p_audio),
          "entry: the lane sum of the plain K1 differs from K2's input")
    cmp = compare_chain(mc, call, LANES_REPLAY_N, "entry's block")
    head, _ = mc.render(SR, ctrl, cstate,
                        call[0][3][:LANES_REPLAY_N].contiguous())
    check(bits_equal(head, blk[:LANES_REPLAY_N]),
          "entry: K2 over the compared prefix differs from the block's head")
    block_ms = cuda_ms(lambda: fn(*args), reps=5)
    print(f"phase 32 entry() forward step, {entry.STREAMS} streams x "
          f"{entry.N_VOICES} voices x {entry.T_BLOCK}: {block_ms:.2f} ms per "
          f"block; K1 output and state bit-identical to the plain K1, K2 "
          f"over its first {LANES_REPLAY_N} samples (output and state) to "
          f"the plain K2 ({cmp['plain_ms'] / 1e3:.1f} s), launches {counts} "
          f"[{card}]", flush=True)

    # ── phase 33: the onset trainer at its usage line's size ──
    tool = runpy.run_path(os.path.join(repo, "tools",
                                       "torch_train_onset_model.py"))
    out_path = os.path.join(repo, "build", "chip_smoke", "onset_pitch.npz")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    losses = []
    loss_fn = onset_model.loss_fn

    def recording_loss(*a, **k):
        loss = loss_fn(*a, **k)
        losses.append(loss.detach())
        return loss

    onset_model.loss_fn = recording_loss
    reset_counts(vb, mc)
    so = io.StringIO()
    try:
        with contextlib.redirect_stdout(so):
            tool_ms, _ = host_ms(lambda: tool["main"](
                list(ONSET_TOOL_ARGS) + ["--out", out_path]))
    finally:
        onset_model.loss_fn = loss_fn
    launches["train_onset_model"] = counts = read_counts(vb, mc)
    check(counts["voice_bank"] == 4 and counts["mono_chain"] == 3
          and counts["plain"] == 0, f"train_onset_model launches {counts}")
    losses = torch.stack(losses).cpu().numpy()
    first, last = float(losses[0]), float(losses[-20:].mean())
    check(len(losses) == 200 and np.isfinite(losses).all()
          and last < 0.7 * first,
          f"onset training loss {first:.4f} -> {last:.4f} (last 20 steps)")
    saved = onset_model.load_params(out_path)
    check(saved is not None and int(saved["fmt"][0]) == 3,
          f"{out_path} does not reload as format 3")
    fixture = fixture_scores(out_path, dev)
    lines = [ln for ln in so.getvalue().splitlines()
             if ln.startswith(("val:", "end-to-end:", "spectral baseline:",
                               "stage seconds:"))]
    check(len(lines) == 4, f"train_onset_model output {lines}")
    print(f"phase 33 tools/torch_train_onset_model.py "
          f"{' '.join(ONSET_TOOL_ARGS)}: {tool_ms / 1e3:.1f} s; loss "
          f"{first:.4f} -> {last:.4f} (mean of the last 20 steps); "
          + "; ".join(lines) + f"; fixture mixture (hits of 4, spurious): "
          f"network {fixture['network']}, spectral {fixture['spectral']}; "
          f"reloads as format 3; launches {counts} [{card}] "
          f"({time.perf_counter() - t_p:.0f} s for phases 30-33)",
          flush=True)
    return {"sharded_ms": sharded_ms, "entry_k2": cmp,
            "dryrun_s": dry_ms / 1e3}


# ── the f64 engine batched over B engines (phase 28) ──

# The seconds the script needs after the alias sweep: E7 against its plain
# version and phase 28 (17 s and 67 s measured on an NVIDIA H100 80GB HBM3
# at 700 W before (d) drove the wide forms at two widths and (e) the
# distinct engines at 8192, which add about 90 s; each prints its own
# time). The sweep shrinks to leave them.
AFTER_ALIAS_S = 180.0
# the reference perf sweep's chord (tools/perf_sweep.py)
SWEEP_CHORD = (48, 55, 60, 63, 67, 70)
# (a)'s batches: (models, engines, samples); each engine's history before
# them; (c)'s widths and samples per call
BATCH_CASES = ((("dk", "circuit"), 5, 256), (("dk", "behavioral"), 2, 32),
               (("melange", "circuit"), 2, 32),
               (("melange", "behavioral"), 2, 32))
BATCH_HISTORY = 512
BATCH_SWEEP = ((1, 8, 32, 128), 2048)
# (d)'s widths above E2's warp bands (kernels.engine.chain_form: the
# half and thread forms) and its samples per call; (e)'s width of (a)'s
# distinct engines, tiled
THREAD_WIDTH, THREAD_WIDTH_N = 8192, 256
WIDE_WIDTHS = (THREAD_WIDTH, 16384)
DISTINCT_WIDTH = 8192
# the engines of (d)'s broadcast calls that the plain version replays
# (all rows are alike: each is the one-engine call's)
PLAIN_ROWS = 128
E2_MODELS = (("dk", "circuit"), ("melange", "circuit"),
             ("dk", "behavioral"), ("melange", "behavioral"))
# (a)'s wide case: the 8 kinds of batch_engine, WIDE_COPIES copies each
# (128 engines: 4 E2 blocks of 32, 128 E1 blocks), copy j WIDE_STEP · j
# samples further on (the steal fades, 220 samples, live in every copy)
WIDE_COPIES, WIDE_STEP, WIDE_N = 16, 8, 256


def wide_ms(bat_k, models, form):
    """Phase 28 (d)'s render_states calls of E2<models> that ran `form`:
    {path: ms}."""
    key = ", ".join(models) + ", "
    return {f"render_states {k[len(key):]} engines x {THREAD_WIDTH_N}":
            v["ms"] for k, v in bat_k["wide_rows"].items()
            if k.startswith(key) and v["form"] == form}


def warp_off_path(ek, models):
    """The kernels line's note on E2<models>'s warp form when no band of
    chain_form routes to it."""
    if band_of(ek, models, "warp"):
        return ""
    return (f"; off the path for <{models[0]}, {models[1]}>: chain_form "
            "routes no width to it, so its launches are phase 28 (d)'s "
            "forced call and its times the forced form on the path's calls")


def chain_kernel(ek, pre, pa, b):
    """read_counts' name of the E2<pre, pa> form that b engines run."""
    return kernel_name(pre, pa, ek.chain_form(pre, pa, b))


def kernel_name(pre, pa, form):
    """read_counts' name of E2<pre, pa>'s form."""
    return ("engine_chain" + ("" if (pre, pa) == ("dk", "circuit")
                              else f"_{pre}_{pa}")
            + ("" if form == "warp" else f"_{form}"))


def band_of(ek, models, form):
    """Whether some width routes E2<models> to `form`."""
    warp = ek.CHAIN_WARP_MAX_ENGINES[models]
    if form == "warp":
        return warp is None or warp > 0
    if form == "half":
        return half_band(ek, models) is not None
    half = ek.CHAIN_HALF_MAX_ENGINES[models]
    return warp is not None and half is not None


def half_band(ek, models):
    """(first, last) engines of E2<models>'s half band, None if empty
    (the last None: no upper limit)."""
    low = ek.CHAIN_WARP_MAX_ENGINES[models]
    high = ek.CHAIN_HALF_MAX_ENGINES[models]
    if low is None or high == 0 or (high is not None and high <= low):
        return None
    return low + 1, high


def band_widths(ek, models):
    """The widths at which phase 28 (d) drives E2<models>: WIDE_WIDTHS,
    and a width inside its half band and one inside its thread band where
    those miss the band."""
    widths = list(WIDE_WIDTHS)
    forms = {ek.chain_form(*models, w) for w in widths}
    half = half_band(ek, models)
    if half and "half" not in forms:
        widths.append(half[1])
    top = ek.CHAIN_HALF_MAX_ENGINES[models] if half \
        else ek.CHAIN_WARP_MAX_ENGINES[models]
    if top is not None and "thread" not in forms:
        widths.append(2 * top)
    return widths


def chain_bands(ek):
    """E2's bands, by instantiation: (warp up to, half up to)."""
    return {f"{p}, {a}": (ek.CHAIN_WARP_MAX_ENGINES[p, a],
                          ek.CHAIN_HALF_MAX_ENGINES[p, a])
            for p, a in E2_MODELS}


def batch_engine(dev, k, models=("dk", "circuit")):
    """Engine k of phase 28's distinct engines: its own chord and
    velocities, 512 samples of history; then k % 8 == 1 has rail sag off,
    2 a NaN main slot, 3 a live steal fade (the bank filled, two steals),
    4 a NaN speaker state (guard #2), 5 noise on at gain 3 (acts on the
    melange preamp), 6 its volume and character ramping, 7 a sustained
    release."""
    from openwurli_tpu_torch.engine import Engine
    from openwurli_tpu_torch.kernels import engine as ek

    e = Engine(SR, device=dev, preamp_model=models[0], pa_model=models[1])
    root = 36 + 5 * (k % 8)
    for i, step in enumerate((0, 7, 12, 16, 19)[:2 + k % 4]):
        e.note_on(root + step, 0.35 + 0.1 * i + 0.03 * (k % 5))
    e.render(BATCH_HISTORY)
    kind = k % 8
    if kind == 1:
        e.set_rail_sag(False)
    elif kind == 2:
        e.vst[ek.S_S, 1] = float("nan")
    elif kind == 3:
        for note in range(33, 33 + ek.MAX_VOICES):
            e.note_on(note, 0.5)
    elif kind == 4:
        e.chain[ek.CHAIN_OFF["spk"][0]] = float("nan")
    elif kind == 5:
        e.set_noise_enabled(True)
        e.set_noise_gain(3.0)
    elif kind == 6:
        e.set_volume(0.9)
        e.set_speaker_character(0.7)
    elif kind == 7:
        e.set_sustain(True)
        e.note_off(root)
    return e


def distinct_engines(dev, models=("dk", "circuit")):
    """Phase 28 (a)'s wide case: the 8 kinds of batch_engine (models),
    WIDE_COPIES copies each, copy j WIDE_STEP · j samples further on,
    kinds 2 and 4 keeping their NaN slot and NaN speaker state in every
    copy (engine e of kind e % 8) → (the 8 Engines, the 128 engines'
    EngineState). tools/torch_perf_sweep.py --traffic distinct tiles
    them."""
    from openwurli_tpu_torch import engine as pe
    from openwurli_tpu_torch.kernels import engine as ek

    kinds = [batch_engine(dev, k, models) for k in range(8)]
    eight = pe.stack_states([e.state for e in kinds])
    held = eight.eng_i[2, 1].clone()
    copies = []
    for _ in range(WIDE_COPIES):
        copies.append(pe.EngineState(*[x.clone() for x in eight]))
        pe.render_states(kinds[0], eight, WIDE_STEP)
    wide = pe.stack_states(copies)
    kind = torch.arange(wide.batch, device=dev) % 8
    wide.vst[kind == 2, ek.S_S, 1] = float("nan")
    wide.eng_i[kind == 2, 1] = held
    wide.chain[kind == 4, ek.CHAIN_OFF["spk"][0]] = float("nan")
    return kinds, wide


def batch_guards(ek, cp, st, vin, mono):
    """Phase 28 (a)'s guards on a batch of batch_engine kinds (engine e of
    kind e % 8): E1 (its updated inputs `vin`) fired guard #1 once in
    each kind-2 engine (the NaN slot) and nowhere else; E2 fires guard #2
    in each kind-4 engine (the NaN speaker state: a silent first sample)
    and leaves a finite state; every engine sounds."""
    out = st.chain.clone()
    o = ek.render_chain(cp, mono, out, st.rail_sag, st.noise_scale)
    fires = (vin[3][:, ek.EI_FIRES] - st.eng_i[:, ek.EI_FIRES]).tolist()
    kind = [e % 8 for e in range(st.batch)]
    check(fires == [int(k == 2) for k in kind]
          and all(float(o[e, 0]) == 0.0 for e, k in enumerate(kind)
                  if k == 4)
          and torch.isfinite(out).all().item()
          and (o.abs().amax(1) > 0).all().item(),
          f"phase 28 (a): guard #1 in the kind-2 engines alone ({fires}), "
          f"guard #2 in the kind-4 engines alone, every engine sounding "
          f"({st.batch} engines)")


def batch_phases(dev, card, launches, vb, mc, e1_tool):
    """Phase 28: E1 (a cluster of blocks per engine) and E2 (a warp per
    engine) over B distinct engines against their batched plain versions
    in all four instantiations; each engine of a batch against its own
    Engine.render; render_states' throughput from the broadcast chord; the
    thread forms above the crossovers. Adds its paths' launch counts to
    `launches`; → the batched measurements."""
    from openwurli_tpu_torch import engine as pe
    from openwurli_tpu_torch.kernels import engine as ek

    t_p = time.perf_counter()
    # (a) five distinct <dk, circuit> engines x 256, and two of each other
    # instantiation x 32, against the batched plain versions
    e1_cmp, e2_cmp = [], []
    for models, b, n in BATCH_CASES:
        kinds = range(5) if b == 5 else (0, 5)  # 5: noise on, gain 3
        engines = [batch_engine(dev, k, models) for k in kinds]
        st = pe.stack_states([e.state for e in engines])
        if b == 5:
            check(bool((st.eng_i[3, ek.MAX_VOICES:ek.SLOTS] > 0).any())
                  and not bool(st.rail_sag[1])
                  and not bool(torch.isfinite(st.chain[4]).all()),
                  "phase 28 (a): steal fades, rail sag off, guard #2 state")
        tag = f"{b} engines x {n}, <{models[0]}, {models[1]}>"
        e1_cmp.append(compare_voices(
            ek, (st.vpar, st.vst, st.vsti, st.eng_i, n, engines[0].fade_len,
                 SR), f"{tag}, distinct engines"))
        vin = [x.clone() for x in st[:4]]
        mono = ek.render_voices(*vin, n, engines[0].fade_len, SR)
        c = compare_chain_f64(
            ek, (engines[0].params, mono, st.chain, st.rail_sag,
                 st.noise_scale), f"{tag}, distinct engines ("
            + ("rail sag off, a NaN slot, steal fades, guard #2)" if b == 5
               else "noise scale 3 on one)"))
        e2_cmp.append(c)
        if b == 5:
            batch_guards(ek, engines[0].params, st, vin, mono)

    # the wide case: 128 distinct engines
    kinds, wide = distinct_engines(dev)
    b = wide.batch
    rows = [torch.unique(x.reshape(b, -1).view(torch.int64), dim=0).shape[0]
            for x in (wide.vst, wide.chain)]
    check(rows == [b, b] and int((~wide.rail_sag).sum()) == WIDE_COPIES
          and int((wide.noise_scale > 0).sum()) == WIDE_COPIES,
          f"phase 28 (a): {b} distinct engines (distinct voice and chain "
          f"rows {rows}), {WIDE_COPIES} of them with rail sag off and "
          "noise on")
    tag = (f"{b} engines x {WIDE_N}, <dk, circuit>, distinct engines "
           f"({WIDE_COPIES} of each of 8 kinds")
    e1_cmp.append(compare_voices(
        ek, (wide.vpar, wide.vst, wide.vsti, wide.eng_i, WIDE_N,
             kinds[0].fade_len, SR), tag + ")"))
    vin = [x.clone() for x in wide[:4]]
    mono = ek.render_voices(*vin, WIDE_N, kinds[0].fade_len, SR)
    wide_call = (kinds[0].params, mono, wide.chain, wide.rail_sag,
                 wide.noise_scale)
    e2_cmp.append(compare_chain_f64(
        ek, wide_call, tag + ": rail sag off, NaN slots, steal fades, guard "
        "#2, noise, ramps, releases)"))
    forms = chain_forms(ek, wide_call, f"{b} distinct engines x {WIDE_N}")
    batch_guards(ek, kinds[0].params, wide, vin, mono)
    distinct = wide  # (d) tiles these engines to DISTINCT_WIDTH
    # E1 per chunk of WIDE_N at 1, 5 and 128 of these engines, and its two
    # forms on the 128
    e1_chunk_us = {w: cuda_ms(lambda: ek.render_voices(
        *[x[:w].clone() for x in wide[:4]], WIDE_N, kinds[0].fade_len, SR),
        reps=3) * 1e3 for w in (1, 5, b)}
    e1_forms = voices_forms(ek, (*wide[:4], WIDE_N, kinds[0].fade_len, SR),
                            f"{b} distinct engines x {WIDE_N}")
    print("phase 28 (a) E1 and E2 over distinct engines bit-identical to "
          "their batched plain versions (output and state): "
          + "; ".join(f"{c['inputs']} kernel {c['ms']:.3f} ms plain "
                      f"{c['plain_ms']:.0f} ms" for c in e1_cmp + e2_cmp)
          + f"; E2's two forms bit-identical on the {b} engines, A B B A: "
          f"thread {forms['thread_ms'][0]:.3f}, warp "
          + " / ".join(f"{t:.3f}" for t in forms["warp_ms"])
          + f", thread {forms['thread_ms'][1]:.3f} ms; E1's two forms "
          f"bit-identical on them, A B B A: thread "
          f"{e1_forms['thread_ms'][0]:.3f}, lanes "
          + " / ".join(f"{t:.3f}" for t in e1_forms["lanes_ms"])
          + f", thread {e1_forms['thread_ms'][1]:.3f} ms; E1 per chunk of "
          f"{WIDE_N} (us): " + ", ".join(f"{w} engine{'s' if w > 1 else ''} "
                                         f"{v:.1f}"
                                         for w, v in e1_chunk_us.items())
          + f" [{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)

    # (b) each engine of an 8-engine batch against its own Engine.render,
    # 1024 samples in Engine.render's chunks (4 x 256)
    t_b = time.perf_counter()
    engines = [batch_engine(dev, k) for k in range(8)]
    st = pe.stack_states([e.state for e in engines])
    reset_counts(vb, mc)
    outs = []
    batch_ms, _ = host_ms(lambda: [outs.append(pe.render_states(
        engines[0], st, 256)[1]) for _ in range(4)])
    path = "render_states, 8 engines x 4 chunks of 256"
    launches[path] = counts = read_counts(vb, mc)
    check(counts["engine_voices"] == 4
          and counts[chain_kernel(ek, "dk", "circuit", 8)] == 4
          and counts["plain"] == 0, counts)
    out = torch.cat(outs, 1)
    one_ms, ones = host_ms(lambda: [e.render(1024) for e in engines])
    for k, e in enumerate(engines):
        check(same_bits(out[k], ones[k])
              and all(same_bits(getattr(st, name)[k], getattr(e, name))
                      for name in ("vst", "vsti", "eng_i", "chain")),
              f"engine {k} of the batch differs from its own render: "
              f"{first_diff(out[k], ones[k])}")
    check(torch.isfinite(out).all().item()
          and (out.abs().amax(1) > 0).all().item(),
          "the 8-engine batch finite and sounding")
    print(f"phase 28 (b) 8 distinct engines x 1024 (4 chunks of 256): each "
          f"row bit-identical to its own Engine.render (output and state); "
          f"the batch {batch_ms:.0f} ms, the 8 engines one at a time "
          f"{one_ms:.0f} ms; launches {counts} [{card}] "
          f"({time.perf_counter() - t_b:.0f} s)", flush=True)

    # (c) throughput: render_states from the broadcast chord, and from the
    # 8 distinct engines above repeated to 32
    t_c = time.perf_counter()
    chord = pe.Engine(SR, device=dev)
    for note in SWEEP_CHORD:
        chord.note_on(note, 0.95)
    base = chord.state
    widths, n = BATCH_SWEEP
    sweep = {}
    reset_counts(vb, mc)
    for b in widths:
        wide = pe.broadcast_state(base, b)
        ms, out = host_ms(lambda: pe.render_states(chord, wide, n)[1])
        check(torch.isfinite(out).all().item()
              and torch.equal(out, out[:1].expand_as(out)),
              f"broadcast chord at {b}: rows finite and equal")
        sweep[f"{b} broadcast"] = ms
    eight = pe.stack_states([e.state for e in engines])
    mixed = pe.stack_states([eight] * 4)
    sweep["32 of 8 distinct"], (_, m_out) = host_ms(
        lambda: pe.render_states(chord, mixed, n))
    path = f"render_states sweep, {widths} engines x {n}"
    launches[path] = counts = read_counts(vb, mc)
    calls = (*widths, 32)
    lanes = ek.VOICES_LANES_MAX_ENGINES
    e1 = collections.Counter("engine_voices" if lanes is None or b <= lanes
                             else "engine_voices_thread" for b in calls)
    e2 = collections.Counter(chain_kernel(ek, "dk", "circuit", b)
                             for b in calls)
    check(all(counts[k] == v for k, v in (*e1.items(), *e2.items()))
          and counts["plain"] == 0, (counts, e1, e2))
    # the 32 of 8: each row equals its kind's row of an 8-engine call on
    # the same states, output and state
    _, e_out = pe.render_states(chord, eight, n)
    for k in range(len(m_out)):
        check(same_bits(m_out[k], e_out[k % 8])
              and all(same_bits(getattr(mixed, f)[k],
                                getattr(eight, f)[k % 8])
                      for f in ("vst", "vsti", "eng_i", "chain")),
              f"32 of 8 distinct: engine {k} differs from its kind's row of "
              f"the 8-engine call: {first_diff(m_out[k], e_out[k % 8])}")
    check(torch.isfinite(m_out).all().item()
          and (m_out.abs().amax(1) > 0).all().item(),
          "32 of 8 distinct: rows finite and sounding")
    rows = {k: {"ms": ms, "us_per_base_sample": ms * 1e3 / n,
                "aggregate_rtf": int(k.split()[0]) * n / SR / (ms / 1e3)}
            for k, ms in sweep.items()}
    print("phase 28 (c) render_states x 2048 (engines: ms, us per base "
          "sample, aggregate realtime): " + "; ".join(
              f"{k} {v['ms']:.1f} ms {v['us_per_base_sample']:.1f} us "
              f"{v['aggregate_rtf']:.4f}x" for k, v in rows.items())
          + f"; launches {counts} [{card}]", flush=True)

    wide = wide_phases(dev, card, launches, vb, mc, distinct, kinds[0],
                       e1_tool)
    print(f"phase 28 took {time.perf_counter() - t_p:.0f} s", flush=True)
    return {"E1": e1_cmp + [wide.pop("E1_distinct")], "E2": e2_cmp,
            "E2_forms": forms, "E1_forms": e1_forms, **wide,
            "E1_us_per_chunk": {f"{w} engines x {WIDE_N}": v
                                for w, v in e1_chunk_us.items()},

            "batch_vs_one": {"engines": 8, "samples": 1024,
                             "batch_ms": batch_ms, "one_at_a_time_ms":
                             one_ms},
            "sweep_x2048": rows}


def wide_phases(dev, card, launches, vb, mc, distinct, kind0, e1_tool):
    """Phase 28 (d) and (e): E1's thread form and E2's half and thread
    forms above the warp bands, from the broadcast chord at WIDE_WIDTHS
    (and a width inside each band those miss) and over `distinct`
    ((a)'s distinct engines, whose first is `kind0`) tiled to
    DISTINCT_WIDTH; E1's thread form against its parent through
    `e1_tool` (voice_tool() and a future of its build). Adds its paths'
    launch counts to `launches`; → the measurements."""
    from openwurli_tpu_torch import engine as pe
    from openwurli_tpu_torch.kernels import engine as ek

    # (d) above the warp forms' bands: render_states from the broadcast
    # chord at each of WIDE_WIDTHS engines (and inside an instantiation's
    # half or thread band where neither width reaches it) in every
    # instantiation, in the form that chain_form gives there, each row
    # equal to the chord's one-engine call on the same state; E1's thread
    # form throughout
    t_d = time.perf_counter()
    lanes_max = ek.VOICES_LANES_MAX_ENGINES
    check(all(ek.chain_form(*m, w) != "warp" and lanes_max is not None
              and w > lanes_max for m in E2_MODELS for w in WIDE_WIDTHS),
          "WIDE_WIDTHS above the warp and cluster forms' bands")
    chords, widths = {}, {}
    for pre, pa in E2_MODELS:
        eng = pe.Engine(SR, device=dev, preamp_model=pre, pa_model=pa)
        for note in SWEEP_CHORD:
            eng.note_on(note, 0.95)
        chords[pre, pa] = eng
        widths[pre, pa] = band_widths(ek, (pre, pa))
    wide_rows, wide_calls, expect = {}, {}, {}
    seen = []
    real_chain = ek.render_chain

    def keep(cp, mono, state, sag, scale=0.0):
        if mono.dim() == 2 and mono.shape[0] > 1:
            seen.append((cp, mono.clone(), state.clone(), sag.clone(),
                         scale.clone()))
        return real_chain(cp, mono, state, sag, scale)

    reset_counts(vb, mc)
    for (pre, pa), eng in chords.items():
        one = pe.EngineState(*[x.clone() for x in eng.state])
        _, ref = pe.render_states(eng, one, THREAD_WIDTH_N)
        for b in widths[pre, pa]:
            wide = pe.broadcast_state(eng.state, b)
            ek.render_chain = keep
            try:
                ms, out = host_ms(lambda: pe.render_states(
                    eng, wide, THREAD_WIDTH_N)[1])
            finally:
                ek.render_chain = real_chain
            wide_calls[pre, pa, b] = seen.pop()
            check(same_bits(out, ref.expand_as(out))
                  and same_bits(wide.chain, one.chain.expand_as(wide.chain)),
                  f"<{pre}, {pa}>: {b} engines against one: "
                  f"{first_diff(out, ref.expand_as(out))}")
            form = ek.chain_form(pre, pa, b)
            name = kernel_name(pre, pa, form)
            expect[name] = expect.get(name, 0) + 1
            wide_rows[pre, pa, b] = {
                "form": form, "ms": ms,
                "aggregate_rtf": b * THREAD_WIDTH_N / SR / (ms / 1e3)}
        one_name = chain_kernel(ek, pre, pa, 1)  # the one-engine call
        expect[one_name] = expect.get(one_name, 0) + 1
    n_wide = sum(len(w) for w in widths.values())
    path = (f"render_states, {WIDE_WIDTHS} engines x {THREAD_WIDTH_N} "
            "(the wide forms), and one engine")
    launches[path] = counts = read_counts(vb, mc)
    check(counts["engine_voices_thread"] == n_wide
          and counts["engine_voices"] == len(E2_MODELS)
          and all(counts[k] == v for k, v in expect.items())
          and counts["plain"] == 0, (counts, expect))
    # a form that no band routes to (an empty band) runs on a path of its
    # own, the form forced, so that its kernel is launched: the warp form
    # at 8 engines, the half and thread forms at the widest WIDE_WIDTHS
    forced = [(m, f) for m in E2_MODELS for f in ek.CHAIN_FORMS
              if not band_of(ek, m, f)]
    if forced:
        reset_counts(vb, mc)
        for m, f in forced:
            restore = force_chain_form(ek, m, f)
            try:
                wide = pe.broadcast_state(
                    chords[m].state, 8 if f == "warp" else WIDE_WIDTHS[-1])
                pe.render_states(chords[m], wide, THREAD_WIDTH_N)
            finally:
                restore()
        path = (f"render_states x {THREAD_WIDTH_N}, forms forced that no "
                f"band routes to ({forced})")
        launches[path] = forced_counts = read_counts(vb, mc)
        check(all(forced_counts[kernel_name(*m, f)] == 1 for m, f in forced)
              and forced_counts["plain"] == 0, forced_counts)
    # E1's thread form alone at each width, A B B A against its parent
    # on the same slots
    tool, tool_build = e1_tool
    tool_dll, _ = tool_build.result()
    e1_parent = {}
    for b in WIDE_WIDTHS:
        st = pe.broadcast_state(chords["dk", "circuit"].state, b)
        e1_parent[b] = e1_against_parent(
            tool, tool_dll, ek, list(st[:4]), THREAD_WIDTH_N,
            chords["dk", "circuit"].fade_len,
            f"{b} engines x {THREAD_WIDTH_N}, the broadcast chord")
        del st
    e1_wide_ms = {b: sum(v["ms"]) / 2 for b, v in e1_parent.items()}
    # E2's thread and half forms on each recorded call, bit for bit,
    # thread, half, half, thread
    wide_forms = {key: chain_forms(
        ek, call, f"<{key[0]}, {key[1]}> {key[2]} engines x "
        f"{THREAD_WIDTH_N}, the broadcast chord", forms=("thread", "half"))
        for key, call in wide_calls.items() if key[2] in WIDE_WIDTHS}
    # the half form against its plain version over E2_REPLAY_N samples of
    # each first-width call (the thread form is the half form's bits)
    half_cmp = {}
    b0 = WIDE_WIDTHS[0]
    for pre, pa in E2_MODELS:
        cp, mono, state, sag, scale = wide_calls[pre, pa, b0]
        restore = force_chain_form(ek, (pre, pa), "half")
        try:
            half_cmp[pre, pa] = compare_chain_f64(
                ek, (cp, mono[:, :E2_REPLAY_N].contiguous(), state, sag,
                     scale), f"<{pre}, {pa}> {b0} engines x {E2_REPLAY_N}, "
                f"the broadcast chord (half form; the plain version on the "
                f"first {PLAIN_ROWS})", plain_rows=PLAIN_ROWS)
        finally:
            restore()
    # each width's bound, scaled from the first width's E2_REPLAY_N
    # samples (whose Newton counts the plain run gave): rows alike, the
    # later samples assumed to need what the first ones did
    for (pre, pa, b), row in wide_rows.items():
        row["bound_ms_scaled"] = half_cmp[pre, pa]["bound"][0] * (
            b * THREAD_WIDTH_N) / (b0 * E2_REPLAY_N)
    print(f"phase 28 (d) render_states x {THREAD_WIDTH_N} (E2 bands "
          f"{chain_bands(ek)}): "
          + "; ".join(f"<{k[0]}, {k[1]}> {k[2]} ({v['form']}) "
                      f"{v['ms']:.1f} ms = {v['aggregate_rtf']:.1f}x"
                      for k, v in wide_rows.items())
          + "; every row bit-identical to the one-engine call (the "
          f"form its band gives); launches {counts}; E2's bounds, scaled "
          "from the first "
          f"width's {E2_REPLAY_N} samples: "
          + ", ".join(f"<{k[0]}, {k[1]}> {k[2]} {v['bound_ms_scaled']:.4f} ms"
                      for k, v in wide_rows.items())
          + "; E1's thread form bit-identical to its parent (before its "
          "votes), A B B A: "
          + "; ".join(f"{b} engines {v['ms'][0]:.3f}, parent "
                      + " / ".join(f"{t:.3f}" for t in v["parent_ms"])
                      + f", {v['ms'][1]:.3f} ms" for b, v in
                      e1_parent.items())
          + "; E2's thread and half forms bit-identical, A B B A: "
          + "; ".join(f"{f['inputs'][3:]}: thread {f['thread_ms'][0]:.2f}, "
                      "half " + " / ".join(f"{t:.2f}" for t in f["half_ms"])
                      + f", thread {f['thread_ms'][1]:.2f} ms"
                      for f in wide_forms.values())
          + "; the half form bit-identical to chain_plain over "
          f"{E2_REPLAY_N} samples: "
          + "; ".join(f"<{k[0]}, {k[1]}> {v['ms']:.2f} / plain "
                      f"{v['plain_ms']:.0f} ms" for k, v in half_cmp.items())
          + f" [{card}] ({time.perf_counter() - t_d:.0f} s)", flush=True)

    # distinct engines at width: (a)'s 128 tiled to DISTINCT_WIDTH (so
    # that neighbouring engines, a warp's two segments among them,
    # differ): E1's thread form and E2's thread and half forms over WIDE_N,
    # each row equal to its engine's row of the 128-engine call (E1's
    # cluster form, E2's warp form); then E1 and the half form against
    # their plain versions over E2_REPLAY_N samples
    t_e = time.perf_counter()
    tiles = DISTINCT_WIDTH // distinct.batch
    big = pe.stack_states([distinct] * tiles)
    params, fade = kind0.params, kind0.fade_len
    v_small = [x.clone() for x in distinct[:4]]
    mono_small = ek.render_voices(*v_small, WIDE_N, fade, SR)
    st_small = distinct.chain.clone()
    out_small = ek.render_chain(params, mono_small, st_small,
                                distinct.rail_sag, distinct.noise_scale)
    v_big = [x.clone() for x in big[:4]]
    mono_big = ek.render_voices(*v_big, WIDE_N, fade, SR)

    def tiled(x):
        return x.repeat(tiles, *([1] * (x.dim() - 1)))

    check(same_bits(mono_big, tiled(mono_small))
          and all(same_bits(x, tiled(y)) for x, y in zip(v_big, v_small)),
          f"E1 at {DISTINCT_WIDTH} distinct engines against the 128-engine "
          f"call: {first_diff(mono_big, tiled(mono_small))}")
    for form in ("thread", "half"):
        restore = force_chain_form(ek, ("dk", "circuit"), form)
        try:
            st = big.chain.clone()
            o = ek.render_chain(params, mono_big, st, big.rail_sag,
                                big.noise_scale)
        finally:
            restore()
        check(same_bits(o, tiled(out_small))
              and same_bits(st, tiled(st_small)),
              f"E2's {form} form at {DISTINCT_WIDTH} engines against the "
              f"{distinct.batch}-engine call: "
              f"{first_diff(o, tiled(out_small))}")
    distinct_forms = chain_forms(
        ek, (params, mono_big, big.chain, big.rail_sag, big.noise_scale),
        f"{DISTINCT_WIDTH} distinct engines x {WIDE_N}",
        forms=("thread", "half"))
    e1_distinct = compare_voices(
        ek, (*big[:4], E2_REPLAY_N, fade, SR),
        f"{DISTINCT_WIDTH} distinct engines x {E2_REPLAY_N} (thread form)")
    restore = force_chain_form(ek, ("dk", "circuit"), "half")
    try:
        half_distinct = compare_chain_f64(
            ek, (params, mono_big[:, :E2_REPLAY_N].contiguous(), big.chain,
                 big.rail_sag, big.noise_scale),
            f"{DISTINCT_WIDTH} engines x {E2_REPLAY_N}, (a)'s "
            f"{distinct.batch} tiled (half form; the plain version on one "
            "tile)", plain_rows=distinct.batch)
    finally:
        restore()
    print(f"phase 28 (e) {DISTINCT_WIDTH} engines, (a)'s {distinct.batch} "
          f"distinct ones tiled: E1's thread form and E2's thread and half "
          f"forms bit-identical to the {distinct.batch}-engine call (cluster "
          "and warp forms), A B B A: thread "
          f"{distinct_forms['thread_ms'][0]:.2f}, half "
          + " / ".join(f"{t:.2f}" for t in distinct_forms["half_ms"])
          + f", thread {distinct_forms['thread_ms'][1]:.2f} ms; E1 "
          f"{e1_distinct['ms']:.3f} / plain {e1_distinct['plain_ms']:.0f} "
          f"ms and the half form {half_distinct['ms']:.2f} / plain "
          f"{half_distinct['plain_ms']:.0f} ms over {E2_REPLAY_N} samples, "
          f"bit-identical [{card}] ({time.perf_counter() - t_e:.0f} s)",
          flush=True)
    return {"E1_distinct": e1_distinct, "E1_thread_width_ms": e1_wide_ms,
            "E1_against_parent": list(e1_parent.values()),
            "half": {f"{k[0]}, {k[1]}": v for k, v in half_cmp.items()},
            "half_distinct": half_distinct,
            "wide_forms": {f"{k[0]}, {k[1]}, {k[2]}": v
                           for k, v in wide_forms.items()},
            "distinct_forms": distinct_forms,
            "wide_rows": {f"{k[0]}, {k[1]}, {k[2]}": v
                          for k, v in wide_rows.items()}}


def main():
    # ── phase 0: the card and the precision settings ──
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          'torch.backends.cuda.matmul.allow_tf32 is False')
    check(torch.get_float32_matmul_precision() == "highest",
          'torch.get_float32_matmul_precision() == "highest"')
    # the onset network's convolutions run with cuDNN's TF32 off (on by
    # default in PyTorch), checked inside its forward on the card
    import torch.nn.functional as F
    from openwurli_tpu_torch.calib import onset_model
    seen = []
    conv2d = F.conv2d

    def conv_probe(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*a, **k)

    F.conv2d = conv_probe
    try:
        onset_model.predict(onset_model.init_params(0),
                            np.zeros(8192), 44100.0, device="cuda")
    finally:
        F.conv2d = conv2d
    check(seen == [False, False], f"onset model cudnn.allow_tf32 {seen}")

    from openwurli_tpu_torch import _build, fast
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import mono_chain as mc
    from openwurli_tpu_torch.kernels import voice_bank as vb

    dev = "cuda"

    # ── phase 1: build ──
    # (and, beside it, tools/voice_breakdown.cu, whose E1 thread form
    # before its votes phase 28 (d) times against the library's)
    import concurrent.futures
    t0 = time.perf_counter()
    e1_pool = concurrent.futures.ThreadPoolExecutor(1)
    tool = voice_tool()
    e1_tool = (tool, e1_pool.submit(tool["build"]))
    _build.library()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_SECONDS} s)", flush=True)
    # what ptxas reports for each entry function (none if the library was
    # already built)
    for line in (_build.BUILD_LOG or "").splitlines():
        if ("Compiling entry function" in line or "stack frame" in line
                or "Used " in line):
            print("phase 1 " + " ".join(line.split()), flush=True)
    ptxas = {}
    for fn, regs in ptxas_lines(_build.BUILD_LOG).items():
        for key, name in (("voice_bank_kernelILb0E", "K1"),
                          ("voice_bank_kernelILb1E", "K3"),
                          ("trem_preroll_kernel", "K4"),
                          ("mono_chain_kernelILb0E", "K2"),
                          ("mono_chain_kernelILb1E", "K5"),
                          ("engine_voices_kernel", "E1"),
                          ("engine_voices_thread_kernel", "E1 thread"),
                          ("engine_chain_kernelILi0ELi0E",
                           "E2<dk, circuit> thread"),
                          ("engine_chain_kernelILi1ELi0E",
                           "E2<melange, circuit> thread"),
                          ("engine_chain_warp_kernelILi0ELi0E",
                           "E2<dk, circuit> warp"),
                          ("engine_chain_warp_kernelILi1ELi0E",
                           "E2<melange, circuit> warp"),
                          ("engine_chain_warp_kernelILi0ELi1E",
                           "E2<dk, behavioral> warp"),
                          ("engine_chain_warp_kernelILi1ELi1E",
                           "E2<melange, behavioral> warp"),
                          ("engine_chain_kernelILi0ELi1E",
                           "E2<dk, behavioral> thread"),
                          ("engine_chain_kernelILi1ELi1E",
                           "E2<melange, behavioral> thread"),
                          ("engine_chain_half_kernelILi0ELi0E",
                           "E2<dk, circuit> half"),
                          ("engine_chain_half_kernelILi1ELi0E",
                           "E2<melange, circuit> half"),
                          ("engine_chain_half_kernelILi0ELi1E",
                           "E2<dk, behavioral> half"),
                          ("engine_chain_half_kernelILi1ELi1E",
                           "E2<melange, behavioral> half"),
                          ("tremolo_settle_kernel", "E3"),
                          ("voice_lanes_kernelILb0E", "E4"),
                          ("voice_lanes_kernelILb1E", "E4<tap>"),
                          ("pa_speaker_scan_kernel", "E6"),
                          ("preamp_scan_kernelILi0E", "E5<dk>"),
                          ("melange_scan_kernel", "E5<melange>"),
                          ("dk_scan_kernelILi0E", "E7<diff>"),
                          ("dk_scan_kernelILi1E", "E7<shadow>"),
                          ("tremolo_scan_kernel", "E8"),
                          ("power_amp_scan_kernel", "E9")):
            if key in fn:
                ptxas[name] = dict(zip(("registers", "stack", "spill_stores",
                                        "spill_loads"), regs))
    if ptxas:
        print("phase 1 kernels' ptxas: " + "; ".join(
            f"{k} {v['registers']} registers, {v['stack']} bytes stack, "
            f"{v['spill_stores']} / {v['spill_loads']} bytes spilled"
            for k, v in sorted(ptxas.items()) if k.startswith("K")),
            flush=True)
        for name in ("K1", "K3", "K4"):
            check(ptxas[name]["stack"] == ptxas[name]["spill_stores"] == 0,
                  f"{name} uses stack or spills: {ptxas[name]}")
        # the warp kernels, and the warp step's functions (their own
        # frames): no stack, no spills
        steps = {k: function_frames(_build.BUILD_LOG, k) for k in WARP_STEP}
        print("phase 1 the warp kernels' ptxas: " + "; ".join(
            f"{k} {ptxas[k]['registers']} registers, {ptxas[k]['stack']} "
            f"bytes stack, {ptxas[k]['spill_stores']} / "
            f"{ptxas[k]['spill_loads']} bytes spilled"
            for k in WARP_KERNELS) + "; the warp step's functions (stack, "
            "spill stores, spill loads): " + "; ".join(
                f"{k} {v}" for k, v in steps.items()), flush=True)
        check(all(v and all(f == (0, 0, 0) for f in v)
                  for v in steps.values()),
              f"the warp step's functions use stack or spill: {steps}")
        # E2's half form and its segment steps' functions: no stack, no
        # spills in the steps (the kernels hold lane 0's chain rows)
        steps = {k: function_frames(_build.BUILD_LOG, k) for k in HALF_STEP}
        print("phase 1 the half kernels' ptxas: " + "; ".join(
            f"{k} {ptxas[k]['registers']} registers, {ptxas[k]['stack']} "
            f"bytes stack, {ptxas[k]['spill_stores']} / "
            f"{ptxas[k]['spill_loads']} bytes spilled"
            for k in HALF_KERNELS) + "; the segment steps' functions "
            "(stack, spill stores, spill loads): " + "; ".join(
                f"{k} {v}" for k, v in steps.items()), flush=True)
        check(all(v and all(f == (0, 0, 0) for f in v)
                  for v in steps.values()),
              f"the segment steps' functions use stack or spill: {steps}")
        # E2's behavioral thread form: its steps' functions use no stack
        # and do not spill (the kernels' own frames are EARLIER_PTXAS's)
        steps = {k: function_frames(_build.BUILD_LOG, k) for k in THREAD_STEP}
        print("phase 1 the behavioral thread form's step functions (stack, "
              "spill stores, spill loads): " + "; ".join(
                  f"{k} {v}" for k, v in steps.items()), flush=True)
        check(all(v and all(f == (0, 0, 0) for f in v)
                  for v in steps.values()),
              f"the thread steps' functions use stack or spill: {steps}")

    # ── phase 2: K1 on the card against its plain version on the card ──
    notes = np.repeat(np.arange(36, 100), 4).astype(np.float64)
    vels = np.tile([0.3, 0.6, 0.8, 0.95], 64)
    # 256 voices in 384 lanes: the last 128 lanes are padding
    params, n_act = vb.make_kernel_params(notes, vels, SR, lanes=384,
                                          device=dev)
    steady = vb.steady_limits(params)
    launches0 = vb.KERNEL_LAUNCHES
    k1_out, k1_st = vb.render_voice_bank(params, 4096, steady=steady,
                                         return_state=True)
    torch.cuda.synchronize()
    check(vb.KERNEL_LAUNCHES > launches0,
          'vb.KERNEL_LAUNCHES > launches0')
    k1_plain_ms, (p_out, p_st) = host_ms(lambda: vb.render_voice_bank_plain(
        params, 4096, steady=steady, return_state=True))
    k1_ms = cuda_ms(lambda: vb.render_voice_bank(params, 4096,
                                                 steady=steady), reps=5)
    check(torch.equal(k1_out, p_out) and bits_equal(k1_st, p_st),
          f"K1 384 lanes x 4096: output {first_diff(k1_out, p_out)}, state "
          f"{first_diff(k1_st.view(torch.int32), p_st.view(torch.int32))}")
    check(k1_out[:, n_act:].abs().max().item() == 0.0,
          "K1 padding lanes sound")
    print(f"phase 2 K1: 384 lanes x 4096 bit-identical to its plain version "
          f"(output and state), kernel {k1_ms:.3f} ms, plain "
          f"{k1_plain_ms:.1f} ms", flush=True)

    # ── phase 3: K2 on the card against its plain version on the card ──
    s_n, t_n = 8, 128
    tt = np.arange(t_n) / SR
    levels = np.linspace(0.02, 0.1, s_n)
    env = np.minimum(np.arange(t_n) / 200.0, 1.0)
    audio = torch.from_numpy(
        (env[:, None] * levels[None] * (np.sin(2 * np.pi * 220 * tt)
                                        + 0.5 * np.sin(2 * np.pi * 440 * tt)
                                        )[:, None]).astype(np.float32)
    ).to(dev)
    ctrl = mc.make_controls(SR, s_n, volume=0.5,
                            depth=np.linspace(0.0, 1.0, s_n),
                            character=np.tile([0.0, 1.0], s_n // 2),
                            device=dev)
    st0 = mc.init_state(SR, s_n, device=dev)
    launches0 = mc.KERNEL_LAUNCHES
    k2_out, k2_st = mc.render(SR, ctrl, st0, audio)
    torch.cuda.synchronize()
    check(mc.KERNEL_LAUNCHES > launches0,
          'mc.KERNEL_LAUNCHES > launches0')
    k2_plain_ms, (p2_out, p2_st) = host_ms(lambda: mc.render_chain_plain(
        mc.pack_consts(SR), ctrl, st0, audio))
    k2_ms = cuda_ms(lambda: mc.render(SR, ctrl, st0, audio))
    ko, po = k2_out.cpu().numpy(), p2_out.cpu().numpy()
    check(np.isfinite(ko).all() and np.isfinite(po).all(),
          'np.isfinite(ko).all() and np.isfinite(po).all()')
    err = ko - po
    rms = np.sqrt((po ** 2).mean(0))
    k2_db = 20 * np.log10(np.maximum(np.sqrt((err ** 2).mean(0)), 1e-30)
                          / rms)
    k2_err = np.abs(err).max()
    g0, _ = mc._OFFSETS["guard_fires"]
    check(torch.equal(k2_st[g0], p2_st[g0]),
          'torch.equal(k2_st[g0], p2_st[g0])')
    check((k2_db <= -70.0).all(), f"K2 per-stream dB {k2_db}")
    print(f"phase 3 K2: 8 streams x {t_n}, levels 0.02-0.1, per-stream "
          f"{np.array2string(k2_db, precision=1)} dB, max abs err "
          f"{k2_err:.3e}, guard fires {float(k2_st[g0].sum())}, "
          f"kernel {k2_ms:.1f} ms, plain {k2_plain_ms:.1f} ms", flush=True)

    # ── phase 4: tonal anchor through both kernels ──
    out = fast.render_chord([72.0], 120 / 127.0, 6144 / SR, device=dev)
    hs = harmonics_db(out.cpu().numpy()[2048:6144],
                      440.0 * 2 ** ((72 - 69) / 12), SR)
    for h, (got, want, tol) in enumerate(zip(hs, TONAL_GOLDEN_DB,
                                             TONAL_TOL_DB), start=1):
        check(abs(got - want) < tol,
              (h, got, want, tol))
    print("phase 4 tonal anchor H1-H6 dB: "
          f"{np.array2string(hs, precision=2)} (golden {TONAL_GOLDEN_DB})",
          flush=True)

    # ── phase 5: the main path at full width ──
    streams = 128
    midis = np.tile(np.arange(36, 100, dtype=np.float64), (streams, 1))
    vel = (0.95 + 0.0005 * np.arange(streams))[:, None] \
        * np.ones((1, midis.shape[1]))
    seconds = 43 * 1024 / SR
    reset_counts(vb, mc)
    grid = fast.render_grid(midis, vel, seconds, SR, volume=0.5, depth=0.5,
                            character=0.0, device=dev)
    torch.cuda.synchronize()
    launches = {"render_grid": read_counts(vb, mc)}
    counts = launches["render_grid"]
    check(counts["voice_bank"] >= 1 and counts["mono_chain"] >= 1
          and counts["plain"] == 0, counts)
    g = grid.cpu().numpy()
    check(g.shape == (43 * 1024, streams),
          'g.shape == (43 * 1024, streams)')
    check(np.isfinite(g).all(),
          'np.isfinite(g).all()')
    check((np.sqrt((g ** 2).mean(0)) > 0).all(),
          '(np.sqrt((g ** 2).mean(0)) > 0).all()')
    # Loud 64-note clusters drive the power amp into clipping: the
    # reference itself peaks at 1.3725 on stream 127 (sample 11017), so the
    # bound is the chain's ceiling (PA output ±1 × post gain × volume) and
    # the worst stream's peak is held to the reference's.
    ceiling = 10 ** (17.5 / 20) * 0.5
    check(np.abs(g).max() < ceiling,
          f"peak {np.abs(g).max():.4f} above the chain ceiling {ceiling:.3f}")
    peak127 = float(np.abs(g[:11264, 127]).max())
    check(abs(peak127 - REF_PEAK_127) < 0.01 * REF_PEAK_127,
          f"stream 127 peak {peak127:.4f} vs reference {REF_PEAK_127}")
    wall_ms, _ = host_ms(lambda: fast.render_grid(
        midis, vel, seconds, SR, volume=0.5, depth=0.5, character=0.0,
        device=dev))
    rtf = streams * seconds / (wall_ms / 1e3)
    print(f"phase 5 render_grid 128 streams x 64 voices x {43 * 1024} "
          f"samples: {wall_ms / 1e3:.2f} s warm call, {rtf:.1f}x realtime "
          f"aggregate, peak {np.abs(g).max():.4f} (stream 127, first 11264 "
          f"samples: {peak127:.4f}), launches {counts} "
          f"[{card}]", flush=True)

    # Where the warm call's time goes: render_grid's stages one by one.
    t_pad = 43 * 1024
    pack_ms, (params, ctrl, st0) = host_ms(lambda: (
        vb.make_kernel_params(midis.reshape(-1), vel.reshape(-1), SR,
                              lanes=streams * 64, device=dev)[0],
        mc.make_controls(SR, streams, volume=0.5, depth=0.5, character=0.0,
                         device=dev),
        mc.init_state(SR, streams, device=dev)))
    steady = vb.steady_limits(params)
    grid_params = params              # phase 19 sweeps K1's width on these
    k1_grid_ms, voices = host_ms(lambda: vb.render_voice_bank(
        params, t_pad, steady=steady))
    sum_ms, audio = host_ms(lambda: voices.reshape(t_pad, streams, 64)
                            .sum(-1).contiguous())
    k2_grid_ms, _ = host_ms(lambda: mc.render(SR, ctrl, st0, audio))
    print(f"phase 5 stages: host packing {pack_ms:.1f} ms, K1 "
          f"{k1_grid_ms:.1f} ms, lane sum {sum_ms:.2f} ms, K2 "
          f"{k2_grid_ms:.1f} ms [{card}]", flush=True)

    # ── phase 6: each kernel against its plain version at the main path's
    # shapes, on the main path's own inputs: K1 at 8192 lanes over the
    # whole render (its tile, so its renorm timing, follows the width), K2
    # at 128 streams (32 blocks of 4 warps) on the first K2_REPLAY_N
    # samples of the lane sum. Both must agree bit for bit. ──
    k1_main_ms = cuda_ms(lambda: vb.render_voice_bank(params, t_pad,
                                                      steady=steady), reps=5)
    k1_main_plain_ms, p_voices = host_ms(lambda: vb.render_voice_bank_plain(
        params, t_pad, steady=steady))
    k1_main_err = float((voices - p_voices).abs().max())
    check(torch.equal(voices, p_voices),
          f"K1 at {streams * 64} lanes x {t_pad}: max abs err "
          f"{k1_main_err:.3e} against the plain version; differing "
          f"{first_diff(voices, p_voices)}")
    t_cmp = K2_REPLAY_N
    k2_cmp = [compare_chain(mc, ((SR, ctrl, st0, audio), {}), t_cmp,
                            "render_grid's lane sum from init_state")]
    k2_main_ms, k2_main_plain_ms = k2_cmp[0]["ms"], k2_cmp[0]["plain_ms"]
    print(f"phase 6 main-path shapes: K1 {streams * 64} lanes x {t_pad} "
          f"bit-identical, kernel {k1_main_ms:.1f} ms, plain "
          f"{k1_main_plain_ms:.1f} ms; K2 {streams} streams x {t_cmp} "
          f"bit-identical (output and state), kernel {k2_main_ms:.1f} ms, "
          f"plain {k2_main_plain_ms:.1f} ms [{card}]", flush=True)

    k1_bound = voice_bank_bound(params, t_pad, 0, steady)
    k2_bound = chain_bound(streams, t_cmp)
    grid_chain = (ctrl, st0, audio)   # phase 12 compares K5 on these

    # ── phase 7: K3 (voice bank with events) against its plain version,
    # bit for bit, on a small schedule: staggered onsets, releases in all
    # three damper-ramp registers (midi < 48, < 72, >= 72), an undamped top
    # key (midi >= 92), a never-released voice, padding lanes; long enough
    # that every register passes min_release and its ramp. ──
    notes = [40.0, 50.0, 69.0, 80.0, 95.0, 60.0, 45.0, 75.0]
    vels = [0.9, 0.8, 0.85, 0.7, 0.6, 0.9, 0.8, 0.7]
    onsets = [0, 512, 1024, 2048, 160, 0, 3008, 64]
    releases = [4000, 6000, 5000, 5200, 4500, np.inf, 7000, 4100]
    params, n_act = vb.make_kernel_params(notes, vels, SR, lanes=256,
                                          onsets=onsets, releases=releases,
                                          device=dev)
    steady = vb.steady_limits(params)
    check(vb._has_events(params) and vb._min_release(params) == 4000.0,
          "phase 7 schedule facts")
    k3_out, k3_st = vb.render_voice_bank(params, 8192, steady=steady,
                                         return_state=True)
    torch.cuda.synchronize()
    p3_out, p3_st = vb.render_voice_bank_plain(
        params, 8192, steady=steady, return_state=True, events=True)
    check(torch.equal(k3_out, p3_out) and bits_equal(k3_st, p3_st),
          f"K3 256 lanes x 8192: output {first_diff(k3_out, p3_out)}, state "
          f"{first_diff(k3_st.view(torch.int32), p3_st.view(torch.int32))}")
    for k, on in enumerate(onsets):
        check(on == 0 or k3_out[:on, k].abs().max().item() == 0.0,
              f"K3 voice {k} sounds before its onset {on}")
    check(k3_out[:, n_act:].abs().max().item() == 0.0,
          "K3 padding lanes sound")
    damped = k3_out[-256:, 2].abs().max() / k3_out[4744:5000, 2].abs().max()
    ringing = k3_out[-256:, 4].abs().max() / k3_out[4244:4500, 4].abs().max()
    check(damped.item() < 0.1 < ringing.item(),
          f"damper: released voice at {damped.item():.3f} of its level, "
          f"undamped top key at {ringing.item():.3f}")
    # a schedule without events through K3 equals K1 bit for bit
    plain_params, _ = vb.make_kernel_params(notes, vels, SR, lanes=256,
                                            device=dev)
    st_p = vb.steady_limits(plain_params)
    check(torch.equal(
        vb.render_voice_bank(plain_params, 2048, steady=st_p, events=True),
        vb.render_voice_bank(plain_params, 2048, steady=st_p, events=False)),
        "K3 on a trivial schedule differs from K1")
    print("phase 7 K3: 256 lanes x 8192 with onsets and releases "
          "bit-identical to its plain version (output and state), "
          "pre-onset samples 0.0, trivial schedule equals K1", flush=True)

    # ── phase 8: K4 (tremolo pre-roll) against its plain version, bit for
    # bit: one and two updates per interval (the LDR tail in every update;
    # with one, gldr_upd_prev from the interval before) and 32 (the tail
    # only in the last two), at depths 0, 0.7 and 1, character 0 and 1,
    # 1 and 5 captures; from init_state, and from a state with the
    # tremolo's node voltages at 0 (its first updates take pnjlim's
    # limited branch on some rows) ──
    t_p8 = time.perf_counter()
    k4_cases = 0
    kicked = mc.init_state(SR, 1, device=dev)
    kicked[slice(*mc._OFFSETS["trem_vnl"])] = 0.0
    for st8 in (mc.init_state(SR, 1, device=dev), kicked):
        for stride in (mc.SUB_BASE, 2 * mc.SUB_BASE, 64):
            for depth in (0.0, 0.7, 1.0):
                for char in (0.0, 1.0):
                    c8 = mc.make_controls(SR, 1, volume=0.5, depth=depth,
                                          character=char, device=dev)
                    for n_cap in (1, 5):
                        _, caps = mc.trem_preroll(SR, c8, n_cap, stride,
                                                  state_flat=st8)
                        p_caps = mc.trem_preroll_plain(
                            mc.pack_consts(SR), c8, st8, n_cap, stride)
                        check(bits_equal(caps, p_caps),
                              f"K4 {n_cap} captures x stride {stride}, depth "
                              f"{depth}, character {char}: "
                              f"{first_diff(caps, p_caps)}")
                        k4_cases += 1
    ctrl1 = mc.make_controls(SR, 1, volume=0.5, depth=0.5, character=0.0,
                             device=dev)
    rows = mc.preroll_rows()
    print(f"phase 8 K4: {k4_cases} cases (strides {mc.SUB_BASE}, "
          f"{2 * mc.SUB_BASE}, 64 x depths 0, 0.7, 1 x character 0, 1 x 1 "
          "and 5 captures x init_state and a state with the tremolo's node "
          "voltages at 0) bit-identical to its plain version "
          f"({time.perf_counter() - t_p8:.0f} s)", flush=True)

    # ── phase 9: the serial path, fast.render_events: three notes (one per
    # damper register) with releases, block-streamed in 0.25 s blocks
    # behind the default 0.6 s warm-up ──
    ev_midis = np.array([45.0, 60.0, 76.0])
    ev_vels = np.array([0.9, 0.85, 0.8])
    ev_on = np.array([4096.0, 8192.0, 12288.0])
    ev_rel = np.array([20000.0, 21000.0, 22000.0])
    ev_seconds = 1.0
    reset_counts(vb, mc)
    ev_log = StageTimer()
    ev_log.wrap(vb, "render_voice_bank", "K3", keep=True)
    ev_log.wrap(mc, "render", "K2", keep=True)
    try:
        ser_ms, ser = host_ms(lambda: fast.render_events(
            ev_midis, ev_vels, ev_on, ev_rel, ev_seconds, SR,
            block_seconds=0.25, device=dev))
    finally:
        ev_log.restore()
    launches["render_events"] = read_counts(vb, mc)
    counts = launches["render_events"]
    # 0.25 s blocks round down to 10 tiles of 1024: 5 blocks cover 1 s
    check(counts["voice_bank_events"] == 5 and counts["mono_chain"] == 6
          and counts["voice_bank"] == 0 and counts["plain"] == 0, counts)
    check(ser.shape == (44100,) and torch.isfinite(ser).all().item(),
          "render_events shape or finiteness")
    head = ser[:4096].abs().max().item()
    body = ser[6000:20000].abs().max().item()
    tail = ser[-2000:].abs().max().item()
    check(body > 1e-3 and head < 0.01 * body and tail < 0.2 * body,
          f"render_events head {head:.2e}, body {body:.2e}, tail {tail:.2e}")
    print(f"phase 9 render_events 3 notes x {ev_seconds} s (+0.6 s warm-up, "
          f"5 blocks): {ser_ms / 1e3:.2f} s, head {head:.2e}, body "
          f"{body:.3f}, tail {tail:.2e}, launches {counts} [{card}]",
          flush=True)

    # Both kernels against their plain versions on this path's own calls,
    # bit for bit. K3: blocks 1 and 2 whole (128 lanes x 10240 from the
    # carried state; block 1 crosses min_release, block 2 holds the other
    # two releases). K2: the first K2_REPLAY_N samples of block 1 at one
    # stream,
    # from the state carried through the warm-up and block 0.
    k3_ev_err = 0.0
    for b in (1, 2):
        args, kw = ev_log.calls["K3"][b]
        check(kw["n0"] == b * 10240 and kw["events"] and args[1] == 10240
              and kw["min_release"] == 20000.0, f"block {b} call {kw}")
        e_out, e_st = vb.render_voice_bank(*args, **kw)
        pe_out, pe_st = vb.render_voice_bank_plain(*args, **kw)
        k3_ev_err = max(k3_ev_err, float((e_out - pe_out).abs().max()))
        check(torch.equal(e_out, pe_out) and bits_equal(e_st, pe_st),
              f"K3 block {b} of render_events: output "
              f"{first_diff(e_out, pe_out)}, state "
              f"{first_diff(e_st.view(torch.int32), pe_st.view(torch.int32))}")
    check(len(ev_log.calls["K2"]) == 6, "render_events chain calls")
    k2_cmp.append(compare_chain(mc, ev_log.calls["K2"][2], K2_REPLAY_N,
                                "render_events block 1 from its carried "
                                "state"))
    check(k2_cmp[-1]["peak_in"] > 1e-3, "block 1 of render_events is silent")
    print("phase 9 kernels on this path's calls: K3 blocks 1 and 2 (128 "
          "lanes x 10240 from the carried state, n0 10240 and 20480) "
          "bit-identical to the plain version (output and state); K2 "
          f"{k2_cmp[-1]['shape']} of block 1 from the carried state "
          f"bit-identical (output and state), kernel {k2_cmp[-1]['ms']:.1f} "
          f"ms, plain {k2_cmp[-1]['plain_ms']:.1f} ms [{card}]", flush=True)
    del ev_log

    # ── phase 10: the song path at full width, fast.render_events_parallel
    # with its defaults on the reference bench's pseudo-song ──
    song_s = 36.0
    s_midis, s_vels, s_on, s_rel = song_schedule(song_s)
    reset_counts(vb, mc)
    cold_ms, song = host_ms(lambda: fast.render_events_parallel(
        s_midis, s_vels, s_on, s_rel, song_s, SR, device=dev))
    launches["render_events_parallel"] = read_counts(vb, mc)
    counts = launches["render_events_parallel"]
    check(counts["voice_bank_events"] == 1 and counts["trem_preroll"] == 1
          and counts["mono_chain"] == 1 and counts["plain"] == 0, counts)
    t_song = int(round(song_s * SR))
    seg_len = -(-(-(-t_song // 128)) // mc.T_TILE) * mc.T_TILE
    n_seg = -(-t_song // seg_len)
    warm = -(-int(round(1.0 * SR)) // mc.T_TILE) * mc.T_TILE
    check((seg_len, n_seg, warm) == (13312, 120, 45056),
          (seg_len, n_seg, warm))
    check(song.shape == (t_song,) and torch.isfinite(song).all().item(),
          "song shape or finiteness")
    song_peak = song.abs().max().item()
    check(song_peak < ceiling,
          f"song peak {song_peak:.4f} above the chain ceiling {ceiling:.3f}")
    on16 = np.round(s_on / 16.0) * 16.0
    s_lens = fast._voice_lifetimes(s_midis, on16, s_rel, SR, t_song)
    seg_rms = torch.sqrt((torch.nn.functional.pad(
        song, (0, n_seg * seg_len - t_song)).reshape(n_seg, seg_len) ** 2)
        .mean(1)).cpu().numpy()
    for k in range(n_seg):
        a, b = k * seg_len, min((k + 1) * seg_len, t_song)
        # a note well inside its life somewhere in the segment
        sounding = ((on16 < b - 2048) & (on16 + 0.5 * s_lens > a)).any()
        check(not sounding or seg_rms[k] > 1e-5,
              f"segment {k} is silent (rms {seg_rms[k]:.2e}) though a note "
              "sounds in it")

    # one warm call, with its stages timed inside it
    timer = StageTimer()
    timer.wrap(vb, "render_voice_bank", "K3")
    timer.wrap(fast, "_scatter_voices", "scatter")
    timer.wrap(mc, "trem_preroll", "K4")
    timer.wrap(fast, "_segment_windows", "segment windows")
    timer.wrap(mc, "render", "K2", keep=True)
    try:
        warm_ms, song2 = host_ms(lambda: fast.render_events_parallel(
            s_midis, s_vels, s_on, s_rel, song_s, SR, device=dev))
    finally:
        timer.restore()
    check(torch.equal(song, song2), "two renders of the song differ: "
          + first_diff(song, song2))
    stage_ms = dict(timer.ms)
    stage_ms["host packing and glue"] = warm_ms - sum(timer.ms.values())
    print(f"phase 10 render_events_parallel {song_s} s, 120 notes, "
          f"{n_seg} segments x ({warm} + {seg_len}): cold call "
          f"{cold_ms / 1e3:.2f} s, warm call {warm_ms / 1e3:.2f} s = "
          f"{song_s / (warm_ms / 1e3):.2f} song seconds per wall second, "
          f"peak {song_peak:.4f}, two renders bit-identical, launches "
          f"{counts} [{card}]", flush=True)
    print("phase 10 stages of the warm call (ms): "
          + ", ".join(f"{k} {v:.1f}" for k, v in stage_ms.items())
          + f" [{card}]", flush=True)

    # the song's first 0.93 s (four 0.25 s blocks of the serial path)
    # against the serial path on the same song with the same warm-up, at
    # the reference's gate (−35 dB RMS)
    t_head = 40960
    head_ms, ser_head = host_ms(lambda: fast.render_events(
        s_midis, s_vels, s_on, s_rel, t_head / SR, SR, warm_seconds=1.0,
        block_seconds=0.25, device=dev))
    err = (song[:t_head] - ser_head).double()
    par_db = 10 * torch.log10((err ** 2).mean().clamp(min=1e-60)
                              / (ser_head.double() ** 2).mean()).item()
    check(par_db < -35.0, f"parallel vs serial {par_db:.1f} dB")
    print(f"phase 10 parallel vs serial over the first {t_head} samples: "
          f"{par_db:.1f} dB RMS (gate -35), serial render {head_ms / 1e3:.2f}"
          f" s [{card}]", flush=True)

    # ── phase 11: K3 and K4 against their plain versions at the song
    # path's shapes, on its own inputs. K3: the song's 128 lanes over a
    # prefix that crosses min_release, then a later window from the
    # kernel's own carried state. K4: the song's stride; the plain version
    # over the first interval, and captures 1-3 against the tremolo rows
    # of K2's own carried state after k·stride samples of silence. ──
    rel_local = s_rel - on16
    sp, _ = vb.make_kernel_params(s_midis, s_vels, SR, onsets=np.zeros(120),
                                  releases=rel_local, device=dev)
    s_steady = vb.steady_limits(sp)
    min_rel = vb._min_release(sp)
    t_voice = -(-int(s_lens.max()) // mc.T_TILE) * mc.T_TILE
    t_pre = 16384
    check(min_rel + 2048 < t_pre, f"min_release {min_rel} not inside {t_pre}")
    k3_main_ms = cuda_ms(lambda: vb.render_voice_bank(sp, t_voice,
                                                      steady=s_steady))
    k3_pre = vb.render_voice_bank(sp, t_pre, steady=s_steady)
    k3_plain_ms, p3_pre = host_ms(lambda: vb.render_voice_bank_plain(
        sp, t_pre, steady=s_steady, events=True))
    k3_pre_ms = cuda_ms(lambda: vb.render_voice_bank(sp, t_pre,
                                                     steady=s_steady))
    k3_err = float((k3_pre - p3_pre).abs().max())
    check(torch.equal(k3_pre, p3_pre),
          f"K3 128 lanes x {t_pre}: {first_diff(k3_pre, p3_pre)}")
    _, k3_carry = vb.render_voice_bank(sp, t_pre, steady=s_steady,
                                       return_state=True)
    w_out, w_st = vb.render_voice_bank(sp, 2048, steady=s_steady,
                                       state=k3_carry, n0=t_pre,
                                       return_state=True)
    pw_out, pw_st = vb.render_voice_bank_plain(
        sp, 2048, steady=s_steady, state=k3_carry, n0=t_pre,
        return_state=True, events=True)
    check(torch.equal(w_out, pw_out) and bits_equal(w_st, pw_st),
          f"K3 carried window at {t_pre}: {first_diff(w_out, pw_out)}")
    k3_bound = voice_bank_bound(sp, t_pre, 0, s_steady, min_rel)

    k4_main_ms, (_, caps) = host_ms(
        lambda: mc.trem_preroll(SR, ctrl1, n_seg, seg_len))
    k4_ms = cuda_ms(lambda: mc.trem_preroll(SR, ctrl1, 2, seg_len))
    k4_plain_ms, p_caps = host_ms(lambda: mc.trem_preroll_plain(
        mc.pack_consts(SR), ctrl1, mc.init_state(SR, 1, device=dev), 2,
        seg_len))
    k4_err = float((caps[:2] - p_caps).abs().max())
    check(bits_equal(caps[:2], p_caps),
          f"K4 stride {seg_len}: {first_diff(caps[:2], p_caps)}")
    st1 = mc.init_state(SR, 1, device=dev)
    silence = torch.zeros((seg_len, 1), dtype=torch.float32, device=dev)
    phase_row = [ca for name, _a, _b, ca, _cb in rows
                 if name == "trem_phase"][0]
    for k in range(1, 4):
        _, st1 = mc.render(SR, ctrl1, st1, silence)
        k2_rows = torch.cat([st1[a:b, 0] for _n, a, b, _ca, _cb in rows])
        differ = (k2_rows.view(torch.int32)
                  != caps[k].view(torch.int32)).nonzero().flatten().tolist()
        # K2 leaves trem_phase at 4.0 after an even sample count, the
        # pre-roll at 0.0; the next update zeroes it before it is read
        check(differ == [phase_row] and k2_rows[phase_row].item() == 4.0,
              f"K4 capture {k} vs K2's state: rows {differ} differ")
    k4_bound = preroll_bound(2, seg_len)
    k4_us_update = k4_ms * 1e3 / (seg_len // 2)

    print(f"phase 11 song-path shapes: K3 128 lanes x {t_pre} (min_release "
          f"{min_rel:.0f}) bit-identical, then 2048 more from its carried "
          f"state bit-identical (output and state), kernel {k3_pre_ms:.2f} "
          f"ms, plain {k3_plain_ms:.1f} ms, whole voice window {t_voice}: "
          f"{k3_main_ms:.1f} ms; K4 stride {seg_len}: first interval "
          f"bit-identical to its plain version, kernel {k4_ms:.1f} ms = "
          f"{k4_us_update:.3f} us per update, plain {k4_plain_ms:.1f} ms, "
          f"captures 1-3 equal K2's carried tremolo rows; all {n_seg} "
          f"captures {k4_main_ms:.1f} ms = "
          f"{k4_main_ms * 1e3 / ((n_seg - 1) * seg_len // 2):.3f} us per "
          f"update [{card}]", flush=True)

    # K2 on the song's own call: 120 streams (30 blocks of 4 warps) from
    # the state with the captures injected, over
    # the first 256 samples of the segment windows.
    song_call, = timer.calls["K2"]
    check(song_call[0][3].shape == (warm + seg_len, n_seg),
          "the song's chain call")
    k2_cmp.append(compare_chain(mc, song_call, 256,
                                "render_events_parallel's segment windows "
                                "from the state with K4's captures"))
    check(k2_cmp[-1]["peak_in"] > 1e-3, "the song's windows start silent")
    print(f"phase 11 K2 on the song's call: {k2_cmp[-1]['shape']} "
          f"bit-identical to the plain version (output and state), kernel "
          f"{k2_cmp[-1]['ms']:.1f} ms, plain {k2_cmp[-1]['plain_ms']:.1f} ms "
          f"[{card}]", flush=True)

    # ── phase 12: K5 (the chain with thermal noise) against its plain
    # version, bit for bit (output and state as int32), on the first
    # K5_REPLAY_N samples of phase 5's lane sum at 128 streams: at noise_level 1.0,
    # again at per-stream gains 0-30; then K5 at gain 0 against K2 on the
    # same call: equal output and non-nz_ rows, nz_lcg advanced. ──
    t_p12 = time.perf_counter()
    from openwurli_tpu_torch.kernels import probe

    _g_ctrl, g_st0, g_audio = grid_chain
    t_k5 = K5_REPLAY_N
    k5_cmp = []
    for what, level in (("noise_level 1.0", 1.0),
                        ("per-stream gains 0-30",
                         np.linspace(0.0, 30.0, streams))):
        n_ctrl = mc.make_controls(SR, streams, volume=0.5, depth=0.5,
                                  character=0.0, noise_level=level,
                                  device=dev)
        k5_cmp.append(compare_chain(
            mc, ((SR, n_ctrl, g_st0, g_audio), {"noise": True}), t_k5,
            f"render_grid's lane sum at {what}"))
    z_ctrl = mc.make_controls(SR, streams, volume=0.5, depth=0.5,
                              character=0.0, noise_level=0.0, device=dev)
    a_k5 = g_audio[:t_k5].contiguous()
    z_out, z_st = mc.render(SR, z_ctrl, g_st0, a_k5, noise=True)
    q_out, q_st = mc.render(SR, z_ctrl, g_st0, a_k5)
    nz_a, nz_b = mc._OFFSETS["nz_w"][0], mc._OFFSETS["nz_lcg"][0]
    check(bits_equal(z_out, q_out) and bits_equal(z_st[:nz_a], q_st[:nz_a]),
          "K5 at gain 0 differs from K2: output "
          f"{first_diff(z_out, q_out)}, state "
          f"{first_diff(z_st[:nz_a].view(torch.int32), q_st[:nz_a].view(torch.int32))}")
    check(not bits_equal(z_st[nz_b:], q_st[nz_b:])
          and bits_equal(q_st[nz_a:], g_st0[nz_a:]),
          "nz_lcg: K5 must advance it and K2 must leave it")
    k5_ms, k5_plain_ms = k5_cmp[0]["ms"], k5_cmp[0]["plain_ms"]
    k2_same_ms = cuda_ms(lambda: mc.render(SR, z_ctrl, g_st0, a_k5))
    print(f"phase 12 K5: {streams} streams x {t_k5} of the grid's lane sum "
          "bit-identical to its plain version (output and state) at "
          "noise_level 1.0 and at per-stream gains 0-30; at gain 0 equal to "
          "K2 in output and in every row but nz_w / nz_lcg, nz_lcg advanced; "
          f"kernel {k5_ms:.1f} ms (K2 on the same call {k2_same_ms:.1f} ms), "
          f"plain {k5_plain_ms:.1f} ms [{card}] "
          f"({time.perf_counter() - t_p12:.0f} s)", flush=True)
    k5_bound = chain_bound(streams, t_k5, noise=True)

    # ── phase 13: the noise level on the card, through fast.render_grid on
    # silence (velocity 0), 128 streams, 0.25 s, at noise_level 0, 1 and 8 ──
    t_p13 = time.perf_counter()
    sil = {}
    reset_counts(vb, mc)
    for level in (0.0, 1.0, 8.0):
        sil[level] = fast.render_grid(
            np.full((streams, 1), 60.0), 0.0, 0.25, SR, volume=0.5,
            depth=0.5, character=0.0, noise_level=level, device=dev)
    torch.cuda.synchronize()
    launches["render_grid on silence, noise_level 0, 1, 8"] = \
        read_counts(vb, mc)
    counts = launches["render_grid on silence, noise_level 0, 1, 8"]
    check(counts["mono_chain"] == 1 and counts["mono_chain_noise"] == 2
          and counts["voice_bank"] == 3 and counts["plain"] == 0, counts)
    for level, out in sil.items():
        check(out.shape == (11025, streams)
              and torch.isfinite(out).all().item(),
              f"noise_level {level}: shape or finiteness")
    quiet = sil[0.0].double()
    quiet_rms = quiet.pow(2).mean().sqrt().item()
    d1 = (sil[1.0].double() - quiet)
    d8 = (sil[8.0].double() - quiet)
    rms1, rms8 = d1.pow(2).mean().sqrt().item(), d8.pow(2).mean().sqrt().item()
    check(not torch.equal(sil[8.0], sil[0.0]), "8x noise equals the quiet render")
    check(0.0 < rms1 < rms8, f"noise RMS does not rise: {rms1} {rms8}")
    dd = torch.diff(d8[2048:], dim=0)
    dd = dd - dd.mean(0)
    cc = (dd.T @ dd) / torch.outer(dd.norm(dim=0), dd.norm(dim=0))
    neigh = torch.diagonal(cc, offset=1).abs().max().item()
    check(neigh < 0.15, f"neighbouring streams correlate at 8x: {neigh:.3f}")
    print(f"phase 13 noise on the card (render_grid on silence, {streams} "
          f"streams x 11025): quiet render RMS {quiet_rms:.3e} (the cold "
          f"chain's settling); render minus quiet at noise_level 1: RMS "
          f"{rms1:.3e} = {rms1 / quiet_rms:.3e} of quiet, at 8: {rms8:.3e} = "
          f"{rms8 / quiet_rms:.3e} of quiet, 8 over 1: {rms8 / rms1:.2f}; "
          f"neighbouring streams' first differences correlate at most "
          f"{neigh:.3f} at 8x (gate 0.15); launches {counts} [{card}] "
          f"({time.perf_counter() - t_p13:.0f} s)", flush=True)

    # ── phase 14: the interactive path at full width: FastEngine at its
    # defaults (128 lanes, blocks of 1024, on the card), precompile, then
    # the 9-block session of SESSION_SCRIPT ──
    t_p14 = time.perf_counter()
    from openwurli_tpu_torch import fast_engine, stream_host

    eng = fast_engine.FastEngine(SR)
    check((fast_engine.LANES, eng.block, eng.device.type)
          == (128, 1024, "cuda"), "the engine's defaults")
    ses = drive_session(vb, mc, eng, "FastEngine session")
    launches["FastEngine session"] = counts = ses["counts"]
    check(counts["voice_bank_events"] == SESSION_BLOCKS
          and counts["mono_chain"] == SESSION_BLOCKS
          and counts["mono_chain_noise"] == 0 and counts["voice_bank"] == 0
          and counts["plain"] == 0, counts)
    loop_audio = session_block_loop(vb, mc, eng, ses["warm_state"])
    check(np.array_equal(ses["audio"].view(np.int32),
                         loop_audio.view(np.int32)),
          "the session differs from its block loop: "
          + first_diff(torch.from_numpy(ses["audio"]),
                       torch.from_numpy(loop_audio)))
    peak = float(np.abs(ses["audio"]).max())
    check(1e-3 < peak < ceiling, f"session peak {peak}")
    check(np.abs(ses["audio"][:48]).max() < 0.05 * peak,
          "the session sounds before its first onset")
    # one engine block against the plain versions on its recorded
    # arguments: K3 whole, the chain on its first BLOCK_REPLAY_N samples
    blk_i = 4
    args, kw = ses["calls"]["K3"][blk_i]
    check(kw["n0"] == blk_i * 1024 and kw["events"] and kw["steady"] is None
          and kw["min_release"] == 0.0 and args[1] == 1024,
          f"engine block {blk_i} call {kw}")
    e_out, e_st = vb.render_voice_bank(*args, **kw)
    k3_eng_plain_ms, (pe_out, pe_st) = host_ms(
        lambda: vb.render_voice_bank_plain(*args, **kw))
    k3_eng_ms = cuda_ms(lambda: vb.render_voice_bank(*args, **kw), reps=5)
    k3_eng_err = float((e_out - pe_out).abs().max())
    check(torch.equal(e_out, pe_out) and bits_equal(e_st, pe_st),
          f"K3 engine block {blk_i}: output {first_diff(e_out, pe_out)}, "
          f"state {first_diff(e_st.view(torch.int32), pe_st.view(torch.int32))}")
    k2_cmp.append(compare_chain(mc, ses["calls"]["chain"][blk_i],
                                BLOCK_REPLAY_N,
                                f"FastEngine block {blk_i} from its carried "
                                "state"))
    check(k2_cmp[-1]["peak_in"] > 1e-3, "the engine's block 4 is silent")
    k2_blk_ms = cuda_ms(lambda: mc.render(*ses["calls"]["chain"][blk_i][0]))
    st = ses["stats"]
    print(f"phase 14 FastEngine(44100) session, {SESSION_BLOCKS} blocks of "
          f"1024 at 128 lanes: bit-identical to its block loop from the "
          f"warmed state, peak {peak:.4f}, launches {counts}; per-block "
          f"wall p50 {st['p50_ms']:.1f} ms, max {st['max_ms']:.1f} ms for "
          f"{st['chunk_ms']:.1f} ms of audio, sustained {st['rtf']:.4f}x "
          f"realtime; precompile {ses['precompile_ms'] / 1e3:.2f} s of "
          f"which the 26624-sample warm-up {ses['warm_ms'] / 1e3:.2f} s; "
          f"one block's kernels: K3 {k3_eng_ms:.3f} ms, K2 {k2_blk_ms:.1f} "
          f"ms; block {blk_i} replayed: K3 whole and K2 on "
          f"{BLOCK_REPLAY_N} samples "
          f"bit-identical to the plain versions (K3 plain "
          f"{k3_eng_plain_ms:.0f} ms, K2 kernel {k2_cmp[-1]['ms']:.1f} ms, "
          f"plain {k2_cmp[-1]['plain_ms']:.0f} ms) [{card}] "
          f"({time.perf_counter() - t_p14:.0f} s)", flush=True)
    k3_eng_bound = voice_bank_bound(args[0], 1024, blk_i * 1024,
                                    (3e38, 3e38), 0.0)

    # ── phase 15: noise through the entry point. An engine built with
    # noise=True and disabled before its warm-up renders the session
    # bit-identically to the noise-off engine (K5 at gain 0 on the real
    # path); at level 8 it differs and stays finite. ──
    t_p15 = time.perf_counter()
    eng0 = fast_engine.FastEngine(SR, noise=True)
    eng0.set_noise_enabled(False)
    ses0 = drive_session(vb, mc, eng0, "FastEngine session, noise at gain 0")
    launches["FastEngine session, noise compiled in, gain 0"] = counts0 = \
        ses0["counts"]
    check(counts0["mono_chain_noise"] == SESSION_BLOCKS
          and counts0["mono_chain"] == 0
          and counts0["voice_bank_events"] == SESSION_BLOCKS
          and counts0["plain"] == 0, counts0)
    check(np.array_equal(ses0["audio"].view(np.int32),
                         ses["audio"].view(np.int32)),
          "the noise engine at gain 0 differs from the noise-off engine: "
          + first_diff(torch.from_numpy(ses0["audio"]),
                       torch.from_numpy(ses["audio"])))
    eng8 = fast_engine.FastEngine(SR, noise=True, noise_level=8.0)
    ses8 = drive_session(vb, mc, eng8, "FastEngine session, noise level 8")
    launches["FastEngine session, noise level 8"] = counts8 = ses8["counts"]
    check(counts8["mono_chain_noise"] == SESSION_BLOCKS
          and counts8["mono_chain"] == 0 and counts8["plain"] == 0, counts8)
    check(not np.array_equal(ses8["audio"], ses["audio"]),
          "noise level 8 changes nothing")
    loop8 = session_block_loop(vb, mc, eng8, ses8["warm_state"], noise=True)
    check(np.array_equal(ses8["audio"].view(np.int32), loop8.view(np.int32)),
          "the noisy session differs from its block loop")
    k5_cmp.append(compare_chain(mc, ses8["calls"]["chain"][blk_i],
                                BLOCK_REPLAY_N,
                                f"FastEngine block {blk_i} at noise level 8 "
                                "from its carried state"))
    check(ses8["calls"]["chain"][blk_i][1] == {"noise": True},
          "the noisy engine's chain call")
    k5_blk_ms = cuda_ms(lambda: mc.render(*ses8["calls"]["chain"][blk_i][0],
                                          noise=True))
    nd = ses8["audio"].astype(np.float64) - ses["audio"]
    st8 = ses8["stats"]
    print(f"phase 15 noise through FastEngine: noise=True with "
          f"set_noise_enabled(False) before the warm-up is bit-identical to "
          f"the noise-off session, launches {counts0}; at noise_level 8 the "
          f"session is finite, equals its own block loop bit for bit and "
          f"differs from the quiet one by RMS {np.sqrt((nd ** 2).mean()):.3e}"
          f" (peak {np.abs(nd).max():.3e}), launches {counts8}; block "
          f"{blk_i}'s K5 call on {BLOCK_REPLAY_N} samples bit-identical "
          "to the plain "
          f"version, one block's K5 {k5_blk_ms:.1f} ms; per-block wall p50 "
          f"{st8['p50_ms']:.1f} ms, warm-up {ses8['warm_ms'] / 1e3:.2f} s "
          f"[{card}] ({time.perf_counter() - t_p15:.0f} s)", flush=True)

    # ── phase 16: plugin and transport: StreamHost over the fast engine,
    # NDJSON commands in, stereo float32 PCM out ──
    t_p16 = time.perf_counter()
    import io

    # the default engine is the f64 one (driven in phase 22)
    check(type(stream_host.StreamHost(SR).plugin).__name__ == "WurliPlugin",
          "StreamHost's default engine is the f64 WurliPlugin")
    reset_counts(vb, mc)
    sh = stream_host.StreamHost(SR, engine="fast")
    pcm = io.BytesIO()
    for msg in (
            {"cmd": "init", "sample_rate": SR, "block": 4096},
            {"cmd": "param", "name": "volume", "value": 0.6},
            {"cmd": "events", "events": [
                {"offset": 100, "kind": "note_on", "note": 60,
                 "velocity": 0.8},
                {"offset": 2000, "kind": "cc", "cc": 64, "value": 127},
                {"offset": 3000, "kind": "note_off", "note": 60}]},
            {"cmd": "render", "blocks": 2}):
        check(sh.handle(json.dumps(msg), pcm) is True, msg)
    check(sh.plugin.engine.is_sustain_held(), "CC64 did not reach the engine")
    check(not np.isfinite(sh.plugin.engine._releases[0]),
          "the note-off under the pedal released the voice")
    for msg in (
            {"cmd": "param", "name": "authentic_noise", "value": True},
            {"cmd": "events", "events": [
                {"offset": 10, "kind": "cc", "cc": 64, "value": 0}]},
            {"cmd": "render"}):
        check(sh.handle(json.dumps(msg), pcm) is True, msg)
    check(sh.handle('{"cmd": "quit"}', pcm) is False, "quit")
    launches["StreamHost"] = counts = read_counts(vb, mc)
    # precompile: 1 block and the warm-up; then 8 engine blocks without and
    # 4 with noise
    check(counts["voice_bank_events"] == 13 and counts["mono_chain"] == 10
          and counts["mono_chain_noise"] == 4 and counts["plain"] == 0,
          counts)
    check(not sh.plugin.engine.is_sustain_held()
          and sh.plugin.engine._releases[0] == 2 * 4096 + 10.0
          and sh.plugin.engine._volume == 0.6, "the engine behind StreamHost")
    stereo = np.frombuffer(pcm.getvalue(), np.float32).reshape(-1, 2)
    check(stereo.shape == (3 * 4096, 2) and np.isfinite(stereo).all()
          and np.array_equal(stereo[:, 0], stereo[:, 1]),
          "the PCM is not finite stereo with equal channels")
    sh_peak = float(np.abs(stereo[4096:]).max())
    check(1e-3 < sh_peak < ceiling, f"StreamHost peak {sh_peak}")
    print(f"phase 16 StreamHost(engine='fast'): init, param, events, render "
          f"x 3 blocks of 4096: stereo PCM {stereo.shape}, equal channels, "
          f"finite, peak {sh_peak:.4f}; CC64 reached the engine and held "
          f"the note-off, authentic_noise switched the last block to K5; "
          f"engine='f64' raises; launches {counts} [{card}] "
          f"({time.perf_counter() - t_p16:.0f} s)", flush=True)

    # ── phase 17: P1, the probe kernel: every probe of the tool's list at
    # its own size for 7 iterations, at 128, 64 and 1 threads per block,
    # against its plain version bit for bit (the 128-lane output row and
    # aux); then the tool's timed list ──
    t_p17 = time.perf_counter()
    import importlib.util
    import os

    for name, (_l, body, sub, lan, depth, mat, _it) in probe.PROBES.items():
        p_out, p_aux = probe.probe_plain(body, 7, sub, lan, depth, x0=0.37,
                                         mat=mat, device=dev)
        for threads in (128, 64, 1):
            out, aux = probe.run_probe(body, 7, sub, lan, depth, x0=0.37,
                                       mat=mat, threads=threads, device=dev)
            check(bits_equal(out, p_out)
                  and (aux is None) == (p_aux is None)
                  and (aux is None or bits_equal(aux, p_aux)),
                  f"P1 {name} at {threads} threads differs from its plain "
                  f"version: {first_diff(out, p_out)}")
    spec = importlib.util.spec_from_file_location(
        "torch_probe", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tools", "torch_probe.py"))
    torch_probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(torch_probe)
    reset_counts(vb, mc)
    probe_rows = torch_probe.main(["--target-s", "0.05"])
    launches["tools/torch_probe.py"] = counts = read_counts(vb, mc)
    check(counts["probe"] >= 2 * len(probe.PROBES) and counts["plain"] == 0,
          counts)
    check(len(probe_rows) == len(probe.PROBES)
          and all(r["per_iter_us"] > 0 and np.isfinite(r["chk"])
                  for r in probe_rows), "the probe list's results")
    for threads in (64, 1):
        for name in ("chain20_8x128", "ge16_128"):
            probe_rows.append(probe.measure(name, threads=threads,
                                            target_s=0.05))
    print(f"phase 17 P1: {len(probe.PROBES)} probes x (128, 64, 1) threads "
          "bit-identical to their plain versions; per-iteration times "
          "(launch subtracted): "
          + "; ".join(f"{r['name']}@{r['threads']} {r['per_iter_us']:.4f} us"
                      for r in probe_rows)
          + f" [{card}] ({time.perf_counter() - t_p17:.0f} s)", flush=True)
    # the kernels line's P1 entry: chain d=20 on (8, 128) for 2000 iterations
    p1_iters = 2000
    p1_args = ("chain", p1_iters, 8, 128, 20)
    p1_out, _ = probe.run_probe(*p1_args, device=dev)
    p1_plain_ms, (p1_ref, _) = host_ms(lambda: probe.probe_plain(
        *p1_args, device=dev))
    p1_ms = cuda_ms(lambda: probe.run_probe(*p1_args, device=dev), reps=5)
    check(bits_equal(p1_out, p1_ref), "P1 chain d=20 x 2000 iterations: "
          + first_diff(p1_out, p1_ref))
    p1_bound = bound(4 + 4 * 128, p1_iters * 20 * 2 * 8 * 128)

    # ── phase 18: K2 and K5 (one warp per stream) against their plain
    # versions bit for bit, output and state, at the widths that stress the
    # block geometry: 1 stream, 33 (a ragged last block) and 1024,
    # LANES_REPLAY_N samples each; 8 streams (64 samples) of which stream 2 takes the NaN guard (a NaN
    # in its speaker state) and the power amp's reset path (an inf in its
    # audio), the other 7 bit-identical to their run without them. Then µs
    # per base sample at 1, 8, 128 and 1024 streams x 2048. ──
    t_p18 = time.perf_counter()
    consts = mc.pack_consts(SR)

    def lanes_inputs(s_n, t_n, seed):
        rng = np.random.default_rng(seed)
        audio = torch.from_numpy((0.05 * rng.standard_normal((t_n, s_n)))
                                 .astype(np.float32)).to(dev)
        ctrl = mc.make_controls(SR, s_n, volume=0.5,
                                depth=np.linspace(0.0, 1.0, s_n),
                                character=np.tile([0.0, 1.0], s_n)[:s_n],
                                noise_level=np.linspace(0.0, 30.0, s_n),
                                device=dev)
        return ctrl, mc.init_state(SR, s_n, device=dev), audio

    lanes_cmp = []
    for s_n in (1, 33, 1024):
        ctrl, st0, audio = lanes_inputs(s_n, LANES_REPLAY_N, s_n)
        for noise in (False, True):
            lanes_cmp.append(compare_chain(
                mc, ((SR, ctrl, st0, audio), {"noise": noise}),
                LANES_REPLAY_N,
                f"{s_n} streams x {LANES_REPLAY_N} from init_state"))
    ctrl, st0, audio = lanes_inputs(8, 64, 8)
    st_g, a_g = st0.clone(), audio.clone()
    st_g[mc._OFFSETS["spk_lpf"][0], 2] = float("nan")
    a_g[32, 2] = float("inf")
    za, zb = mc._OFFSETS["pa_z"]
    others = [0, 1, 3, 4, 5, 6, 7]
    for noise in (False, True):
        ref, ref_st = mc.render(SR, ctrl, st0, audio, noise=noise)
        out, st = mc.render(SR, ctrl, st_g, a_g, noise=noise)
        p_out, p_st = mc.render_chain_plain(consts, ctrl, st_g, a_g,
                                            noise=noise)
        what = ("K5" if noise else "K2") + " guard and reset stream"
        check(bits_equal(out, p_out) and bits_equal(st, p_st),
              f"{what}: output {first_diff(out, p_out)}, state "
              f"{first_diff(st.view(torch.int32), p_st.view(torch.int32))}")
        check(st[g0].tolist() == [0.0, 0.0, 1.0] + [0.0] * 5
              and out[0, 2].item() == 0.0
              and torch.isfinite(out).all().item(),
              f"{what}: guard_fires {st[g0].tolist()}")
        check(st[za:zb, 2].abs().max().item() == 0.0
              and ref_st[za:zb, 2].abs().max().item() > 0.0,
              f"{what}: the power amp did not reset")
        check(bits_equal(out[:, others], ref[:, others])
              and bits_equal(st[:, others], ref_st[:, others]),
              f"{what}: the other streams moved")
    us_per_sample = {False: {}, True: {}}
    for s_n in (1, 8, 128, 1024):
        ctrl, st0, audio = lanes_inputs(s_n, 2048, 100 + s_n)
        for noise in (False, True):
            us_per_sample[noise][s_n] = cuda_ms(lambda: mc.render(
                SR, ctrl, st0, audio, noise=noise)) * 1e3 / 2048
    print("phase 18 K2 and K5, one warp per stream: 1, 33 and 1024 streams "
          f"x {LANES_REPLAY_N} bit-identical to the plain versions (output "
          "and state); 8 "
          "streams with the NaN guard and the power amp's reset on stream 2 "
          "bit-identical, guard_fires 1, the other 7 streams unchanged; us "
          "per base sample at 1 / 8 / 128 / 1024 streams x 2048: K2 "
          + " / ".join(f"{v:.2f}" for v in us_per_sample[False].values())
          + ", K5 " + " / ".join(f"{v:.2f}" for v in us_per_sample[True]
                                 .values())
          + f" [{card}] "
          f"({time.perf_counter() - t_p18:.0f} s)", flush=True)

    # ── phase 19: K1 and K3 (eight threads per voice lane, four lanes per
    # warp) against their plain versions bit for bit, output and state as
    # int32: 133 lanes (a multiple of neither 4 nor 32) over 2048 samples
    # across min_release and a renorm, then 2048 more from the carried
    # state; 64 lanes with NaN and inf parameters in two lanes (every other
    # lane, their warp-mates included, bit-identical, and the two lanes
    # non-finite where the plain version is); 64 lanes with the pickup
    # driven past its knee in every other lane. Then K1 timed at 128, 1024,
    # 8192 and 65536 lanes x 4096 on the headline grid's voices. ──
    t_p19 = time.perf_counter()
    rng = np.random.default_rng(19)

    def ragged_params(lanes, events):
        sched = {}
        if events:
            sched = {"onsets": 16 * rng.integers(0, 64, lanes),
                     "releases": rng.uniform(600.0, 1800.0, lanes)}
        p, _ = vb.make_kernel_params(rng.integers(36, 100, lanes)
                                     .astype(np.float64),
                                     rng.uniform(0.3, 1.0, lanes), SR,
                                     lanes=lanes, device=dev, **sched)
        return p

    def held(p, n, events, state=None, n0=0):
        kw = dict(steady=vb.steady_limits(p), state=state, n0=n0,
                  return_state=True, events=events)
        out, st = vb.render_voice_bank(p, n, **kw)
        ref, ref_st = vb.render_voice_bank_plain(p, n, **kw)
        return out, st, ref, ref_st

    lanes_err = 0.0
    for events in (False, True):
        name = "K3" if events else "K1"
        p19 = ragged_params(133, events)
        st19 = None
        for n0 in (0, 2048):
            out, st19, ref, ref_st = held(p19, 2048, events, st19, n0)
            lanes_err = max(lanes_err, float((out - ref).abs().max()))
            check(torch.equal(out, ref) and bits_equal(st19, ref_st),
                  f"{name} 133 lanes from {n0}: output {first_diff(out, ref)}"
                  f", state {first_diff(st19.view(torch.int32), ref_st.view(torch.int32))}")
        sat = ragged_params(64, events)
        sat[vb.ROW_SCAL, 6, ::2] *= 60.0
        out, st, ref, ref_st = held(sat, 2048, events)
        check(torch.equal(out, ref) and bits_equal(st, ref_st),
              f"{name} saturated pickup: {first_diff(out, ref)}")
    bad = ragged_params(64, True)
    bad[vb.ROW_COSM1, 0, 5] = float("nan")
    bad[vb.ROW_AMP, 3, 10] = float("inf")
    out, st, ref, ref_st = held(bad, 2048, True)
    keep = [v for v in range(64) if v not in (5, 10)]
    check(torch.equal(out[:, keep], ref[:, keep])
          and bits_equal(st[:, keep], ref_st[:, keep]),
          f"K3 with NaN and inf lanes: the other lanes differ: "
          f"{first_diff(out[:, keep], ref[:, keep])}")
    for v in (5, 10):
        fin = torch.isfinite(ref[:, v])
        check(not fin.all().item()
              and torch.equal(torch.isnan(out[:, v]), torch.isnan(ref[:, v]))
              and torch.equal(out[fin, v], ref[fin, v]),
              f"K3 non-finite lane {v} differs from the plain version")
    sweep = {}
    for lanes in (128, 1024, 8192, 65536):
        p = (grid_params[..., :lanes] if lanes <= grid_params.shape[-1]
             else grid_params.repeat(1, 1, lanes // grid_params.shape[-1]))
        p = p.contiguous()
        st_p = vb.steady_limits(p)
        ms = cuda_ms(lambda: vb.render_voice_bank(p, 4096, steady=st_p),
                     reps=3)
        sweep[lanes] = {"ms": ms, "us_per_group": ms * 1e3 / 512,
                        "ns_per_lane_sample": ms * 1e6 / (lanes * 4096)}
    print("phase 19 K1 and K3, eight threads per lane: 133 lanes x (2048 + "
          "2048 carried) bit-identical (output and state); 64 lanes with the "
          "pickup past its knee in every other lane bit-identical; K3 with "
          "NaN and inf parameters in lanes 5 and 10: the other 62 lanes "
          "bit-identical, the two non-finite where the plain version is; K1 "
          "x 4096 at 128 / 1024 / 8192 / 65536 lanes: "
          + " / ".join(f"{v['ms']:.3f}" for v in sweep.values())
          + " ms = " + " / ".join(f"{v['us_per_group']:.3f}"
                                  for v in sweep.values())
          + f" us per group [{card}] ({time.perf_counter() - t_p19:.0f} s)",
          flush=True)

    eng_k = engine_phases(dev, card, launches, vb, mc, fast, ptxas)
    mod_k = model_phases(dev, card, launches, vb, mc, ptxas)
    cal_k = calib_phases(dev, card, launches, vb, mc)
    stg_k = stage_phases(dev, card, launches, vb, mc, ptxas)
    par_k = parallel_phases(dev, card, launches, vb, mc)
    cli_k = cli_phases(dev, card, launches, vb, mc, ptxas)
    bat_k = batch_phases(dev, card, launches, vb, mc, e1_tool)
    e1_pool.shutdown()

    def by_path(name):
        return {path: c[name] for path, c in launches.items()}

    def entry(name, source, replaces, shape, err, ms, plain_ms, bnd, **more):
        return {"name": name, "route": "cuda",
                "source": "openwurli_tpu_torch/csrc/" + source,
                "replaces": replaces if "/" in replaces
                else "openwurli_tpu/kernels/" + replaces,
                "launches": sum(by_path(name).values()),
                "launches_by_path": by_path(name), "shape": shape,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                # no single PyTorch call computes any of these recurrences
                "library_ms": None, **more}

    lanes_k2 = [c for c in lanes_cmp if c["inputs"].startswith("K2")]
    lanes_k5 = [c for c in lanes_cmp if c["inputs"].startswith("K5")]
    kernels = [
        entry("voice_bank", "voice_bank.cu", "voice_bank.py:767",
              f"{streams * 64} lanes x {t_pad}", max(k1_main_err, lanes_err),
              k1_main_ms, k1_main_plain_ms, k1_bound, ptxas=ptxas.get("K1"),
              width_sweep_x4096=sweep,
              main_path_ms={"render_grid stage, 8192 lanes x 44032":
                            k1_grid_ms}),
        entry("mono_chain", "mono_chain.cu", "mono_chain.py:1710",
              f"{streams} streams x {t_cmp}",
              max(c["max_abs_err"] for c in k2_cmp + lanes_k2), k2_main_ms,
              k2_main_plain_ms, k2_bound, ptxas=ptxas.get("K2"),
              compared=k2_cmp + lanes_k2,
              us_per_sample_x2048=us_per_sample[False],
              main_path_ms={"render_grid 128 streams x 44032": k2_grid_ms,
                            f"render_events_parallel {n_seg} streams x "
                            f"{warm + seg_len}": stage_ms["K2"],
                            "FastEngine block, 1 stream x 1024": k2_blk_ms,
                            "FastEngine warm-up, 1 stream x 26624":
                            ses["warm_ms"]}),
        entry("voice_bank_events", "voice_bank.cu", "voice_bank.py:767",
              f"128 lanes x {t_pre}", max(k3_err, k3_ev_err), k3_pre_ms,
              k3_plain_ms, k3_bound,
              ptxas=ptxas.get("K3"),
              main_path_ms={f"128 lanes x {t_voice}": k3_main_ms,
                            "render_events_parallel stage": stage_ms["K3"],
                            "FastEngine block, 128 lanes x 1024": k3_eng_ms},
              engine_block={"max_abs_err": k3_eng_err,
                            "plain_ms": k3_eng_plain_ms,
                            "bound_ms": k3_eng_bound[0],
                            "bound_by": k3_eng_bound[1]}),
        entry("trem_preroll", "mono_chain.cu", "mono_chain.py:964",
              f"2 captures x stride {seg_len}", k4_err, k4_ms, k4_plain_ms,
              k4_bound, us_per_update=k4_us_update,
              ptxas=ptxas.get("K4"),
              main_path_ms={f"{n_seg} captures x stride {seg_len}":
                            k4_main_ms,
                            "render_events_parallel stage": stage_ms["K4"]}),
        entry("mono_chain_noise", "mono_chain.cu", "mono_chain.py:1710",
              f"{streams} streams x {t_k5}",
              max(c["max_abs_err"] for c in k5_cmp + lanes_k5), k5_ms,
              k5_plain_ms, k5_bound, ptxas=ptxas.get("K5"),
              compared=k5_cmp + lanes_k5,
              us_per_sample_x2048=us_per_sample[True],
              main_path_ms={"FastEngine block, 1 stream x 1024": k5_blk_ms,
                            "FastEngine warm-up, 1 stream x 26624":
                            ses8["warm_ms"]}),
        entry("probe", "probe.cu", "tools/tpu_probe.py:52",
              f"chain d=20 on (8, 128) x {p1_iters} iterations",
              float((p1_out - p1_ref).abs().max()), p1_ms, p1_plain_ms,
              p1_bound, per_iter_us=probe_rows),
    ]
    # the f64 engine's kernels: no Pallas kernel stands behind them
    for name, key, replaces, more in (
            ("engine_voices", "E1", "openwurli_tpu/engine.py:452",
             {"us_per_chunk": eng_k["E1"]["us_per_chunk"],
              "form": "a cluster of eight blocks per engine, eight threads "
              "per slot", "ptxas": ptxas.get("E1")}),
            ("engine_chain", "E2", "openwurli_tpu/engine.py:452",
             {k: v for k, v in eng_k["E2"].items() if k != "cmp"}
             | {"form": "a warp per engine" + warp_off_path(
                 ek, ("dk", "circuit")), "ptxas": ptxas.get(
                 "E2<dk, circuit> warp")})):
        cmps = eng_k[key]["cmp"]
        main = cmps[-1]  # the engine session's own chunk
        kernels.append(entry(
            name, "engine.cu", replaces, main["shape"],
            max(c["max_abs_err"] for c in cmps),
            main["ms_by_form"]["warp"] if key == "E2" else main["ms"],
            main["plain_ms"], main["bound"],
            compared=[{k: v for k, v in c.items() if k != "bound"}
                      | {"bound_ms": c["bound"][0]} for c in cmps], **more))
    # E1's thread form (above VOICES_LANES_MAX_ENGINES engines): its
    # comparison with the plain version at DISTINCT_WIDTH engines, timed
    # beside the cluster form on phase 28 (a)'s 128 engines and beside its
    # parent (the kernel before its votes) at each of WIDE_WIDTHS
    main = bat_k["E1"][-1]
    kernels.append(entry(
        "engine_voices_thread", "engine.cu", "openwurli_tpu/engine.py:452",
        main["shape"], main["max_abs_err"], main["ms"],
        main["plain_ms"], main["bound"], ptxas=ptxas.get("E1 thread"),
        form="a block per engine, a thread per slot, its libm behind warp "
        "votes, above VOICES_LANES_MAX_ENGINES",
        against_cluster_form=bat_k["E1_forms"],
        main_path_ms={f"render_states {b} engines x {THREAD_WIDTH_N}": ms
                      for b, ms in bat_k["E1_thread_width_ms"].items()},
        against_parent=bat_k["E1_against_parent"]))
    e3 = eng_k["E3"]
    kernels.append(entry(
        "tremolo_settle", "engine.cu", "openwurli_tpu/circuits/tremolo.py:160",
        "512 steps at 88.2 kHz", e3["max_abs_err"], e3["ms"],
        e3["plain_ms"], e3["bound"], full_settle=e3["full_settle"],
        us_per_step=e3["us_per_step"], form="one warp",
        ptxas=ptxas.get("E3")))
    # E2's other instantiations (the DK / circuit one is engine_chain)
    for models in (("melange", "circuit"), ("dk", "behavioral"),
                   ("melange", "behavioral")):
        cmps = [c for c in mod_k["E2"] if c["models"] == list(models)]
        main = cmps[-1]
        kernels.append(entry(
            f"engine_chain_{models[0]}_{models[1]}", "engine.cu",
            "openwurli_tpu/engine.py:452", main["shape"],
            max(c["max_abs_err"] for c in cmps), main["ms_by_form"]["warp"],
            main["plain_ms"], main["bound"], ptxas=ptxas.get(
                f"E2<{models[0]}, {models[1]}> warp"),
            form="a warp per engine" + warp_off_path(ek, models),
            against_thread_form=[f for f in mod_k["behavioral_forms"]
                                 if f["models"] == list(models)],
            compared=[{k: v for k, v in c.items() if k != "bound"}
                      | {"bound_ms": c["bound"][0]} for c in cmps]))
    # the thread form (above CHAIN_WARP_MAX_ENGINES engines), timed beside
    # the warp form on a call that both ran
    for name, models, forms in (
            ("engine_chain_thread", ("dk", "circuit"), bat_k["E2_forms"]),
            ("engine_chain_melange_circuit_thread", ("melange", "circuit"),
             mod_k["melange_forms"]),
            # phase 23's last behavioral call (guard #2 midway), the call
            # of the entry's main comparison
            *((f"engine_chain_{pre}_behavioral_thread", (pre, "behavioral"),
               [f for f in mod_k["behavioral_forms"]
                if f["models"] == [pre, "behavioral"]][-1])
              for pre in ("dk", "melange"))):
        main = ([c for c in mod_k["E2"] if c["models"] == list(models)]
                or [c for c in bat_k["E2"]
                    if c["models"] == list(models)])[-1]
        kernels.append(entry(
            name, "engine.cu", "openwurli_tpu/engine.py:452", main["shape"],
            main["max_abs_err"], forms["thread_ms"][0], main["plain_ms"],
            main["bound"], ptxas=ptxas.get(f"E2<{models[0]}, {models[1]}> "
                                           "thread"),
            form="a thread per engine, in its band of chain_form (if any)",
            against_warp_form=forms,
            against_half_form=[f for k, f in bat_k["wide_forms"].items()
                               if k.startswith(", ".join(models) + ",")],
            main_path_ms=wide_ms(bat_k, models, "thread")))
    # the half form (a half-warp per engine, two engines to a warp): its
    # comparison with the plain version at THREAD_WIDTH engines, timed
    # beside the thread form at WIDE_WIDTHS (and on the distinct engines),
    # and the calls of phases 20-25 that chain_form routed to it (the
    # engine session's chunks, the plugins': B = 1), each with its time in
    # the half form and its bound
    sessions = eng_k["E2"]["cmp"] + mod_k["E2"]
    for models in E2_MODELS:
        key = ", ".join(models)
        c = bat_k["half"][key]
        routed = [x | {"ms": x["ms_by_form"]["half"]} for x in sessions
                  if x["models"] == list(models) and x["form"] == "half"]
        cmps = [c] + ([bat_k["half_distinct"]]
                      if models == ("dk", "circuit") else []) + routed
        kernels.append(entry(
            kernel_name(*models, "half"), "engine.cu",
            "openwurli_tpu/engine.py:452", c["shape"],
            max(x["max_abs_err"] for x in cmps), c["ms"], c["plain_ms"],
            c["bound"], ptxas=ptxas.get(f"E2<{models[0]}, {models[1]}> "
                                         "half"),
            form="a half-warp per engine, two engines to a warp, in its "
            "band of chain_form",
            against_thread_form=[f for k, f in bat_k["wide_forms"].items()
                                 if k.startswith(key + ",")]
            + ([bat_k["distinct_forms"]] if models == ("dk", "circuit")
               else []),
            compared=[{k: v for k, v in x.items() if k != "bound"}
                      | {"bound_ms": x["bound"][0]} for x in cmps],
            main_path_ms=wide_ms(bat_k, models, "half")
            | {f"{x['inputs']} ({x['shape']})": x["ms"] for x in routed}))
    for name, key, replaces, form in (
            ("voice_render", "E4", "openwurli_tpu/voice.py:140",
             "eight threads per voice, four voices per warp"),
            ("preamp_scan_dk", "E5<dk>", "openwurli_tpu/di.py:29",
             "a warp per stream"),
            ("preamp_scan_melange", "E5<melange>",
             "openwurli_tpu/circuits/melange_preamp.py:177",
             "a warp per stream")):
        k = mod_k[key]
        cmps = k.get("compared", [k])
        kernels.append(entry(
            name, "engine.cu", replaces, k["shape"],
            max(c["max_abs_err"] for c in cmps), k["ms"], k["plain_ms"],
            k["bound"], ptxas=ptxas.get(key), form=form,
            compared=[{k_: v for k_, v in c.items()
                       if k_ not in ("bound", "compared", "main_path_ms")}
                      | {"bound_ms": c["bound"][0]} for c in cmps],
            main_path_ms=k["main_path_ms"]))
    kernels[-3]["di_stages_ms"] = mod_k["di_stages_ms"]
    # µs per sample step of render_di's grid (every voice in parallel)
    kernels[-3]["us_per_sample"] = mod_k["E4"]["us_per_sample"]
    kernels[-2]["us_per_dk_step"] = mod_k["E5<dk>"]["us_per_dk_step"]
    for name, key, replaces, more in (
            ("voice_render_tap", "E4<tap>",
             "openwurli_tpu/calib/calibrate.py:80",
             {"form": "eight threads per voice, four voices per warp",
              "us_per_sample": cal_k["E4<tap>"]["us_per_sample"]}),
            ("pa_speaker_scan", "E6", "openwurli_tpu/calib/calibrate.py:123",
             {"calibrate": cal_k["calibrate"], "pipeline": cal_k["pipeline"],
              "onsets": cal_k["onsets"], "form": "a warp per stream"})):
        k = cal_k[key]
        kernels.append(entry(
            name, "engine.cu", replaces, k["shape"],
            max(c["max_abs_err"] for c in k["compared"]), k["ms"],
            k["plain_ms"], k["bound"], ptxas=ptxas.get(key),
            compared=[{k_: v for k_, v in c.items()
                       if k_ not in ("bound", "compared", "main_path_ms")}
                      | {"bound_ms": c["bound"][0]} for c in k["compared"]],
            main_path_ms=k["main_path_ms"], **more))
    e7 = cli_k["E7"]
    kernels.append(entry(
        "dk_scan", "engine.cu", "openwurli_tpu/cli.py:34", e7["shape"],
        max(c["max_abs_err"] for c in e7["compared"]), e7["ms"],
        e7["plain_ms"], e7["bound"], ptxas=e7["ptxas"],
        also_replaces=["openwurli_tpu/cli.py:87", "openwurli_tpu/cli.py:388"],
        form="a warp per stream",
        compared=[{k_: v for k_, v in c.items() if k_ != "bound"}
                  | {"bound_ms": c["bound"][0]} for c in e7["compared"]],
        main_path_ms=e7["main_path_ms"], cli=cli_k["cli"]))
    for name, key, replaces, scan, form in (
            ("tremolo_scan", "E8", "openwurli_tpu/circuits/tremolo.py:207",
             "tools/stage_bench.py:82", "a warp per circuit"),
            ("power_amp_scan", "E9",
             "openwurli_tpu/circuits/power_amp.py:210",
             "tools/stage_bench.py:83", "a warp per stream")):
        k = stg_k[key]
        kernels.append(entry(
            name, "engine.cu", replaces, k["shape"], k["max_abs_err"],
            k["ms"], k["plain_ms"], k["bound"], ptxas=k["ptxas"],
            also_replaces=[scan], newton=k["newton"], form=form,
            main_path_ms={"tools/torch_stage_bench.py, 32 streams x 256":
                          k["stage_bench_us"] * 256 / 1e3},
            stage_bench_us=stg_k["stage_bench_us"]))

    def batched(cmps):
        return [{k_: v for k_, v in c.items() if k_ != "bound"}
                | {"bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
                for c in cmps]

    for k in kernels:
        if k["name"] == "engine_chain":
            k["melange_plugin"] = mod_k["melange_plugin"]
            k["behavioral_sessions"] = mod_k["behavioral"]
            k["alias"] = cli_k["alias"]
            k["batch_vs_one"] = bat_k["batch_vs_one"]
            k["batch_sweep_x2048"] = bat_k["sweep_x2048"]
        if k["name"] == "engine_voices":
            k["batched"] = batched(bat_k["E1"])
            k["us_per_chunk_batched"] = bat_k["E1_us_per_chunk"]
        if k["name"].startswith("engine_chain") and \
                not k["name"].endswith("_thread"):
            models = k["name"].split("_")[2:] or ["dk", "circuit"]
            k["batched"] = batched([c for c in bat_k["E2"]
                                    if c["models"] == list(models)])
    for k in kernels:
        if k["name"] == "voice_bank":
            k["main_path_ms"][f"render_grid_sharded stage, one NCCL rank, "
                              f"8192 lanes x {SHARDED_SAMPLES}"] = \
                par_k["sharded_ms"]["K1"]
        if k["name"] == "mono_chain":
            k["main_path_ms"][f"render_grid_sharded stage, one NCCL rank, "
                              f"128 streams x {SHARDED_SAMPLES}"] = \
                par_k["sharded_ms"]["K2"]
            k["compared"].append(par_k["entry_k2"])
        if k["name"] == "voice_render":
            k["dryrun_s"] = par_k["dryrun_s"]
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} was never launched on "
              "a driven path")
    print(f"chip_smoke total {time.perf_counter() - T_START:.1f} s (aim "
          f"{SCRIPT_LIMIT_S:.0f} s) [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
