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
    rendered by the port (stage 4 through E4 and E5<dk>); the onset
    extractors on the fixture mixture; and the alias-audit sweep through
    the f64 engine (E1, E2), against its golden baseline.

E3 is held to its plain version over 512 steps and its full 2 s settle at
88.2 and 96 kHz to the package data; E1 and E2 to theirs with NaN and inf
voice slots, live steal fades, a tremolo BE replay, a power-amp Newton
failure and NaN guard #2, and on one chunk of the engine session; E4
and E5<dk> on `render_di`'s own inputs (all 512 voices, the first 1000
samples, against `render_di`'s output) and at 133 ragged voices with NaN
and inf ones, E5<melange> at noise scales 0, 1 and 30, E2's other
instantiations on a kicked chunk and on 256 samples of the melange
plugin's chunk; E4<tap> and E6 on `run_calibrate`'s own inputs (all 512
streams, the first 1000 and 256 samples) and on 133 ragged streams with
NaN and inf columns.
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

    ek.VOICES_LAUNCHES = ek.SETTLE_LAUNCHES = 0
    ek.VOICES_PLAIN_CALLS = ek.CHAIN_PLAIN_CALLS = ek.SETTLE_PLAIN_CALLS = 0
    for key in ek.CHAIN_LAUNCHES_BY_MODELS:
        ek.CHAIN_LAUNCHES_BY_MODELS[key] = 0
    kr.VOICE_RENDER_LAUNCHES = kr.VOICE_RENDER_PLAIN_CALLS = 0
    kr.PREAMP_SCAN_PLAIN_CALLS = 0
    kr.VOICE_TAP_LAUNCHES = kr.VOICE_TAP_PLAIN_CALLS = 0
    kr.PA_SPEAKER_LAUNCHES = kr.PA_SPEAKER_PLAIN_CALLS = 0
    for key in kr.PREAMP_SCAN_LAUNCHES:
        kr.PREAMP_SCAN_LAUNCHES[key] = 0
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

    by_models = ek.CHAIN_LAUNCHES_BY_MODELS
    return {**vb.LAUNCHES_BY_KERNEL, "mono_chain": mc.KERNEL_LAUNCHES,
            "mono_chain_noise": mc.NOISE_KERNEL_LAUNCHES,
            "trem_preroll": mc.PREROLL_KERNEL_LAUNCHES,
            "probe": probe.KERNEL_LAUNCHES,
            "engine_voices": ek.VOICES_LAUNCHES,
            "engine_chain": by_models["dk", "circuit"],
            **{f"engine_chain_{p}_{a}": n for (p, a), n in by_models.items()
               if (p, a) != ("dk", "circuit")},
            "tremolo_settle": ek.SETTLE_LAUNCHES,
            "voice_render": kr.VOICE_RENDER_LAUNCHES,
            "preamp_scan_dk": kr.PREAMP_SCAN_LAUNCHES["dk"],
            "preamp_scan_melange": kr.PREAMP_SCAN_LAUNCHES["melange"],
            "voice_render_tap": kr.VOICE_TAP_LAUNCHES,
            "pa_speaker_scan": kr.PA_SPEAKER_LAUNCHES,
            "plain": vb.PLAIN_CALLS + mc.PLAIN_CALLS
            + mc.PREROLL_PLAIN_CALLS + probe.PLAIN_CALLS
            + ek.VOICES_PLAIN_CALLS + ek.CHAIN_PLAIN_CALLS
            + ek.SETTLE_PLAIN_CALLS + kr.VOICE_RENDER_PLAIN_CALLS
            + kr.PREAMP_SCAN_PLAIN_CALLS + kr.VOICE_TAP_PLAIN_CALLS
            + kr.PA_SPEAKER_PLAIN_CALLS}


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
    tensors in place)."""

    def __init__(self, ek):
        self.ek, self.voices, self.chain = ek, [], []
        self._v, self._c = ek.render_voices, ek.render_chain

        def voices(*args, **kw):
            self.voices.append(tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args))
            return self._v(*args, **kw)

        def chain(cp, mono, state, sag, noise_scale=0.0):
            self.chain.append((cp, mono.clone(), state.clone(), sag,
                               noise_scale))
            return self._c(cp, mono, state, sag, noise_scale)

        ek.render_voices, ek.render_chain = voices, chain

    def restore(self):
        self.ek.render_voices, self.ek.render_chain = self._v, self._c


def compare_voices(ek, call, what):
    """E1 against its plain version on one recorded call's inputs: mono
    and the updated state bit for bit; → numbers for the kernels line."""
    vpar, vst, vsti, eng_i, n, fade_len, sr = call
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
                                   + eng_i.numel()) + n) * 8
    ops = (n * ek.SLOTS * E1_OPS_SLOT_SAMPLE + (n // 16) * ek.SLOTS
           * E1_OPS_JITTER + libm.calls * LIBM_OPS)
    return {"shape": f"{ek.SLOTS} slots x {n}", "inputs": f"E1 {what}",
            "max_abs_err": float((mono - p_mono).abs().nan_to_num().max()),
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops)}


def compare_chain_f64(ek, call, what):
    """E2 against its plain version on one recorded call's inputs: output
    and chain state bit for bit; the plain run's Newton counts give the
    operations this chunk needed (for the bound)."""
    from openwurli_tpu_torch.circuits import dk_preamp, melange_preamp, mna

    cp, mono, state, sag = call[:4]
    scale = call[4] if len(call) > 4 else 0.0
    st = state.clone()
    out = ek.render_chain(cp, mono, st, sag, scale)
    p_st = state.clone()
    n0 = dict(mna.NEWTON_COUNTS)
    passes0 = dk_preamp.NEWTON_PASSES[0]
    mel0 = dict(melange_preamp.NEWTON_COUNTS)
    plain_ms, p_out = host_ms(lambda: ek.chain_plain(cp, mono, p_st, sag,
                                                     scale))
    count = {k: mna.NEWTON_COUNTS[k] - n0.get(k, 0)
             for k in mna.NEWTON_COUNTS}
    passes = dk_preamp.NEWTON_PASSES[0] - passes0
    mel = {k: melange_preamp.NEWTON_COUNTS[k] - mel0[k] for k in mel0}
    check(same_bits(out, p_out) and same_bits(st, p_st),
          f"E2 {what}: output {first_diff(out, p_out)}, state "
          f"{first_diff(st, p_st)} against the plain version")
    ms = cuda_ms(lambda: ek.render_chain(cp, mono, state.clone(), sag,
                                         scale), reps=2)
    n = mono.shape[0]
    a, _ = ek.CHAIN_OFF["sm_char"]
    rem = float(state[a + ek.SM_REM])
    designs = 1 + min(int(rem), n)
    steps = n * (2 if cp.oversample else 1)
    melange = cp.preamp_model == "melange"
    ops = (n * E2_OPS_SAMPLE + designs * E2_OPS_DESIGN
           + (0 if melange else steps * PREAMP_OPS_STEP)
           + passes * PREAMP_OPS_PASS
           + melange_ops(mel)
           + (steps * BEHAVIORAL_OPS if cp.pa_model == "behavioral" else 0)
           + mna_ops(ek.N_T, ek.M_T, ek.NB_T, count.get((4, "solves"), 0),
                     count.get((4, "iterations"), 0))
           + mna_ops(ek.N_PA, ek.M_PA, ek.NB_PA,
                     count.get((16, "solves"), 0),
                     count.get((16, "iterations"), 0)))
    n_bytes = cp.flat.size * 8 + n * 12 + 2 * ek.CHAIN_ROWS * 8
    return {"shape": f"1 engine x {n}", "inputs": f"E2 {what}",
            "models": [cp.preamp_model, cp.pa_model],
            "max_abs_err": float((out - p_out).abs().nan_to_num().max()),
            "ms": ms, "plain_ms": plain_ms, "bound": bound64(n_bytes, ops),
            "newton": {"tremolo": [count.get((4, "solves"), 0),
                                   count.get((4, "iterations"), 0)],
                       "power_amp": [count.get((16, "solves"), 0),
                                     count.get((16, "iterations"), 0)],
                       "preamp_passes": passes},
            "us_per_base_sample": ms * 1e3 / n}


def engine_phases(dev, card, launches, vb, mc, fast):
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
            full[key] = {"steps": n_steps, "ms": ms, "dv": dv, "dv_nl": dvnl}
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
    print(f"phase 20 E3: 512 steps at 88.2 kHz bit-identical to its plain "
          f"version, kernel {e3_ms:.3f} ms, plain {e3_plain_ms:.1f} ms; full "
          f"settles " + ", ".join(
              f"{k}: {v['steps']} steps {v['ms']:.0f} ms, {v['dv']:.3g} V "
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
    mono = ek.render_voices(*call)
    eng.render(4096 - 256)           # a warmed chain
    kick = eng.chain.clone()
    kick[ek.CHAIN_OFF["trem_v"][0]] += 70.0  # tremolo rings: BE replay
    spiked = mono.clone()
    spiked[40] = 30.0                # the power amp past its Newton budget
    e2_cmp = [compare_chain_f64(ek, (eng.params, spiked, kick, True),
                                "256 from a warmed state, tremolo kicked, "
                                "input spike")]
    diag = kick.clone()
    ek.render_chain(eng.params, spiked, diag, True)
    a, b = ek.CHAIN_OFF["trem_diag"]
    trem_diag = diag[a:b].tolist()
    check(trem_diag[4] > 0 and trem_diag[1] > 0,
          f"the kick reached the BE replay: tremolo diag {trem_diag}")
    nan_state = eng.chain.clone()
    nan_state[ek.CHAIN_OFF["spk"][0]] = float("nan")
    e2_cmp.append(compare_chain_f64(
        ek, (eng.params, mono, nan_state, True),
        "256, NaN in the speaker state (guard #2)"))
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
    print(f"phase 21 E1 and E2 bit-identical to their plain versions: "
          + "; ".join(f"{c['inputs']} kernel {c['ms']:.3f} ms plain "
                      f"{c['plain_ms']:.0f} ms" for c in e1_cmp + e2_cmp)
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
        sec_ms, sec = host_ms(lambda: inv.render(int(SR)))
        sec = sec.cpu().numpy()
        peak = float(np.abs(sec).max())
        check(np.isfinite(sec).all() and 0.15 < peak <= 1.02,
              f"engine peak {peak} at volume 1 (the reference's bounds "
              "0.15 < peak <= 1.0 + 0.02)")
        check(all(v == 0 for v in inv.power_amp_diag().values()),
              f"power_amp_diag {inv.power_amp_diag()}")
        launches["Engine session"] = counts = read_counts(vb, mc)
        check(counts["engine_voices"] > 0 and counts["engine_chain"] > 0
              and counts["plain"] == 0, counts)
        # replay the first 256-sample chunk of the 1 s render
        idx = next(i for i, c in enumerate(rec.chain)
                   if c[1].shape[0] == 256)
        e1_cmp.append(compare_voices(ek, rec.voices[idx],
                                     "Engine session chunk (256)"))
        e2_cmp.append(compare_chain_f64(ek, rec.chain[idx],
                                        "Engine session chunk (256)"))
    finally:
        rec.restore()
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
          and np.abs(pcm).max() > 0 and counts["engine_chain"] >= 4
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
          and np.abs(pcm).max() > 0 and counts["engine_chain"] >= 3
          and counts["plain"] == 0, f"StreamHost f64 {counts}")
    print(f"phase 22 Engine(44100): warm_up {warm_ms / 1e3:.2f} s "
          f"({int(SR * 0.6)} samples), session of 3 x 4096 (chord, 65 "
          f"notes with a steal, pedal lift) then 1 s in "
          f"{sec_ms / 1e3:.2f} s = {rtf:.3f}x realtime, peak {peak:.4f}, "
          f"power_amp_diag all 0; chunk replays bit-identical; "
          f"WurliPlugin 3 blocks of 512 and StreamHost(engine='f64') 3 "
          f"blocks: launches {counts} [{card}] "
          f"({time.perf_counter() - t_p:.0f} s)", flush=True)
    return {"E1": {"cmp": e1_cmp, "us_per_chunk": e1_us},
            "E2": {"cmp": e2_cmp, "us_per_base_sample": e2_us,
                   "warm_up_ms": warm_ms, "one_second_ms": sec_ms,
                   "realtime_factor": rtf},
            "E3": {"ms": e3_ms, "plain_ms": e3_plain_ms, "bound": e3_bound,
                   "max_abs_err": e3_err, "full_settle": full}}


# ── the render paths and the engine's other models (phases 23-25) ──

# float64 operations of csrc/engine.cu: one voice's sample in E4 (E1's
# without the gates and the slot sum; its libm calls counted from the
# data, VoiceLibm), one E5<dk> sample's oversampler (four branches of
# three sections)
E4_OPS_SAMPLE = 7 * 14 + 7 * 4 + 12 + 14
E5_OS_OPS = 4 * 3 * 4 + 2


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

    n5 = 600
    x5 = out4[:n5].clone()
    x5[100:, 9] = float("inf")
    os_sr = 2 * SR
    g5 = torch.full((g_v,), 1e-6, dtype=torch.float64, device=dev)
    g5[::5] = 1.0 / 19_000.0
    e5dk, _ = compare_preamp_scan(
        kr, "dk", os_sr, x5, kr.init_dk_state(os_sr, g_v, dev), g5,
        f"{g_v} ragged streams, NaN and inf voices, two g")

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
    e2_cmp = []
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
        mono[40] = 30.0
        e2_cmp.append(compare_chain_f64(
            ek, (eng.params, mono, kick, True, 30.0),
            f"<{models[0]}, {models[1]}> 64 from a warmed state, tremolo "
            "kicked, input spike, noise scale 30"))
    names = ("E1", "E3", "E4", "E4<tap>", "E5<dk>", "E5<melange>", "E6",
             "E2<dk, circuit>",
             "E2<melange, circuit>", "E2<dk, behavioral>",
             "E2<melange, behavioral>")
    print("phase 23 ptxas: " + "; ".join(
        f"{k} {ptxas[k]['registers']} registers, {ptxas[k]['stack']} bytes "
        f"stack, {ptxas[k]['spill_stores']} / {ptxas[k]['spill_loads']} "
        f"bytes spilled" for k in names if k in ptxas), flush=True)
    for k in ("E1", "E3", "E4", "E4<tap>"):
        if k in ptxas:
            check(ptxas[k]["spill_stores"] == 0, f"{k} spills: {ptxas[k]}")
    print("phase 23 bit-identical to their plain versions: "
          + "; ".join(f"{c['inputs']} {c['shape']} kernel {c['ms']:.3f} ms "
                      f"plain {c['plain_ms']:.0f} ms"
                      for c in (e4, e5dk, e5mel)) + "; "
          + "; ".join(f"E2{c['models']} kernel {c['ms']:.3f} ms plain "
                      f"{c['plain_ms']:.0f} ms" for c in e2_cmp)
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
          f"seconds per second; stages (ms) {di_stages}; finite; note 69 f0 "
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
        check(counts["engine_chain_melange_circuit"] > 0
              and counts["plain"] == 0, f"melange plugin {counts}")
        # replay the first 256 samples of the last 2048-sample chunk of
        # the 1 s render (the chord sounding)
        idx = max(i for i, c in enumerate(rec.chain)
                  if c[1].shape[0] == 2048)
        cp_, mono_, st_, sag_, sc_ = rec.chain[idx]
        e2_cmp.append(compare_chain_f64(
            ek, (cp_, mono_[:256].contiguous(), st_, sag_, sc_),
            "<melange, circuit> melange plugin chunk (first 256)"))
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
            name = f"engine_chain_{models[0]}_behavioral"
            check(counts[name] > 0 and counts["plain"] == 0, counts)
            beh[key] = {"ms_4096": b_ms, "peak": float(np.abs(out).max())}
    finally:
        rec.restore()
    rtf = 1000.0 / sec_ms
    print(f"phase 25 WurliPlugin(44100, preamp_model='melange') with "
          f"authentic noise: warm_up {warm_ms / 1e3:.2f} s ({int(SR * 0.6)} "
          f"samples), the chord's 1 s block in {sec_ms / 1e3:.2f} s = "
          f"{rtf:.3f}x realtime, peak {peak:.4f}; chunk replay "
          f"bit-identical; behavioral sessions (4096 samples): "
          + ", ".join(f"{k} {v['ms_4096']:.0f} ms peak {v['peak']:.4f}"
                      for k, v in beh.items())
          + f" [{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)
    return {"E4": {**e4_main, "compared": [e4_main, e4],
                   "main_path_ms": {"render_di 512 x 88200": e4_grid_ms}},
            "E5<dk>": {**e5_main, "compared": [e5_main, e5dk],
                       "main_path_ms": {"render_di 512 x 88200":
                                        e5_grid_ms}},
            "E5<melange>": {**e5mel, "main_path_ms": {
                f"physics gates 6 x {n_s}": gate_ms}},
            "E2": e2_cmp, "di_stages_ms": di_stages, "di_ms": di_ms,
            "melange_plugin": {"warm_up_ms": warm_ms, "one_second_ms": sec_ms,
                               "realtime_factor": rtf, "peak": peak},
            "behavioral": beh}


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
# (the script must end within 1200 s); a note takes ALIAS_NOTE_S (45-49 s
# measured on an NVIDIA H100 80GB HBM3 at 700 W: 67686 loud samples
# through E2).
SCRIPT_LIMIT_S = 1000.0
ALIAS_NOTE_S = 50.0
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
    onset extractors on the fixture mixture; the alias-audit sweep.
    Adds its paths' launch counts to `launches`; → the kernels'
    measurements."""
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
    n_e6 = 256
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
    x_r = di.preamp_di(t2_r[:, :] * taps.out_scale, calibrate.BASE_SR,
                       device=dev)[-160:].contiguous()
    x_r[:, 5] = float("nan")
    x_r[20:, 77] = float("inf")
    x_r[:, 31] *= 400.0                    # driven into the rails
    e6_r = compare_pa_speaker(
        kr, x_r, kr.init_pa_speaker_state(calibrate.BASE_SR, g_r, dev), 0.4,
        1.0, f"{g_r} ragged streams, NaN and inf columns, rails")
    print("phase 26 E4<tap> and E6 bit-identical to their plain versions: "
          + "; ".join(f"{c['inputs']} {c['shape']} kernel {c['ms']:.3f} ms "
                      f"plain {c['plain_ms']:.0f} ms"
                      for c in (tap_main, tap_r, e6_main, e6_r))
          + f" [{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)

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

    # ── the alias-audit sweep, circuit power amp ──
    t_p = time.perf_counter()
    baseline = json.load(open(os.path.join(repo, ALIAS_BASELINE)))
    elapsed = time.perf_counter() - T_START
    sweep = alias_audit.STIMULUS_NOTES
    if elapsed + ALIAS_NOTE_S * len(sweep) > SCRIPT_LIMIT_S:
        sweep = (84,)
    reset_counts(vb, mc)
    alias = {}
    for note in sweep:
        ms, r = host_ms(lambda: alias_audit.run_with_note(note, device=dev))
        b = baseline[str(note)]
        rust_step, rust_hf = ALIAS_RUST[note]
        check(r.max_step_up_db <= b["max_step_up_db"] + ALIAS_STEP_UP_TOL_DB
              and r.hf_band_dbc <= b["hf_band_dbc"] + ALIAS_HF_TOL_DB,
              f"alias note {note}: step-up {r.max_step_up_db:.3f} (golden "
              f"{b['max_step_up_db']:.3f}), hf {r.hf_band_dbc:.3f} (golden "
              f"{b['hf_band_dbc']:.3f})")
        check(r.max_step_up_db <= rust_step + ALIAS_STEP_UP_TOL_DB
              and r.hf_band_dbc <= rust_hf + ALIAS_RUST_HF_TOL_DB,
              f"alias note {note} against the Rust reference")
        alias[note] = {"ms": ms, "max_step_up_db": r.max_step_up_db,
                       "hf_band_dbc": r.hf_band_dbc, "f0_hz": r.f0_hz,
                       "golden": [b["max_step_up_db"], b["hf_band_dbc"]]}
    launches["alias_audit sweep"] = counts = read_counts(vb, mc)
    check(counts["engine_chain"] > 0 and counts["plain"] == 0,
          f"alias sweep launches {counts}")
    print(f"phase 26 alias sweep (circuit power amp, v=120, "
          f"{'all three notes' if len(sweep) == 3 else 'note 84 alone'}; "
          f"{elapsed:.0f} s into the script): "
          + "; ".join(f"{k}: step-up {v['max_step_up_db']:.3f} dB "
                      f"(golden {v['golden'][0]:.3f}), hf "
                      f"{v['hf_band_dbc']:.3f} dBc (golden "
                      f"{v['golden'][1]:.3f}), {v['ms'] / 1e3:.1f} s"
                      for k, v in alias.items())
          + f" [{card}] ({time.perf_counter() - t_p:.0f} s)", flush=True)
    return {"E4<tap>": {**tap_main, "compared": [tap_main, tap_r],
                        "main_path_ms": {"run_calibrate 512 x 22050":
                                         stages["E4<tap>"]}},
            "E6": {**e6_main, "compared": [e6_main, e6_r],
                   "main_path_ms": {"run_calibrate 512 x 22050":
                                    stages["E6"]}},
            "calibrate": {"ms": cal_ms, "stages_ms": stages},
            "pipeline": {"ms": pipe_ms, "stages_s": stage_s},
            "onsets": {"spectral": spectral, "network": nn,
                       "weights": weights is not None},
            "alias": alias}


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
    from openwurli_tpu_torch.kernels import mono_chain as mc
    from openwurli_tpu_torch.kernels import voice_bank as vb

    dev = "cuda"

    # ── phase 1: build ──
    t0 = time.perf_counter()
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
                          ("engine_chain_kernelILi0ELi0E", "E2<dk, circuit>"),
                          ("engine_chain_kernelILi1ELi0E",
                           "E2<melange, circuit>"),
                          ("engine_chain_kernelILi0ELi1E",
                           "E2<dk, behavioral>"),
                          ("engine_chain_kernelILi1ELi1E",
                           "E2<melange, behavioral>"),
                          ("tremolo_settle_kernel", "E3"),
                          ("voice_render_kernelILb0E", "E4"),
                          ("voice_render_kernelILb1E", "E4<tap>"),
                          ("pa_speaker_scan_kernel", "E6"),
                          ("preamp_scan_kernelILi0E", "E5<dk>"),
                          ("preamp_scan_kernelILi1E", "E5<melange>")):
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
    # at 128 streams (32 blocks of 4 warps) on the first 256 samples of the
    # lane sum. Both must agree bit for bit. ──
    k1_main_ms = cuda_ms(lambda: vb.render_voice_bank(params, t_pad,
                                                      steady=steady), reps=5)
    k1_main_plain_ms, p_voices = host_ms(lambda: vb.render_voice_bank_plain(
        params, t_pad, steady=steady))
    k1_main_err = float((voices - p_voices).abs().max())
    check(torch.equal(voices, p_voices),
          f"K1 at {streams * 64} lanes x {t_pad}: max abs err "
          f"{k1_main_err:.3e} against the plain version; differing "
          f"{first_diff(voices, p_voices)}")
    t_cmp = 256
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
    # two releases). K2: the first 256 samples of block 1 at one stream,
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
    k2_cmp.append(compare_chain(mc, ev_log.calls["K2"][2], 256,
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
    # version, bit for bit (output and state as int32), on the first 256
    # samples of phase 5's lane sum at 128 streams: at noise_level 1.0,
    # again at per-stream gains 0-30; then K5 at gain 0 against K2 on the
    # same call: equal output and non-nz_ rows, nz_lcg advanced. ──
    t_p12 = time.perf_counter()
    from openwurli_tpu_torch.kernels import probe

    _g_ctrl, g_st0, g_audio = grid_chain
    t_k5 = 256
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
    # arguments: K3 whole, the chain on its first 256 samples
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
    k2_cmp.append(compare_chain(mc, ses["calls"]["chain"][blk_i], 256,
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
          f"ms; block {blk_i} replayed: K3 whole and K2 on 256 samples "
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
    k5_cmp.append(compare_chain(mc, ses8["calls"]["chain"][blk_i], 256,
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
          f"{blk_i}'s K5 call on 256 samples bit-identical to the plain "
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
    # block geometry: 1 stream, 33 (a ragged last block) and 1024, 64
    # samples each; 8 streams of which stream 2 takes the NaN guard (a NaN
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
        ctrl, st0, audio = lanes_inputs(s_n, 64, s_n)
        for noise in (False, True):
            lanes_cmp.append(compare_chain(
                mc, ((SR, ctrl, st0, audio), {"noise": noise}), 64,
                f"{s_n} streams x 64 from init_state"))
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
          "x 64 bit-identical to the plain versions (output and state); 8 "
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

    eng_k = engine_phases(dev, card, launches, vb, mc, fast)
    mod_k = model_phases(dev, card, launches, vb, mc, ptxas)
    cal_k = calib_phases(dev, card, launches, vb, mc)

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
             {"us_per_chunk": eng_k["E1"]["us_per_chunk"]}),
            ("engine_chain", "E2", "openwurli_tpu/engine.py:452",
             {k: v for k, v in eng_k["E2"].items() if k != "cmp"})):
        cmps = eng_k[key]["cmp"]
        main = cmps[-1]  # the engine session's own chunk
        kernels.append(entry(
            name, "engine.cu", replaces, main["shape"],
            max(c["max_abs_err"] for c in cmps), main["ms"],
            main["plain_ms"], main["bound"],
            compared=[{k: v for k, v in c.items() if k != "bound"}
                      | {"bound_ms": c["bound"][0]} for c in cmps], **more))
    e3 = eng_k["E3"]
    kernels.append(entry(
        "tremolo_settle", "engine.cu", "openwurli_tpu/circuits/tremolo.py:160",
        "512 steps at 88.2 kHz", e3["max_abs_err"], e3["ms"],
        e3["plain_ms"], e3["bound"],
        full_settle=e3["full_settle"]))
    # E2's other instantiations (the DK / circuit one is engine_chain)
    for models in (("melange", "circuit"), ("dk", "behavioral"),
                   ("melange", "behavioral")):
        cmps = [c for c in mod_k["E2"] if c["models"] == list(models)]
        main = cmps[-1]
        kernels.append(entry(
            f"engine_chain_{models[0]}_{models[1]}", "engine.cu",
            "openwurli_tpu/engine.py:452", main["shape"],
            max(c["max_abs_err"] for c in cmps), main["ms"],
            main["plain_ms"], main["bound"], ptxas=ptxas.get(
                f"E2<{models[0]}, {models[1]}>"),
            compared=[{k: v for k, v in c.items() if k != "bound"}
                      | {"bound_ms": c["bound"][0]} for c in cmps]))
    for name, key, replaces in (
            ("voice_render", "E4", "openwurli_tpu/voice.py:140"),
            ("preamp_scan_dk", "E5<dk>", "openwurli_tpu/di.py:29"),
            ("preamp_scan_melange", "E5<melange>",
             "openwurli_tpu/circuits/melange_preamp.py:177")):
        k = mod_k[key]
        cmps = k.get("compared", [k])
        kernels.append(entry(
            name, "engine.cu", replaces, k["shape"],
            max(c["max_abs_err"] for c in cmps), k["ms"], k["plain_ms"],
            k["bound"], ptxas=ptxas.get(key),
            compared=[{k_: v for k_, v in c.items()
                       if k_ not in ("bound", "compared", "main_path_ms")}
                      | {"bound_ms": c["bound"][0]} for c in cmps],
            main_path_ms=k["main_path_ms"]))
    kernels[-3]["di_stages_ms"] = mod_k["di_stages_ms"]
    for name, key, replaces, more in (
            ("voice_render_tap", "E4<tap>",
             "openwurli_tpu/calib/calibrate.py:80", {}),
            ("pa_speaker_scan", "E6", "openwurli_tpu/calib/calibrate.py:123",
             {"calibrate": cal_k["calibrate"], "pipeline": cal_k["pipeline"],
              "onsets": cal_k["onsets"], "alias": cal_k["alias"]})):
        k = cal_k[key]
        kernels.append(entry(
            name, "engine.cu", replaces, k["shape"],
            max(c["max_abs_err"] for c in k["compared"]), k["ms"],
            k["plain_ms"], k["bound"], ptxas=ptxas.get(key),
            compared=[{k_: v for k_, v in c.items()
                       if k_ not in ("bound", "compared", "main_path_ms")}
                      | {"bound_ms": c["bound"][0]} for c in k["compared"]],
            main_path_ms=k["main_path_ms"], **more))
    for k in kernels:
        if k["name"] == "engine_chain":
            k["melange_plugin"] = mod_k["melange_plugin"]
            k["behavioral_sessions"] = mod_k["behavioral"]
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} was never launched on "
              "a driven path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
