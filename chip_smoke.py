"""Drive the PyTorch port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from openwurli_tpu_torch/csrc, compares each
kernel with its plain torch version on the card, checks the tonal anchor
against the reference's golden harmonics, then renders the headline grid
(128 streams × 64 voices, 43·1024 samples at 44.1 kHz) through
`openwurli_tpu_torch.fast.render_grid`, checks that both kernels carried
it, and holds each kernel bit for bit to its plain version at the shapes
that render gives it. Any failed check raises: the script exits non-zero
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

    from openwurli_tpu_torch import _build, fast
    from openwurli_tpu_torch.kernels import mono_chain as mc
    from openwurli_tpu_torch.kernels import voice_bank as vb

    dev = "cuda"

    # ── phase 1: build ──
    t0 = time.perf_counter()
    _build.library()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.BUILD_SECONDS} s)", flush=True)

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
    ko, po = k1_out.cpu().numpy(), p_out.cpu().numpy()
    peak = np.abs(po[:, :n_act]).max(0)
    k1_err = np.abs(ko - po).max()
    k1_db = 20 * np.log10(np.maximum(np.abs(ko - po)[:, :n_act].max(0),
                                     1e-30) / peak)
    check((k1_db <= -80.0).all(), f"K1 worst voice {k1_db.max():.1f} dB")
    check(torch.equal(k1_st[40:48].view(torch.int32),
                      p_st[40:48].view(torch.int32)),
          "K1 LCG state rows differ from the plain version")
    check(np.abs(ko[:, n_act:]).max() == 0.0,
          'np.abs(ko[:, n_act:]).max() == 0.0')
    print(f"phase 2 K1: 384 lanes x 4096, worst voice {k1_db.max():.1f} dB, "
          f"max abs err {k1_err:.3e}, LCG rows bit-identical, "
          f"kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.1f} ms", flush=True)

    # ── phase 3: K2 on the card against its plain version on the card ──
    s_n, t_n = 8, 2048
    tt = np.arange(t_n) / SR
    levels = np.linspace(0.02, 0.1, s_n)
    env = np.minimum(np.arange(t_n) / 400.0, 1.0)
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
    print(f"phase 3 K2: 8 streams x 2048, levels 0.02-0.1, per-stream "
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
    for mod in (vb, mc):
        mod.KERNEL_LAUNCHES = 0
        mod.PLAIN_CALLS = 0
    grid = fast.render_grid(midis, vel, seconds, SR, volume=0.5, depth=0.5,
                            character=0.0, device=dev)
    torch.cuda.synchronize()
    counts = {"voice_bank": (vb.KERNEL_LAUNCHES, vb.PLAIN_CALLS),
              "mono_chain": (mc.KERNEL_LAUNCHES, mc.PLAIN_CALLS)}
    for name, (k, p) in counts.items():
        check(k >= 1 and p == 0,
              (name, k, p))
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
    # at 128 streams (two blocks) on the first 512 samples of the lane sum.
    # Both must agree bit for bit. ──
    k1_main_ms = cuda_ms(lambda: vb.render_voice_bank(params, t_pad,
                                                      steady=steady))
    k1_main_plain_ms, p_voices = host_ms(lambda: vb.render_voice_bank_plain(
        params, t_pad, steady=steady))
    k1_main_err = float((voices - p_voices).abs().max())
    check(torch.equal(voices, p_voices),
          f"K1 at {streams * 64} lanes x {t_pad}: max abs err "
          f"{k1_main_err:.3e} against the plain version; differing "
          f"{first_diff(voices, p_voices)}")
    t_cmp = 512
    a_cmp = audio[:t_cmp].contiguous()
    k2_out, k2_st = mc.render(SR, ctrl, st0, a_cmp)
    k2_main_plain_ms, (p2_out, p2_st) = host_ms(
        lambda: mc.render_chain_plain(mc.pack_consts(SR), ctrl, st0, a_cmp))
    k2_main_ms = cuda_ms(lambda: mc.render(SR, ctrl, st0, a_cmp))
    k2_main_err = float((k2_out - p2_out).abs().max())
    check(torch.isfinite(k2_out).all().item(),
          "K2 main-path comparison output not finite")
    # the state compared as bit patterns: its nz_lcg rows hold u32 LCG
    # words, some of which read as NaN floats
    st_bits, p_st_bits = k2_st.view(torch.int32), p2_st.view(torch.int32)
    check(torch.equal(k2_out, p2_out) and torch.equal(st_bits, p_st_bits),
          f"K2 at {streams} streams x {t_cmp}: max abs err "
          f"{k2_main_err:.3e} against the plain version; differing "
          f"{first_diff(k2_out, p2_out)}, state "
          f"{first_diff(st_bits, p_st_bits)}")
    print(f"phase 6 main-path shapes: K1 {streams * 64} lanes x {t_pad} "
          f"bit-identical, kernel {k1_main_ms:.1f} ms, plain "
          f"{k1_main_plain_ms:.1f} ms; K2 {streams} streams x {t_cmp} "
          f"bit-identical (output and state), kernel {k2_main_ms:.1f} ms, "
          f"plain {k2_main_plain_ms:.1f} ms [{card}]", flush=True)

    kernels = [
        {"name": "voice_bank", "route": "cuda",
         "source": "openwurli_tpu_torch/csrc/voice_bank.cu",
         "replaces": "openwurli_tpu/kernels/voice_bank.py:767",
         "launches": counts["voice_bank"][0], "max_abs_err": k1_main_err,
         "ms": k1_main_ms, "plain_ms": k1_main_plain_ms},
        {"name": "mono_chain", "route": "cuda",
         "source": "openwurli_tpu_torch/csrc/mono_chain.cu",
         "replaces": "openwurli_tpu/kernels/mono_chain.py:1710",
         "launches": counts["mono_chain"][0], "max_abs_err": k2_main_err,
         "ms": k2_main_ms, "plain_ms": k2_main_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
