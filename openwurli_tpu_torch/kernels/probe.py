"""Probe kernel (P1): a timed loop of `iters` iterations over one small
body, with the state resident on chip. Port of the kernel skeleton of
`tools/tpu_probe.py` (`probe_loop_body`) and of its bodies.

The bodies are the primitive patterns the mono chain is built from; their
per-iteration times on the card say what one thread gives for each:

  * `empty`: nothing but the loop's carry (c + 1.0);
  * `chain`: `depth` dependent multiply-adds v·1.0000001 + 0.0000001 on a
    (sub, lan) block (a multiply and an add: no contraction);
  * `expchain`: `depth` times v ← exp(v·1e-6);
  * `dotchain`: `depth` times v ← mat·v with an (M, M) matrix, M = sub;
  * `ge16`: one 16×16 elimination per lane on an augmented (16·17, lan)
    block, row form: row k is normalised by 1/(pivot + 1) and stored;
  * `ge16_flat`: the same system as a (16, 17·lan) block, every step a
    masked update of the whole block; row k is not normalised, so its
    arithmetic differs from `ge16`'s;
  * `dynstore`: v ← v·1.0000001 and one row of a second state written at
    row `iteration mod sub`.

Every state starts filled with x0 and the result is row 0 of state 0 over
the first 128 lanes, (1, 128), as the reference skeleton returns it. Some
bodies leave little or no trace there, so `run_probe` also returns `aux`:
the carry (1, lanes) of `empty`, the second state (sub, lan) of `dynstore`,
the whole final state (sub, lan) of the two eliminations, None otherwise.

`run_probe` on a CUDA device launches `csrc/probe.cu`, one thread per lane;
on the CPU it runs `probe_plain`, the same arithmetic in torch ops on whole
blocks. `PROBES` is the reference tool's list of probes at its (sub, lan)
sizes and `measure` its timing rule (the time at iters=1 is subtracted), on
CUDA events.
"""

from __future__ import annotations

import numpy as np
import torch

BODIES = ("empty", "chain", "expchain", "dotchain", "ge16", "ge16_flat",
          "dynstore")
OUT_LANES = 128
GE_N, GE_W = 16, 17
MAX_SUB, MAX_M = 128, 32

# KERNEL_LAUNCHES counts CUDA launches, PLAIN_CALLS the calls served by the
# plain version.
KERNEL_LAUNCHES = 0
PLAIN_CALLS = 0


def _k(v):
    return torch.tensor(v, dtype=torch.float32)


def _check_shape(body, sub, lan, mat):
    if body not in BODIES:
        raise ValueError(f"unknown probe body {body!r}")
    if lan < OUT_LANES:
        raise ValueError(f"lan={lan} must be at least {OUT_LANES}")
    if body in ("chain", "expchain") and (sub % 8 or not 0 < sub <= MAX_SUB):
        raise ValueError(f"{body}: sub={sub} must be a multiple of 8 up to "
                         f"{MAX_SUB}")
    if body == "dynstore" and not 0 < sub <= MAX_SUB:
        raise ValueError(f"dynstore: sub={sub} must be 1..{MAX_SUB}")
    if body == "dotchain":
        if mat is None or tuple(np.shape(mat)) != (sub, sub) \
                or sub not in (8, MAX_M):
            raise ValueError(f"dotchain needs a ({sub}, {sub}) matrix, "
                             f"sub 8 or {MAX_M}")
    if body == "ge16" and sub != GE_N * GE_W:
        raise ValueError(f"ge16: sub must be {GE_N * GE_W}")
    if body == "ge16_flat" and (sub != GE_N or lan % GE_W
                                or lan // GE_W < OUT_LANES):
        raise ValueError(f"ge16_flat: sub must be {GE_N} and lan a multiple "
                         f"of {GE_W}, at least {GE_W * OUT_LANES}")


def probe_plain(body, iters, sub, lan, depth=0, x0=1.0, mat=None,
                device="cpu"):
    """Plain-torch P1 on `device` → (out (1, 128), aux)."""
    _check_shape(body, sub, lan, mat)
    f32 = torch.float32
    s = torch.full((sub, lan), float(x0), dtype=f32, device=device)
    aux = None
    with torch.inference_mode():
        if body == "empty":
            c = torch.zeros((1, lan), dtype=f32, device=device)
            for _ in range(iters):
                c = c + _k(1.0)
            aux = c
        elif body == "chain":
            a, b = _k(1.0000001), _k(0.0000001)
            for _ in range(iters * depth):
                s = s * a + b
        elif body == "expchain":
            a = _k(1e-6)
            for _ in range(iters * depth):
                s = torch.exp(s * a)
        elif body == "dotchain":
            m = torch.as_tensor(np.asarray(mat, dtype=np.float32),
                                device=device)
            for _ in range(iters * depth):
                acc = m[:, 0:1] * s[0:1]
                for k in range(1, sub):
                    acc = acc + m[:, k:k + 1] * s[k:k + 1]
                s = acc
        elif body == "ge16":
            for _ in range(iters):
                a = s.view(GE_N, GE_W, lan) + _k(0.0)
                for k in range(GE_N):
                    inv = torch.reciprocal(a[k, k] + _k(1.0))
                    rk = a[k] * inv
                    a[k] = rk
                    a[k + 1:] = a[k + 1:] - a[k + 1:, k:k + 1] * rk
                s = a.view(sub, lan)
            aux = s
        elif body == "ge16_flat":
            n = lan // GE_W
            rows = torch.arange(GE_N, device=device)[:, None]
            for _ in range(iters):
                a = s + _k(0.0)
                for k in range(GE_N):
                    piv = a[k:k + 1, k * n:(k + 1) * n]
                    inv = torch.reciprocal(piv + _k(1.0))
                    rk = a[k:k + 1] * inv.repeat(1, GE_W)
                    factors = a[:, k * n:(k + 1) * n].repeat(1, GE_W)
                    mask = (rows > k).to(f32)
                    a = a - mask * factors * rk
                s = a
            aux = s
        elif body == "dynstore":
            buf = s.clone()
            a = _k(1.0000001)
            for i in range(iters):
                s = s * a
                buf[i % sub] = s[0]
            aux = buf
    return s[0:1, 0:OUT_LANES].clone(), aux


def run_probe(body, iters, sub, lan, depth=0, x0=1.0, mat=None,
              threads=128, device="cuda"):
    """Run one probe body for `iters` iterations → (out (1, 128), aux) on
    `device`. sub, lan: the state block; `threads` per block on the card
    (one thread per lane; `ge16_flat` has lan/17 lanes). A CPU device runs
    the plain version, a CUDA device the CUDA kernel."""
    global KERNEL_LAUNCHES, PLAIN_CALLS
    iters, sub, lan, depth = int(iters), int(sub), int(lan), int(depth)
    _check_shape(body, sub, lan, mat)
    if iters < 0 or depth < 0:
        raise ValueError("iters and depth must not be negative")
    dev = torch.device(device)
    if dev.type == "cpu":
        PLAIN_CALLS += 1
        return probe_plain(body, iters, sub, lan, depth, x0, mat, dev)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not 1 <= int(threads) <= 1024:
        raise ValueError(f"threads={threads} must be 1..1024")

    from openwurli_tpu_torch import _build

    lib = _build.library()
    f32 = torch.float32
    lanes = lan // GE_W if body == "ge16_flat" else lan
    x = torch.full((1,), float(x0), dtype=f32, device=dev)
    m = None if mat is None else torch.as_tensor(
        np.ascontiguousarray(mat, dtype=np.float32), device=dev)
    out = torch.empty((1, OUT_LANES), dtype=f32, device=dev)
    aux_shape = {"dynstore": (sub, lan), "ge16": (sub, lan),
                 "ge16_flat": (sub, lan)}.get(body, (1, lanes))
    aux = torch.empty(aux_shape, dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ow_probe(BODIES.index(body), x.data_ptr(),
                       None if m is None else m.data_ptr(), iters, depth, sub,
                       lanes, int(threads), out.data_ptr(), aux.data_ptr(),
                       stream)
    if err:
        raise RuntimeError(f"probe kernel failed: {_build.error(err)}")
    KERNEL_LAUNCHES += 1
    return out, (None if body in ("chain", "expchain", "dotchain") else aux)


def _eye(m):
    return np.eye(m, dtype=np.float32) * np.float32(0.999)


# name → (label, body, sub, lan, depth, mat, starting iters): the reference
# tool's probes at its sizes.
PROBES = {
    "loop": ("empty loop", "empty", 8, 128, 0, None, 20000),
    "chain20_8x128": ("chain d=20 (8,128)", "chain", 8, 128, 20, None, 5000),
    "chain20_8x1024": ("chain d=20 (8,1024)", "chain", 8, 1024, 20, None,
                       5000),
    "chain20_64x128": ("chain d=20 (64,128)", "chain", 64, 128, 20, None,
                       5000),
    "chain20_128x1024": ("chain d=20 (128,1024)", "chain", 128, 1024, 20,
                         None, 2000),
    "chain100_8x128": ("chain d=100 (8,128)", "chain", 8, 128, 100, None,
                       2000),
    "exp20_8x128": ("exp chain d=20 (8,128)", "expchain", 8, 128, 20, None,
                    2000),
    "exp20_16x128": ("exp chain d=20 (16,128)", "expchain", 16, 128, 20,
                     None, 2000),
    "dot8_8x128": ("dot (8,8)@(8,128) d=10", "dotchain", 8, 128, 10, _eye(8),
                   2000),
    "dot32_32x128": ("dot (32,32)@(32,128) d=10", "dotchain", 32, 128, 10,
                     _eye(32), 2000),
    "dot32_32x1024": ("dot (32,32)@(32,1024) d=10", "dotchain", 32, 1024, 10,
                      _eye(32), 2000),
    "ge16_128": ("GE 16x16 rows (lan=128)", "ge16", GE_N * GE_W, 128, 0,
                 None, 500),
    "ge16_1024": ("GE 16x16 rows (lan=1024)", "ge16", GE_N * GE_W, 1024, 0,
                  None, 500),
    "ge16f_128": ("GE 16x16 flat (lan=128)", "ge16_flat", GE_N,
                  GE_W * 128, 0, None, 500),
    "dynstore": ("dynamic row store (8,128) buf", "dynstore", 8, 128, 0,
                 None, 20000),
}


def _time_probe(spec, iters, threads, reps):
    """Least device time in seconds of one launch over `reps` (CUDA events,
    after one warm launch), and element 0 of its output."""
    _label, body, sub, lan, depth, mat, _iters = spec

    def launch():
        return run_probe(body, iters, sub, lan, depth, mat=mat,
                         threads=threads, device="cuda")

    out, _aux = launch()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, _aux = launch()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3)
    return best, float(out[0, 0])


def measure(name, threads=128, target_s=0.2, reps=3, max_iters=80_000_000):
    """Time probe `name` on the card → dict with `per_iter_us`: the time of
    one launch at iters=1 is subtracted, and the iteration count grows until
    the loop itself takes `target_s`."""
    spec = PROBES[name]
    iters = spec[6]
    base, _ = _time_probe(spec, 1, threads, reps)
    full, chk = _time_probe(spec, iters, threads, reps)
    while full - base < target_s and iters < max_iters:
        iters = int(iters * max(2, min(32, target_s
                                       / max(full - base, 1e-4))))
        full, chk = _time_probe(spec, iters, threads, reps)
    return {"name": name, "label": spec[0], "threads": threads,
            "launch_ms": base * 1e3, "iters": iters,
            "per_iter_us": (full - base) * 1e6 / (iters - 1), "chk": chk}
