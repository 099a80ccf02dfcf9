#!/usr/bin/env python3
"""Fit a cheap analytic predictor of the tremolo shadow-pump.

The PyTorch port's copy of tools/analyze_pump_dynamics.py: sweep the
shadow preamp's steady-state pump across R_ldr (every R_ldr a stream of
one `_pump_trace` call of the port's CLI, kernel E7 on the card), then fit
a cubic in log R to the pump amplitude, printing the fit's quality, and
estimate the pump's settling time after an R_ldr step (1 MΩ → 19 kΩ).

    python tools/torch_analyze_pump_dynamics.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sr", type=float, default=88_200.0)
    p.add_argument("--points", type=int, default=9)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from openwurli_tpu_torch.cli import _pump_trace

    rs = np.geomspace(9_000.0, 1_000_000.0, args.points)
    tr = _pump_trace(lambda t: np.broadcast_to(rs, (len(t), len(rs))), 0.4,
                     args.sr, args.device)
    tail = tr[len(tr) // 2:]
    amps = tail.max(axis=0) - tail.min(axis=0)

    print("r_ldr_ohm,pump_pp_v")
    for r, a in zip(rs, amps):
        print(f"{r:.0f},{a:.6f}")

    # LUT fit quality: a cubic in log R
    log_r = np.log(rs)
    coeffs = np.polyfit(log_r, amps, 3)
    pred = np.polyval(coeffs, log_r)
    resid = np.abs(pred - amps).max()
    print(f"# cubic log-R fit: max residual {resid:.2e} V "
          f"(pump range {amps.min():.2e}..{amps.max():.2e} V)")

    # Step-response time constant estimate (R snap 1 MΩ → 19 kΩ)
    def r_fn(t):
        return np.where(t < 0.25, 1_000_000.0, 19_000.0)

    tr = _pump_trace(r_fn, 0.6, args.sr, args.device)
    step_at = int(0.25 * args.sr)
    seg = tr[step_at:] - tr[-1]
    if abs(seg[0]) > 1e-12:
        target = abs(seg[0]) / np.e
        idx = np.argmax(np.abs(seg) < target)
        print(f"# pump settle tau ≈ {idx/args.sr*1000:.1f} ms after R step")


if __name__ == "__main__":
    main()
