#!/usr/bin/env python3
"""Generate precomputed settled tremolo states (package data).

The PyTorch port's copy of tools/gen_settled_states.py: runs the Twin-T
tremolo oscillator's 2 s settle (`circuits.tremolo.SETTLE_SECONDS`) from
its perturbed start for the common engine rates, through kernel E3 on the
card (its plain loop with `--device cpu`), and stores the final solver
states where `circuits.tremolo.settled_osc_state` reads them, by default
the port's own data/tremolo_settled.npz.

    python tools/torch_gen_settled_states.py [--out PATH] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

RATES = [44100.0, 48000.0, 88200.0, 96000.0]
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                   "openwurli_tpu_torch", "data", "tremolo_settled.npz")


def settle(sample_rate, device):
    """The oscillator's state after its settle at `sample_rate`, computed
    (never read from the package data) → (v, i_nl, v_nl) NumPy."""
    from openwurli_tpu_torch.circuits import tremolo
    from openwurli_tpu_torch.kernels import engine as ek

    params = tremolo.make_params(sample_rate)
    st = ek.tremolo_settle(sample_rate,
                           tremolo.perturbed_start(params, device),
                           tremolo.settle_steps(sample_rate))
    return tuple(x.cpu().numpy() for x in (st.v, st.i_nl, st.v_nl))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    payload = {}
    for sr in RATES:
        key = f"sr{int(round(sr))}"
        (payload[f"{key}_v"], payload[f"{key}_i"],
         payload[f"{key}_vnl"]) = settle(sr, args.device)
        print(f"settled {sr:.0f} Hz: out={payload[f'{key}_v'][0]:.4f} V")
    np.savez(args.out, **payload)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
