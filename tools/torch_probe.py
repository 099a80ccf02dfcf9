#!/usr/bin/env python3
"""Microbenchmarks of the PyTorch port on an NVIDIA GPU, for the design
space of the mono-chain kernel: the counterpart of tools/tpu_probe.py.

Measures, inside one CUDA kernel (csrc/probe.cu: the time loop is a loop
in the thread, one thread per lane, the state resident on chip), the cost
per loop iteration of the primitive patterns the mono chain is built from:

  loop      empty loop body (the per-iteration floor)
  chain<D>  D dependent multiply-adds on a (SUB, LAN) block
  exp       transcendental chain
  dot       small (M,M)@(M,LAN) matvec chain against shared memory
  ge        one 16×16 per-lane elimination per iteration, two forms
  dynstore  a store at a row index that moves with the iteration

Times are CUDA-event times of one launch; the time of a launch at iters=1
is reported as the launch time and subtracted. A probe that fails ends the
run. Run on a machine with a card:

    python tools/torch_probe.py [--threads 128] [--target-s 0.2] [probe ...]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("probes", nargs="*", help="probe names (default: all)")
    p.add_argument("--threads", type=int, default=128,
                   help="threads per block")
    p.add_argument("--target-s", type=float, default=0.2,
                   help="loop time each probe is grown to")
    args = p.parse_args(argv)

    import torch

    from chip_smoke import card_line
    from openwurli_tpu_torch.kernels import probe

    if not torch.cuda.is_available():
        raise SystemExit("torch_probe: no CUDA device")
    unknown = [n for n in args.probes if n not in probe.PROBES]
    if unknown:
        raise SystemExit(f"unknown probes {unknown}; known: "
                         f"{list(probe.PROBES)}")
    print(f"device: {card_line()}; {args.threads} threads per block",
          flush=True)
    results = []
    for name in (args.probes or probe.PROBES):
        r = probe.measure(name, threads=args.threads,
                          target_s=args.target_s)
        print(f"{r['label']:34s} launch={r['launch_ms']:8.3f} ms  "
              f"iters={r['iters']:>9d}  per_iter={r['per_iter_us']:10.4f} us"
              f"  (chk={r['chk']:.3e})", flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
