"""Entry points: the single-device forward step and the multi-device dry
run. Port of the reference's `__graft_entry__.py`.

    python -m openwurli_tpu_torch.entry     # one block on the card
"""

from __future__ import annotations

import numpy as np

from openwurli_tpu_torch.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import voice_bank as vb

SR = 44100.0
STREAMS, N_VOICES, T_BLOCK = 8, 64, 1024


def entry(device="cuda"):
    """(fn, args): one forward step of the fused full-chain path (the
    headline benchmark's mode) on `device`: 8 streams × 64 voices (notes
    36-99 at velocity 0.9) through the voice bank (K1) → per-stream sum →
    the mono chain (K2). fn(*args) advances one 1024-sample block from
    the carried states and returns (audio (1024, 8), voice_state',
    chain_state'); feeding the states back renders the next block."""
    notes = np.tile(np.arange(36, 36 + N_VOICES, dtype=np.float64), STREAMS)
    vels = np.full(STREAMS * N_VOICES, 0.9)
    params, _ = vb.make_kernel_params(notes, vels, SR,
                                      lanes=STREAMS * N_VOICES, device=device)
    vstate = vb.init_bank_state(params)
    ctrl = mc.make_controls(SR, STREAMS, volume=0.5, depth=0.5,
                            device=device)
    cstate = mc.init_state(SR, STREAMS, device=device)

    def fn(params, vstate, ctrl, cstate):
        voices, vstate2 = vb.render_voice_bank(
            params, T_BLOCK, state=vstate, n0=0, events=False,
            return_state=True)
        audio = voices.reshape(T_BLOCK, STREAMS, N_VOICES).sum(-1)
        out, cstate2 = mc.render(SR, ctrl, cstate, audio.contiguous())
        return out, vstate2, cstate2

    return fn, (params, vstate, ctrl, cstate)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """One sharded training step and the sharded fused kernels over
    n_devices ranks (`parallel/dryrun.py`): NCCL on cuda:0 … cuda:N-1, or
    gloo processes with device="cpu". Each rank is a fresh spawned
    process; a rank that fails raises here. Returns `dryrun.main`'s
    result."""
    from openwurli_tpu_torch.parallel import dryrun

    return dryrun.main(n_devices, device)


if __name__ == "__main__":
    fn, args = entry()
    block, _vstate, _cstate = fn(*args)
    print("entry() forward step:", tuple(block.shape), block.dtype,
          block.device)
