"""The DI-path renderer: reed → pickup → output scale → 2×-oversampled DK
preamp at R_ldr = 1 MΩ (tremolo off).

Port of `openwurli_tpu/di.py`: the chain the calibration pipeline and the
A/B comparisons render, the voice path with the preamp's gain, rolloff
and H2, without power amp or speaker. The whole grid renders at once:
the voices through kernel E4 (eight threads per voice), the preamp
through E5<dk> (a warp per stream; `kernels/render.py`) on the card, or
their plain loops on the CPU. The preamp steps at twice the base rate at
every rate, 88.2 kHz and above included.
"""

from __future__ import annotations

import numpy as np
import torch

from openwurli_tpu_torch import voice
from openwurli_tpu_torch.circuits import dk_preamp as dk
from openwurli_tpu_torch.kernels import render as kr


def preamp_di(audio, sr, device="cuda"):
    """Run (n,) or (n, ...) float64 audio (NumPy or a tensor) through the
    2×-oversampled preamp at the quiescent R_ldr (1 MΩ) on `device`.
    Returns the same shape, a tensor on `device`."""
    x = torch.as_tensor(audio, dtype=torch.float64).to(device)
    shape = x.shape
    x2 = x.reshape(shape[0], -1).contiguous()
    g = x2.shape[1]
    os_sr = float(sr) * 2.0
    g_ldr = torch.full((g,), 1.0 / dk.R_LDR_INIT,  # ldr_conductance(1 MΩ)
                       dtype=torch.float64, device=device)
    state = kr.init_dk_state(os_sr, g, device)
    out = kr.preamp_scan("dk", os_sr, x2, state, g_ldr)
    return out.reshape(shape)


def render_di(midis, velocities, duration, sr, mlp_enabled=True,
              device="cuda"):
    """Batched DI render: midis/velocities scalar or (G,) → NumPy (n,) /
    (n, G) float64."""
    audio = voice.render_note(midis, velocities, duration, float(sr),
                              mlp_enabled=mlp_enabled, device=device)
    return preamp_di(audio, float(sr), device=device).cpu().numpy()
