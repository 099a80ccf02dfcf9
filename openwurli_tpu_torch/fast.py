"""Fast batch renderer: voice bank (K1) → per-stream voice sum → mono
chain (K2), the port of `openwurli_tpu/fast.py::render_grid` /
`render_chord`.

Host packing runs in float64 on the CPU; the packed float32 arrays move to
`device`, where both kernels run. On a CUDA device that is the two CUDA
kernels; on the CPU, their plain torch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from openwurli_tpu_torch.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import voice_bank as vb


def render_grid(midis, velocities, seconds, sample_rate=44100.0,
                volume=0.5, depth=0.5, character=0.0, warm_seconds=0.0,
                t_tile=None, noise_level=0.0, device="cuda"):
    """Render S streams × V voices: midis/velocities (S, V) → (T, S)
    float32 tensor on `device`.

    Each stream sounds its V notes from t=0 through the full analog
    chain; volume/depth/character may be scalars or (S,). warm_seconds of
    silent chain settle are rendered (and discarded) first. Voice lanes
    are stream-major: lane s·V + j is voice j of stream s. t_tile (default
    the reference's chain tile, 1024) only rounds the warm-up and the
    render up to whole tiles, as the reference does; each kernel runs its
    whole span in one launch."""
    midis = np.atleast_2d(np.asarray(midis, dtype=np.float64))
    vels = np.broadcast_to(np.asarray(velocities, dtype=np.float64),
                           midis.shape)
    s, v = midis.shape
    sr = float(sample_rate)
    t_tile = t_tile or mc.T_TILE
    t_total = int(round(seconds * sr))
    t_pad = -(-t_total // t_tile) * t_tile

    lanes = max(vb.LANES, -(-s * v // vb.LANES) * vb.LANES)
    params, _ = vb.make_kernel_params(midis.reshape(-1), vels.reshape(-1),
                                      sr, lanes=lanes, device=device)
    ctrl = mc.make_controls(sr, s, volume=volume, depth=depth,
                            character=character, noise_level=noise_level,
                            device=device)
    state = mc.init_state(sr, s, device=device)
    noise = bool(np.any(np.asarray(noise_level) > 0.0))

    if warm_seconds > 0.0:
        t_warm = -(-int(warm_seconds * sr) // t_tile) * t_tile
        silence = torch.zeros((t_warm, s), dtype=torch.float32,
                              device=params.device)
        _, state = mc.render(sr, ctrl, state, silence, noise=noise)

    voices = vb.render_voice_bank(params, t_pad,
                                  steady=vb.steady_limits(params))
    audio = voices[:, :s * v].reshape(t_pad, s, v).sum(-1)
    out, _ = mc.render(sr, ctrl, state, audio.contiguous(), noise=noise)
    return out[:t_total]


def render_chord(notes, velocity, seconds, sample_rate=44100.0, **kw):
    """Render one chord: notes (V,) → (T,) float32 mono."""
    out = render_grid(np.asarray(notes, dtype=np.float64)[None, :],
                      velocity, seconds, sample_rate, **kw)
    return out[:, 0]
