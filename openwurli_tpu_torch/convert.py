"""Carries the reference package's packed arrays into the port.

The JAX packers' outputs, taken as NumPy arrays and Python scalars, become
the port's constants and tensors, so that the port's kernels can run on
exactly the reference's packed inputs (and the packers can be held to the
reference independently of the kernels).
"""

from __future__ import annotations

import numpy as np
import torch

from openwurli_tpu_torch import mlp
from openwurli_tpu_torch.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import voice_bank as vb


def chain_consts_from_numpy(arrays: dict, scalars: dict) -> mc.ChainConsts:
    """The reference's `ChainConsts` (arrays + scalars) → the port's."""
    missing = set(mc.ARRAY_NAMES) - set(arrays)
    if missing:
        raise KeyError(f"missing chain arrays: {sorted(missing)}")
    arr = {k: np.ascontiguousarray(np.asarray(arrays[k], dtype=np.float32))
           for k in mc.ARRAY_NAMES}

    def scalar(v):
        if isinstance(v, (tuple, list)):
            return tuple(float(x) for x in v)
        if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            return int(v)
        return float(v)

    return mc.ChainConsts(arrays=arr,
                          scalars={k: scalar(v) for k, v in scalars.items()})


def _f32_tensor(x, shape_tail, device):
    t = torch.from_numpy(np.array(x, dtype=np.float32, order="C", copy=True))
    if tuple(t.shape[:len(shape_tail)]) != tuple(shape_tail):
        raise ValueError(f"shape {tuple(t.shape)} does not start with "
                         f"{tuple(shape_tail)}")
    return t.to(device)


def voice_params_from_numpy(params, device="cpu"):
    """Packed (N_ROWS, 8, V) voice params → float32 tensor (bit rows kept
    bit for bit)."""
    return _f32_tensor(params, (vb.N_ROWS, vb.SUBLANES), device)


def state_from_numpy(state, device="cpu"):
    """A packed state — voice bank (48, V) or chain (328, S) — → float32
    tensor, bit patterns kept."""
    rows = np.asarray(state).shape[0]
    if rows not in (vb.STATE_ROWS, mc.STATE_ROWS):
        raise ValueError(f"{rows} rows is neither a voice-bank nor a chain "
                         "state")
    return _f32_tensor(state, (rows,), device)


def mlp_weights_from_npz(path=mlp.WEIGHTS_PATH) -> mlp.MlpWeights:
    return mlp.load_weights(path)
