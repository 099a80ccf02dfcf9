"""The offline render paths' kernels: E4 (voice render) and E5 (preamp
scan), both in `csrc/engine.cu`.

The reference renders notes and the DI chain as jitted `lax.scan`s
(`openwurli_tpu/voice.py:140` `render`, `openwurli_tpu/di.py:29`
`preamp_di`), not as Pallas kernels. In eager PyTorch one sample of
either scan is some hundreds of small ops, so on the card the sample
loops are kernels:

  * **E4 `voice_render`**: G voices, a thread each, over n samples: the
    reed → attack noise → pickup → post-pickup gain step that E1 runs for
    the engine's slots (the same device function). Output (n, G), time
    major, so that a warp's 32 voices store one coalesced row per sample;
    the voices' state is updated in place.
  * **E5 `preamp_scan<PRE>`**: G streams, a thread each, over n samples
    of (n, G) float64 input:
      - `dk`: `di.preamp_di`'s chain: the 2× allpass up step, the twin DK
        preamp step twice at the stream's fixed LDR conductance, the
        allpass down step;
      - `melange`: one melange preamp step per sample at the stream's LDR
        conductance and noise scale (noise_enabled · noise_gain).

Each has a plain version here, a loop of the ported steps (`voice.step`;
`allpass` and `dk_preamp.step`; `melange_preamp.step`, batched over the
streams), that the CPU runs and the kernel is held to bit for bit on the
card. State layouts, one column per voice or stream:

  * voices: `kernels/engine.py`'s vpar (NPAR, G), vst (NST, G), vsti
    (NSTI, G);
  * `dk` streams (DK_ROWS, G): the oversampler (13 rows) then the DK
    preamp (29 rows), in the f64 chain's order (CHAIN_SPEC);
  * `melange` streams (MEL_STATE_ROWS, G): the chain's melange rows.

A CPU tensor runs the plain version, a CUDA tensor the kernel; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from openwurli_tpu_torch import voice
from openwurli_tpu_torch.circuits import dk_preamp, melange_preamp
from openwurli_tpu_torch.kernels import engine as ek
from openwurli_tpu_torch.ops import allpass

DK_SPEC = (("os_up_a", 3), ("os_up_b", 3), ("os_down_a", 3),
           ("os_down_b", 3), ("os_delay", 1), ("pre_v", 16), ("pre_i", 4),
           ("pre_vnl", 4), ("pre_jcin", 2), ("pre_cinprev", 2),
           ("pre_gprev", 1))
DK_ROWS = sum(k for _, k in DK_SPEC)
MEL_STATE_ROWS = ek.CHAIN_OFF["mel_wprev"][1] - ek.CHAIN_OFF["mel_v"][0]

# Launch counters: *_LAUNCHES count CUDA launches, *_PLAIN_CALLS the calls
# served by the plain version.
VOICE_RENDER_LAUNCHES = VOICE_RENDER_PLAIN_CALLS = 0
PREAMP_SCAN_LAUNCHES = {"dk": 0, "melange": 0}
PREAMP_SCAN_PLAIN_CALLS = 0


# ───────────────────────────── E4: voices ─────────────────────────────


def voice_columns(vparams: voice.VoiceParams, vstate: voice.VoiceState,
                  device="cpu"):
    """NumPy note-on params and state of any batch shape → (vpar, vst,
    vsti) tensors on `device`, one column per voice in C order."""
    batch = np.shape(vparams.midi_note)

    def flat(tree):
        if isinstance(tree, tuple):
            return type(tree)(*[flat(x) for x in tree])
        a = np.asarray(tree)
        extra = a.shape[len(batch):] if a.shape[:len(batch)] == batch \
            else ()
        return np.broadcast_to(a, batch + extra).reshape((-1,) + extra)

    cols = ek.pack_voice_columns(flat(vparams), flat(vstate))
    return tuple(torch.from_numpy(c).to(device) for c in cols)


def voice_render_plain(vpar, vst, vsti, num_samples: int):
    """Plain E4 on the tensors' device → out (num_samples, G) float64; vst
    and vsti are updated in place."""
    params, state = ek.unpack_voices(vpar, vst, vsti)
    out = torch.empty((num_samples, vpar.shape[1]), dtype=torch.float64,
                      device=vpar.device)
    with torch.inference_mode():
        for t in range(num_samples):
            state, out[t] = voice.step(params, state)
        ek.write_voice_state(vst, vsti, state)
    return out


def voice_render(vpar, vst, vsti, num_samples: int):
    """E4: G voices over num_samples → (num_samples, G) float64; vst and
    vsti (the voices' state) are updated in place."""
    global VOICE_RENDER_LAUNCHES, VOICE_RENDER_PLAIN_CALLS
    g = vpar.shape[1] if vpar.dim() == 2 else -1
    ek._check("vpar", vpar, (ek.NPAR, g), torch.float64)
    ek._check("vst", vst, (ek.NST, g), torch.float64)
    ek._check("vsti", vsti, (ek.NSTI, g), torch.int64)
    dev = vpar.device
    if not vst.device == vsti.device == dev:
        raise ValueError("the voice tensors must be on one device")
    n = int(num_samples)
    if n < 0:
        raise ValueError(f"num_samples {n} < 0")
    if dev.type == "cpu":
        VOICE_RENDER_PLAIN_CALLS += 1
        return voice_render_plain(vpar, vst, vsti, n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((n, g), dtype=torch.float64, device=dev)
    ek._lib_call("voice_render", lambda lib: lib.ow_voice_render,
                 vpar.data_ptr(), vst.data_ptr(), vsti.data_ptr(),
                 out.data_ptr(), g, n, device=dev)
    VOICE_RENDER_LAUNCHES += 1
    return out


# ───────────────────────────── E5: preamp ─────────────────────────────


@functools.lru_cache(maxsize=None)
def preamp_consts(kind: str, sample_rate: float) -> np.ndarray:
    """E5's constants for a preamp at `sample_rate` (the rate its steps
    run at): `dk`, the f64 chain's DK preamp block (PRE_SPEC); `melange`,
    its melange block (MEL_SPEC)."""
    if kind == "dk":
        c = dk_preamp.step_tensors(dk_preamp.make_params(sample_rate))
        return np.concatenate([c[k].numpy().ravel() for k, _ in ek.PRE_SPEC])
    if kind == "melange":
        return ek.melange_block(melange_preamp.make_params(sample_rate))
    raise ValueError(f"preamp kind {kind!r}")


@functools.lru_cache(maxsize=None)
def _consts_on(kind, sample_rate, device):
    return torch.from_numpy(preamp_consts(kind, sample_rate)).to(device)


def init_dk_state(sample_rate: float, streams: int, device="cpu"):
    """(DK_ROWS, streams): the oversampler at rest, the DK preamp (at
    `sample_rate`, its step rate) at its DC point."""
    st = dk_preamp.init_state(dk_preamp.make_params(sample_rate), device)
    col = torch.cat([torch.zeros(13, dtype=torch.float64, device=device),
                     st.v.reshape(-1), st.i_nl.reshape(-1),
                     st.v_nl.reshape(-1), st.j_cin, st.cin_rhs_prev,
                     st.g_ldr_prev.reshape(1)])
    return col[:, None].repeat(1, int(streams)).contiguous()


def init_melange_state(sample_rate: float, streams: int, device="cpu"):
    """(MEL_STATE_ROWS, streams): each stream at the DC point with its
    noise key at PRNGKey(0x5EED)."""
    st = melange_preamp.init_state(melange_preamp.make_params(sample_rate),
                                   device=device)
    return melange_rows(st)[:, None].repeat(1, int(streams)).contiguous()


def melange_rows(st: melange_preamp.MelangePreampState):
    """A MelangePreampState (batch (...)) → rows (MEL_STATE_ROWS, ...)."""
    batch = st.g_ldr_prev.shape
    parts = [st.v.reshape(batch + (-1,)), st.i_nl.reshape(batch + (-1,)),
             st.v_nl.reshape(batch + (-1,)), st.g_ldr_prev[..., None],
             st.noise_key.to(torch.float64),
             st.noise_w_prev]
    return torch.cat(parts, dim=-1).movedim(-1, 0)


def melange_unrows(rows) -> melange_preamp.MelangePreampState:
    """Rows (MEL_STATE_ROWS, ...) → a MelangePreampState (copies)."""
    x = rows.movedim(0, -1)
    batch = x.shape[:-1]
    n, m = melange_preamp.N, melange_preamp.M
    a = 2 * n + 4 * m
    return melange_preamp.MelangePreampState(
        v=x[..., :2 * n].reshape(batch + (2, n)).clone(),
        i_nl=x[..., 2 * n:2 * n + 2 * m].reshape(batch + (2, m)).clone(),
        v_nl=x[..., 2 * n + 2 * m:a].reshape(batch + (2, m)).clone(),
        g_ldr_prev=x[..., a].clone(),
        noise_key=x[..., a + 1:a + 3].to(torch.int64),
        noise_w_prev=x[..., a + 3:].clone())


def _dk_unrows(rows):
    """(DK_ROWS, G) → (OversamplerState, PreampState), twin axis first in
    the preamp state (v (2, G, 8))."""
    seg, o = {}, 0
    for name, k in DK_SPEC:
        seg[name] = rows[o:o + k].T.clone()
        o += k
    os_ = allpass.OversamplerState(seg["os_up_a"], seg["os_up_b"],
                                   seg["os_down_a"], seg["os_down_b"],
                                   seg["os_delay"][:, 0])
    g = rows.shape[1]
    pre = dk_preamp.PreampState(
        v=seg["pre_v"].reshape(g, 2, 8).movedim(1, 0),
        i_nl=seg["pre_i"].reshape(g, 2, 2).movedim(1, 0),
        v_nl=seg["pre_vnl"].reshape(g, 2, 2).movedim(1, 0),
        j_cin=seg["pre_jcin"].T, cin_rhs_prev=seg["pre_cinprev"].T,
        g_ldr_prev=seg["pre_gprev"][:, 0])
    return os_, pre


def _dk_rows(os_, pre, out):
    g = out.shape[1]
    cols = [os_.up_a, os_.up_b, os_.down_a, os_.down_b,
            os_.down_delay[:, None],
            pre.v.movedim(0, 1).reshape(g, 16),
            pre.i_nl.movedim(0, 1).reshape(g, 4),
            pre.v_nl.movedim(0, 1).reshape(g, 4), pre.j_cin.T,
            pre.cin_rhs_prev.T,
            pre.g_ldr_prev.expand(g)[:, None]]
    out.copy_(torch.cat(cols, dim=1).T)


def preamp_scan_plain(kind, sample_rate, x, state, g_ldr, noise_scale=None):
    """Plain E5 on the tensors' device: x (n, G) float64 → out (n, G);
    `state` is updated in place. `sample_rate` is the rate of the preamp
    steps (twice the input's for `dk`)."""
    n = x.shape[0]
    dev = x.device
    out = torch.empty_like(x)
    with torch.inference_mode():
        if kind == "dk":
            c = dk_preamp.step_tensors(dk_preamp.make_params(sample_rate),
                                       dev)
            os_, pre = _dk_unrows(state)
            for t in range(n):
                os_, (e, o) = allpass.up_step(os_, x[t])
                pre, y0 = dk_preamp.step(c, pre, g_ldr, e)
                pre, y1 = dk_preamp.step(c, pre, g_ldr, o)
                os_, out[t] = allpass.down_step(os_, y0, y1)
            _dk_rows(os_, pre, state)
        else:
            c = melange_preamp.step_tensors(
                melange_preamp.make_params(sample_rate), dev)
            st = melange_unrows(state)
            for t in range(n):
                st, out[t] = melange_preamp.step(c, st, g_ldr, x[t],
                                                 noise_scale)
            state.copy_(melange_rows(st))
    return out


def preamp_scan(kind: str, sample_rate: float, x, state, g_ldr,
                noise_scale=None):
    """E5: G preamp streams over x (n, G) float64 → out (n, G) float64;
    `state` ((DK_ROWS or MEL_STATE_ROWS), G) is updated in place. g_ldr
    (G,): each stream's LDR conductance; noise_scale (G,) (melange only):
    noise_enabled · noise_gain. `sample_rate`: the preamp steps' rate."""
    global PREAMP_SCAN_PLAIN_CALLS
    if kind not in ek.PREAMP_MODELS:
        raise ValueError(f"preamp kind {kind!r}")
    f64 = torch.float64
    n, g = (x.shape if x.dim() == 2 else (-1, -1))
    _check = ek._check
    _check("x", x, (n, g), f64)
    rows = DK_ROWS if kind == "dk" else MEL_STATE_ROWS
    _check("state", state, (rows, g), f64)
    _check("g_ldr", g_ldr, (g,), f64)
    tensors = [x, state, g_ldr]
    if kind == "melange":
        if noise_scale is None:
            raise ValueError("the melange scan needs noise_scale (G,)")
        _check("noise_scale", noise_scale, (g,), f64)
        tensors.append(noise_scale)
    dev = x.device
    if any(t.device != dev for t in tensors):
        raise ValueError("the scan's tensors must be on one device")
    if dev.type == "cpu":
        PREAMP_SCAN_PLAIN_CALLS += 1
        return preamp_scan_plain(kind, float(sample_rate), x, state, g_ldr,
                                 noise_scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    consts = _consts_on(kind, float(sample_rate), str(dev))
    out = torch.empty_like(x)
    ek._lib_call("preamp_scan", lambda lib: lib.ow_preamp_scan,
                 ek.PREAMP_MODELS.index(kind), consts.data_ptr(),
                 consts.numel(),
                 x.data_ptr(), state.data_ptr(), g_ldr.data_ptr(),
                 noise_scale.data_ptr() if kind == "melange" else None,
                 out.data_ptr(), n, g, device=dev)
    PREAMP_SCAN_LAUNCHES[kind] += 1
    return out
