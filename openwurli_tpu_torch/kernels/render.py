"""The offline render paths' kernels: E4 (voice render), E5 (preamp
scan) and E6 (power amp and speaker scan), all in `csrc/engine.cu`.

The reference renders notes, the DI chain and the calibration sweep's
taps as jitted `lax.scan`s (`openwurli_tpu/voice.py:140` `render`,
`openwurli_tpu/di.py:29` `preamp_di`, `openwurli_tpu/calib/calibrate.py:
80-138`), not as Pallas kernels. In eager PyTorch one sample of
either scan is some hundreds of small ops, so on the card the sample
loops are kernels:

  * **E4 `voice_render`**: G voices, a thread each, over n samples: the
    reed → attack noise → pickup → post-pickup gain step that E1 runs for
    the engine's slots (the same device function). Output (n, G), time
    major, so that a warp's 32 voices store one coalesced row per sample;
    the voices' state is updated in place. **E4<tap>** (`voice_tap`) is
    `run_calibrate`'s T1 and T2: the reed alone into the pickup (no attack
    noise, no post-pickup gain), with the reed's samples as a second
    (n, G) output.
  * **E5 `preamp_scan<PRE>`**: G streams, a thread each, over n samples
    of (n, G) float64 input:
      - `dk`: `di.preamp_di`'s chain: the 2× allpass up step, the twin DK
        preamp step twice at the stream's fixed LDR conductance, the
        allpass down step;
      - `melange`: one melange preamp step per sample at the stream's LDR
        conductance and noise scale (noise_enabled · noise_gain).
  * **E6 `pa_speaker_scan`**: G streams, a thread each, over n samples:
    `run_calibrate`'s T5, x · volume² → the power amp (E2's step, rail
    sag on, at the input's rate) → the speaker (filters designed once from
    the character) → × POST_SPEAKER_GAIN.

Each has a plain version here, a loop of the ported steps (`voice.step`;
`reed.step` and `pickup.step`; `allpass` and `dk_preamp.step`;
`melange_preamp.step`; `power_amp.step` and `speaker.step`, batched over
the streams), that the CPU runs and the kernel is held to bit for bit on the
card. State layouts, one column per voice or stream:

  * voices: `kernels/engine.py`'s vpar (NPAR, G), vst (NST, G), vsti
    (NSTI, G);
  * `dk` streams (DK_ROWS, G): the oversampler (13 rows) then the DK
    preamp (29 rows), in the f64 chain's order (CHAIN_SPEC);
  * `melange` streams (MEL_STATE_ROWS, G): the chain's melange rows;
  * E6 streams (PA_SPEAKER_ROWS, G): the chain's power-amp and speaker
    rows (CHAIN_SPEC `pa_v` .. `spk`).

A CPU tensor runs the plain version, a CUDA tensor the kernel; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from openwurli_tpu_torch import hammer, pickup, reed, tables, voice
from openwurli_tpu_torch.circuits import dk_preamp, mna, melange_preamp
from openwurli_tpu_torch.circuits import power_amp, speaker
from openwurli_tpu_torch.kernels import engine as ek
from openwurli_tpu_torch.ops import allpass, biquad

DK_SPEC = (("os_up_a", 3), ("os_up_b", 3), ("os_down_a", 3),
           ("os_down_b", 3), ("os_delay", 1), ("pre_v", 16), ("pre_i", 4),
           ("pre_vnl", 4), ("pre_jcin", 2), ("pre_cinprev", 2),
           ("pre_gprev", 1))
DK_ROWS = sum(k for _, k in DK_SPEC)
MEL_STATE_ROWS = ek.CHAIN_OFF["mel_wprev"][1] - ek.CHAIN_OFF["mel_v"][0]
PA_SPEAKER_ROWS = ek.CHAIN_OFF["spk"][1] - ek.CHAIN_OFF["pa_v"][0]

# Launch counters: *_LAUNCHES count CUDA launches, *_PLAIN_CALLS the calls
# served by the plain version.
VOICE_RENDER_LAUNCHES = VOICE_RENDER_PLAIN_CALLS = 0
PREAMP_SCAN_LAUNCHES = {"dk": 0, "melange": 0}
PREAMP_SCAN_PLAIN_CALLS = 0
VOICE_TAP_LAUNCHES = VOICE_TAP_PLAIN_CALLS = 0
PA_SPEAKER_LAUNCHES = PA_SPEAKER_PLAIN_CALLS = 0


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


def _check_voices(vpar, vst, vsti, num_samples):
    """→ (voices, samples, device) after checking the packed columns."""
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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return g, n, dev


def voice_render(vpar, vst, vsti, num_samples: int):
    """E4: G voices over num_samples → (num_samples, G) float64; vst and
    vsti (the voices' state) are updated in place."""
    global VOICE_RENDER_LAUNCHES, VOICE_RENDER_PLAIN_CALLS
    g, n, dev = _check_voices(vpar, vst, vsti, num_samples)
    if dev.type == "cpu":
        VOICE_RENDER_PLAIN_CALLS += 1
        return voice_render_plain(vpar, vst, vsti, n)
    out = torch.empty((n, g), dtype=torch.float64, device=dev)
    ek._lib_call("voice_render", lambda lib: lib.ow_voice_render,
                 vpar.data_ptr(), vst.data_ptr(), vsti.data_ptr(),
                 out.data_ptr(), g, n, device=dev)
    VOICE_RENDER_LAUNCHES += 1
    return out


# ─────────────────────── E4<tap>: calibrate's T1, T2 ───────────────────────


def tap_columns(reed_params: reed.ReedParams, reed_state: reed.ReedState,
                pickup_params: pickup.PickupParams, device="cpu"):
    """run_calibrate's reeds and pickups (NumPy, batch (G,)) → E4's packed
    (vpar, vst, vsti) on `device`: the attack noise's rows zero (E4<tap>
    never reads them), the post-pickup gain 1 (never applied)."""
    batch = np.shape(reed_params.onset_ramp_samples)
    z = np.zeros(batch)
    zi = np.zeros(batch, np.int64)
    vp = voice.VoiceParams(
        reed=reed_params,
        noise=hammer.NoiseParams(z, biquad.BiquadCoeffs(z, z, z, z, z)),
        pickup=pickup_params, post_pickup_gain=np.ones(batch),
        midi_note=z)
    vs = voice.VoiceState(
        reed=reed_state,
        noise=hammer.NoiseState(z, zi, zi, biquad.BiquadState(z, z), zi),
        pickup=pickup.init_state(batch))
    return voice_columns(vp, vs, device)


def voice_tap_plain(vpar, vst, vsti, num_samples: int):
    """Plain E4<tap> on the tensors' device → (out, reed), each
    (num_samples, G) float64: the reed step, then the pickup step on its
    output; vst and vsti are updated in place (the noise rows untouched)."""
    params, state = ek.unpack_voices(vpar, vst, vsti)
    g = vpar.shape[1]
    out = torch.empty((num_samples, g), dtype=torch.float64,
                      device=vpar.device)
    reed_out = torch.empty_like(out)
    rs, ps = state.reed, state.pickup
    with torch.inference_mode():
        for t in range(num_samples):
            rs, reed_out[t] = reed.step(params.reed, rs)
            ps, out[t] = pickup.step(params.pickup, ps, reed_out[t])
        ek.write_voice_state(vst, vsti, state._replace(reed=rs, pickup=ps))
    return out, reed_out


def voice_tap(vpar, vst, vsti, num_samples: int):
    """E4<tap>: G reeds, each into its pickup, over num_samples → (out,
    reed), each (num_samples, G) float64: the pickup's output and the
    reed's; vst and vsti are updated in place."""
    global VOICE_TAP_LAUNCHES, VOICE_TAP_PLAIN_CALLS
    g, n, dev = _check_voices(vpar, vst, vsti, num_samples)
    if dev.type == "cpu":
        VOICE_TAP_PLAIN_CALLS += 1
        return voice_tap_plain(vpar, vst, vsti, n)
    out = torch.empty((n, g), dtype=torch.float64, device=dev)
    reed_out = torch.empty_like(out)
    ek._lib_call("voice_render_tap", lambda lib: lib.ow_voice_render_tap,
                 vpar.data_ptr(), vst.data_ptr(), vsti.data_ptr(),
                 out.data_ptr(), reed_out.data_ptr(), g, n, device=dev)
    VOICE_TAP_LAUNCHES += 1
    return out, reed_out


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


# ─────────────── E6: calibrate's T5 (power amp, speaker) ───────────────


@functools.lru_cache(maxsize=None)
def pa_speaker_consts(sample_rate: float) -> np.ndarray:
    """E6's constants: the f64 chain's layout (csrc/engine.cu ConstOffset)
    with the power amp built at `sample_rate` itself (the chain builds it
    at its oversampled rate), the speaker's rate and thermal coefficient
    and the post-speaker gain in the misc block; the tremolo and preamp
    blocks, which E6 never reads, zero."""
    ap = power_amp.make_params(sample_rate)
    sp = speaker.make_params(sample_rate)
    at_pa = ek.solver_block_size(ek.N_T, ek.M_T, ek.NB_T)
    pa = ek.solver_block(power_amp.build_netlist(), ap.solver)
    at_misc = at_pa + pa.size + sum(k for _, k in ek.PRE_SPEC)
    flat = np.zeros(at_misc + len(ek.MISC_NAMES))
    flat[at_pa:at_pa + pa.size] = pa
    misc = dict(pa_out=ap.out_idx, pa_v1=ap.v1_row, pa_v2=ap.v2_row,
                pa_in=ap.input_row, pa_att=ap.alpha_attack,
                pa_rel=ap.alpha_release, pa_iavg=ap.alpha_i_avg,
                spk_sr=sp.sample_rate, spk_alpha=sp.thermal_alpha,
                post_gain=tables.POST_SPEAKER_GAIN)
    for k, name in enumerate(ek.MISC_NAMES):
        flat[at_misc + k] = misc.get(name, 0.0)
    return flat


@functools.lru_cache(maxsize=None)
def _pa_consts_on(sample_rate, device):
    return torch.from_numpy(pa_speaker_consts(sample_rate)).to(device)


def _pa_rows_spec():
    a = ek.CHAIN_OFF["pa_v"][0]
    return {n: (o0 - a, o1 - a) for n, (o0, o1) in ek.CHAIN_OFF.items()
            if a <= o0 < ek.CHAIN_OFF["spk"][1]}


def init_pa_speaker_state(sample_rate: float, streams: int, device="cpu"):
    """(PA_SPEAKER_ROWS, streams): the power amp (at `sample_rate`) at its
    DC point with the rails at rest, the speaker at rest."""
    st = power_amp.init_state(power_amp.make_params(sample_rate), device)
    spk = speaker.init_state(device)
    col = pa_speaker_rows(st, spk)
    return col[:, None].repeat(1, int(streams)).contiguous()


def pa_speaker_rows(pa: power_amp.PowerAmpState, spk: speaker.SpeakerState):
    """Power-amp and speaker states (batch (...)) → rows (PA_SPEAKER_ROWS,
    ...)."""
    c = pa.circuit
    batch = c.v.shape[:-1]

    def col(x):
        return torch.as_tensor(x, device=c.v.device).to(
            torch.float64).expand(batch)[..., None]

    parts = [c.v, c.i_nl, c.v_nl, col(c.nr_resid),
             *[col(d) for d in c.diag], *[col(r) for r in pa.rails],
             col(pa.last_good), col(spk.hpf.z1), col(spk.hpf.z2),
             col(spk.lpf.z1), col(spk.lpf.z2), col(spk.thermal_state)]
    return torch.cat([x.expand(batch + x.shape[-1:]) for x in parts],
                     dim=-1).movedim(-1, 0)


def pa_speaker_unrows(rows):
    """Rows (PA_SPEAKER_ROWS, ...) → (PowerAmpState, SpeakerState), copies,
    the solver counters as int32."""
    x = rows.movedim(0, -1)
    o = _pa_rows_spec()

    def seg(name):
        a, b = o[name]
        return x[..., a:b].clone()

    diag = seg("pa_diag")
    spk = seg("spk")
    pa = power_amp.PowerAmpState(
        circuit=mna.SolverState(
            v=seg("pa_v"), i_nl=seg("pa_i"), v_nl=seg("pa_vnl"),
            nr_resid=seg("pa_resid")[..., 0],
            diag=mna.SolverDiag(*[diag[..., k].to(torch.int32)
                                  for k in range(ek.N_DIAG)])),
        rails=power_amp.RailState(*seg("pa_rails").unbind(-1)),
        last_good=seg("pa_last")[..., 0])
    return pa, speaker.SpeakerState(
        biquad.BiquadState(spk[..., 0], spk[..., 1]),
        biquad.BiquadState(spk[..., 2], spk[..., 3]), spk[..., 4])


def pa_speaker_scan_plain(sample_rate, x, state, volume, character):
    """Plain E6 on the tensors' device: x (n, G) float64 → out (n, G);
    `state` is updated in place."""
    dev = x.device
    ap = power_amp.make_params(sample_rate)
    sp = speaker.make_params(sample_rate)
    coeffs = speaker.coeffs_t(torch.tensor(float(character),
                                           dtype=torch.float64, device=dev),
                              sample_rate)
    pa, spk = pa_speaker_unrows(state)
    out = torch.empty_like(x)
    with torch.inference_mode():
        for t in range(x.shape[0]):
            pa, y = power_amp.step(ap, pa, x[t] * volume * volume,
                                   rail_sag=True)
            spk, z = speaker.step(sp, spk, coeffs, y)
            out[t] = z * tables.POST_SPEAKER_GAIN
        state.copy_(pa_speaker_rows(pa, spk))
    return out


def pa_speaker_scan(sample_rate: float, x, state, volume: float,
                    character: float):
    """E6: G streams over x (n, G) float64 at `sample_rate` (the power
    amp's and the speaker's rate) → out (n, G) float64; `state`
    (PA_SPEAKER_ROWS, G) is updated in place."""
    global PA_SPEAKER_LAUNCHES, PA_SPEAKER_PLAIN_CALLS
    n, g = (x.shape if x.dim() == 2 else (-1, -1))
    ek._check("x", x, (n, g), torch.float64)
    ek._check("state", state, (PA_SPEAKER_ROWS, g), torch.float64)
    dev = x.device
    if state.device != dev:
        raise ValueError("x and state must be on one device")
    if dev.type == "cpu":
        PA_SPEAKER_PLAIN_CALLS += 1
        return pa_speaker_scan_plain(float(sample_rate), x, state,
                                     float(volume), float(character))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    consts = _pa_consts_on(float(sample_rate), str(dev))
    out = torch.empty_like(x)
    ek._lib_call("pa_speaker_scan", lambda lib: lib.ow_pa_speaker_scan,
                 consts.data_ptr(), consts.numel(), x.data_ptr(),
                 state.data_ptr(), out.data_ptr(), n, g,
                 ctypes.c_double(volume), ctypes.c_double(character),
                 device=dev)
    PA_SPEAKER_LAUNCHES += 1
    return out
