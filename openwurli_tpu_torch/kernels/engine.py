"""The f64 engine's kernels: E1 (voice bank), E2 (mono chain), E3
(tremolo settle scan).

The reference runs its float64 engine as one jitted `lax.scan` per chunk
(`openwurli_tpu/engine.py:452` `_render`) and settles the tremolo with
another (`openwurli_tpu/circuits/tremolo.py:160`); neither is a Pallas
kernel. In eager PyTorch one base sample of that scan is some 10⁴ small
ops, so on the card the sample loops are kernels of `csrc/engine.cu`:

  * **E1 `engine_voices`**: the 64 main + 64 steal voice slots over a
    chunk (reed + hammer noise + pickup, the active and steal-fade masks,
    NaN guard #1) and the chunk-end cleanup; writes each sample's mono
    sum. The voice bank never reads the chain, so E1 runs a whole chunk
    before E2.
  * **E2 `engine_chain<PRE, PA>`**: the chain over the chunk's mono
    input: the three smoothers, 2× allpass oversampling, per oversampled
    step the tremolo → LDR → preamp (the twin DK preamp, or the 12-node
    melange preamp with its thermal noise) → power amp (the circuit, or
    the memoryless behavioral model), downsampling, the speaker with its
    per-sample coefficient design, post gain and volume, NaN guard #2, the
    f32 cast. The two model choices are template arguments.
  * **E3 `tremolo_settle`**: the tremolo oscillator's mna step alone, n
    times.

Each has a plain version here, built from the ported step functions
(`voice.step`, `tremolo.step`, `dk_preamp.step`, `power_amp.step`,
`speaker.step`, `allpass`), that the CPU runs and the kernel is held to
bit for bit on the card. The state lives in packed float64 / int64
tensors (layouts below); every wrapper updates them in place. A CPU
tensor runs the plain version, a CUDA tensor the kernel; nothing falls
back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch import hammer, pickup, reed, tables, voice
from openwurli_tpu_torch.circuits import dk_preamp, gp, melange_preamp, mna
from openwurli_tpu_torch.circuits import power_amp
from openwurli_tpu_torch.circuits import speaker, tremolo
from openwurli_tpu_torch.ops import allpass, biquad, exact

MAX_VOICES = 64
SLOTS = 2 * MAX_VOICES   # main slots 0..63, steal slots 64..127
FREE, HELD, SUSTAINED, RELEASING = 0, 1, 2, 3
NM = tables.NUM_MODES

# ── voice bank layouts, (rows, SLOTS), one column per slot ──
# vpar float64: note-on constants
P_COS, P_SIN, P_PHASE, P_AMP, P_DECAY = 0, 7, 14, 21, 28
P_RAMP_N, P_RAMP_INC, P_SHAPE, P_REVERT, P_DIFF = 35, 36, 37, 38, 39
P_NDECAY, P_BPF, P_BETA, P_DS, P_GAIN, P_MIDI = 40, 41, 46, 47, 48, 49
NPAR = 50
# vst float64: per-sample state
S_S, S_C, S_ENV, S_DRIFT, S_DRATE, S_DMULT = 0, 7, 14, 21, 28, 35
S_DRAMP, S_DCOUNT, S_NAMP, S_Z1, S_Z2, S_Q = 42, 43, 44, 45, 46, 47
NST = 48
# vsti int64: integer state (u32 words as int64)
I_JST, I_N, I_DACT, I_DDONE, I_NREM, I_NFADE, I_NRNG = range(7)
NSTI = 7
# eng_i int64 (129,): slot states of the main slots, steal fades of the
# steal slots, the NaN-guard fire count
EI_FIRES = SLOTS
ENG_I = SLOTS + 1

# ── chain state layout, float64 (CHAIN_ROWS,) ──
N_T, M_T, NB_T = 7, 4, 2      # tremolo netlist: nodes+sources, ports, BJTs
N_PA, M_PA, NB_PA = 21, 16, 8  # power-amp netlist
N_DIAG = 5                    # cooldown, nr_fail, nan_reset, damp, be_steps
CHAIN_SPEC = (
    ("os_up_a", 3), ("os_up_b", 3), ("os_down_a", 3), ("os_down_b", 3),
    ("os_delay", 1),
    ("trem_v", N_T), ("trem_i", M_T), ("trem_vnl", M_T), ("trem_resid", 1),
    ("trem_diag", N_DIAG), ("trem_env", 1), ("trem_rldr", 1),
    ("pre_v", 16), ("pre_i", 4), ("pre_vnl", 4), ("pre_jcin", 2),
    ("pre_cinprev", 2), ("pre_gprev", 1),
    ("pa_v", N_PA), ("pa_i", M_PA), ("pa_vnl", M_PA), ("pa_resid", 1),
    ("pa_diag", N_DIAG), ("pa_rails", 4), ("pa_last", 1),
    ("spk", 5),
    ("sm_volume", 4), ("sm_depth", 4), ("sm_char", 4),
    # the melange preamp (used by engines built with it; appended, so that
    # no earlier row moved): twin v, i_nl, v_nl, g_ldr_prev, the noise
    # key's two u32 words (exact in float64), the previous draws
    ("mel_v", 2 * melange_preamp.N), ("mel_i", 2 * melange_preamp.M),
    ("mel_vnl", 2 * melange_preamp.M), ("mel_gprev", 1), ("mel_key", 2),
    ("mel_wprev", melange_preamp.N_RES),
)
CHAIN_OFF = {}
_o = 0
for _n, _k in CHAIN_SPEC:
    CHAIN_OFF[_n] = (_o, _o + _k)
    _o += _k
CHAIN_ROWS = _o
OSC_ROWS = N_T + 2 * M_T + 1 + N_DIAG  # E3's state: trem_v .. trem_diag
SM_CUR, SM_TARGET, SM_STEP, SM_REM = range(4)
PREAMP_MODELS = ("dk", "melange")
PA_MODELS = ("circuit", "behavioral")

# Launch counters: *_LAUNCHES count CUDA launches, *_PLAIN_CALLS the calls
# served by the plain version.
VOICES_LAUNCHES = SETTLE_LAUNCHES = 0
VOICES_PLAIN_CALLS = CHAIN_PLAIN_CALLS = SETTLE_PLAIN_CALLS = 0
# E2's launches by instantiation (preamp_model, pa_model)
CHAIN_LAUNCHES_BY_MODELS = {(p, a): 0 for p in ("dk", "melange")
                            for a in ("circuit", "behavioral")}


# ─────────────────────────── voice bank packing ───────────────────────────


def pack_voice_columns(vparams: voice.VoiceParams, vstate: voice.VoiceState):
    """Note-on params and state of V voices (NumPy, from voice.note_on_params
    / voice.init_state, batch shape (V,)) → (vpar (NPAR, V), vst (NST, V),
    vsti (NSTI, V)) NumPy float64 / int64."""
    r, nz, pk = vparams.reed, vparams.noise, vparams.pickup
    v = np.asarray(vparams.midi_note).shape[0]

    def rows(x, k=1):
        return np.broadcast_to(np.asarray(x, np.float64).T, (k, v)) \
            if k > 1 else np.broadcast_to(np.asarray(x, np.float64), (v,))[None]

    vpar = np.concatenate([
        rows(r.cos_inc, NM), rows(r.sin_inc, NM), rows(r.phase_inc, NM),
        rows(r.amplitude, NM), rows(r.decay_mult, NM),
        rows(r.onset_ramp_samples), rows(r.onset_ramp_inc),
        rows(r.onset_shape_exp), rows(r.jitter_revert),
        rows(r.jitter_diffusion), rows(nz.decay_per_sample),
        *[rows(c) for c in nz.bpf], rows(pk.beta), rows(pk.displacement_scale),
        rows(vparams.post_pickup_gain), rows(vparams.midi_note)])
    rs, ns = vstate.reed, vstate.noise
    vst = np.concatenate([
        rows(rs.s, NM), rows(rs.c, NM), rows(rs.envelope, NM),
        rows(rs.jitter_drift, NM), rows(rs.damper_rate, NM),
        rows(rs.damper_mult, NM), rows(rs.damper_ramp_samples),
        rows(rs.damper_release_count), rows(ns.amplitude), rows(ns.bpf.z1),
        rows(ns.bpf.z2), rows(vstate.pickup.q)])

    def irow(x):
        return np.broadcast_to(np.asarray(x).astype(np.int64), (v,))[None]

    vsti = np.concatenate([
        irow(rs.jitter_state), irow(rs.n), irow(rs.damper_active),
        irow(rs.damper_ramp_done), irow(ns.remaining),
        irow(ns.fade_in_remaining), irow(ns.rng_state)])
    return (np.ascontiguousarray(vpar), np.ascontiguousarray(vst),
            np.ascontiguousarray(vsti))


def unpack_voices(vpar, vst, vsti, cols=slice(None)):
    """Packed columns → (VoiceParams, VoiceState) of torch views, batch
    first (mode fields (V, 7)); booleans as bool tensors."""
    p, s, i = vpar[:, cols], vst[:, cols], vsti[:, cols]

    def m(x, a):
        return x[a:a + NM].T

    rp = reed.ReedParams(
        cos_inc=m(p, P_COS), sin_inc=m(p, P_SIN), phase_inc=m(p, P_PHASE),
        amplitude=m(p, P_AMP), decay_mult=m(p, P_DECAY),
        onset_ramp_samples=p[P_RAMP_N], onset_ramp_inc=p[P_RAMP_INC],
        onset_shape_exp=p[P_SHAPE], jitter_revert=p[P_REVERT],
        jitter_diffusion=p[P_DIFF])
    params = voice.VoiceParams(
        reed=rp,
        noise=hammer.NoiseParams(
            decay_per_sample=p[P_NDECAY],
            bpf=biquad.BiquadCoeffs(*[p[P_BPF + k] for k in range(5)])),
        pickup=pickup.PickupParams(beta=p[P_BETA],
                                   displacement_scale=p[P_DS]),
        post_pickup_gain=p[P_GAIN], midi_note=p[P_MIDI])
    rs = reed.ReedState(
        s=m(s, S_S), c=m(s, S_C), envelope=m(s, S_ENV),
        jitter_drift=m(s, S_DRIFT), jitter_state=i[I_JST], n=i[I_N],
        damper_active=i[I_DACT] != 0, damper_rate=m(s, S_DRATE),
        damper_mult=m(s, S_DMULT), damper_ramp_samples=s[S_DRAMP],
        damper_release_count=s[S_DCOUNT], damper_ramp_done=i[I_DDONE] != 0)
    state = voice.VoiceState(
        reed=rs,
        noise=hammer.NoiseState(
            amplitude=s[S_NAMP], remaining=i[I_NREM],
            fade_in_remaining=i[I_NFADE],
            bpf=biquad.BiquadState(s[S_Z1], s[S_Z2]), rng_state=i[I_NRNG]),
        pickup=pickup.PickupState(q=s[S_Q]))
    return params, state


def write_voice_state(vst, vsti, state: voice.VoiceState, cols=slice(None)):
    """Write a (V,)-batched torch VoiceState into the packed columns."""
    rs, ns = state.reed, state.noise
    for a, x in ((S_S, rs.s), (S_C, rs.c), (S_ENV, rs.envelope),
                 (S_DRIFT, rs.jitter_drift), (S_DRATE, rs.damper_rate),
                 (S_DMULT, rs.damper_mult)):
        vst[a:a + NM, cols] = x.T
    for a, x in ((S_DRAMP, rs.damper_ramp_samples),
                 (S_DCOUNT, rs.damper_release_count), (S_NAMP, ns.amplitude),
                 (S_Z1, ns.bpf.z1), (S_Z2, ns.bpf.z2), (S_Q, state.pickup.q)):
        vst[a, cols] = x
    for a, x in ((I_JST, rs.jitter_state), (I_N, rs.n),
                 (I_DACT, rs.damper_active), (I_DDONE, rs.damper_ramp_done),
                 (I_NREM, ns.remaining), (I_NFADE, ns.fade_in_remaining),
                 (I_NRNG, ns.rng_state)):
        vsti[a, cols] = x.to(torch.int64)


def mono_sum(outs):
    """(T, SLOTS) gated voice outputs → (T,) mono: the main slots summed in
    slot order, then the steal slots, then the two added."""
    cols = outs.unbind(1)
    main, steal = cols[0], cols[MAX_VOICES]
    for k in range(1, MAX_VOICES):
        main = main + cols[k]
        steal = steal + cols[MAX_VOICES + k]
    return main + steal


def voices_plain(vpar, vst, vsti, eng_i, num_samples, fade_len,
                 sample_rate):
    """Plain E1 on the tensors' device → mono (num_samples,) float64; the
    state tensors are updated in place."""
    params, state = unpack_voices(vpar, vst, vsti)
    slot_state = eng_i[:MAX_VOICES].clone()
    steal_fade = eng_i[MAX_VOICES:SLOTS].clone()
    outs = torch.empty((num_samples, SLOTS), dtype=torch.float64,
                       device=vpar.device)
    bad_any = torch.empty(num_samples, dtype=torch.bool, device=vpar.device)
    with torch.inference_mode():
        for t in range(num_samples):
            state, out = voice.step(params, state)
            v_out = torch.where(slot_state != FREE, out[:MAX_VOICES], 0.0)
            gain = exact.div(steal_fade.to(torch.float64), fade_len)
            s_out = torch.where(steal_fade > 0, out[MAX_VOICES:] * gain, 0.0)
            steal_fade = torch.clamp(steal_fade - 1, min=0)
            v_bad = ~torch.isfinite(v_out)
            s_bad = ~torch.isfinite(s_out)
            bad_any[t] = torch.any(v_bad) | torch.any(s_bad)
            outs[t, :MAX_VOICES] = torch.where(v_bad, 0.0, v_out)
            outs[t, MAX_VOICES:] = torch.where(s_bad, 0.0, s_out)
            slot_state = torch.where(v_bad, FREE, slot_state)
            steal_fade = torch.where(s_bad, 0, steal_fade)
        mono = mono_sum(outs)
        # chunk-end cleanup: silent main voices go FREE
        main = slice(0, MAX_VOICES)
        silent = voice.is_silent(
            voice.VoiceParams(*[_cols(x, main) for x in params]),
            voice.VoiceState(*[_cols(x, main) for x in state]), sample_rate)
        slot_state = torch.where((slot_state != FREE) & silent, FREE,
                                 slot_state)
        write_voice_state(vst, vsti, state)
        eng_i[:MAX_VOICES] = slot_state
        eng_i[MAX_VOICES:SLOTS] = steal_fade
        eng_i[EI_FIRES] += bad_any.sum()
    return mono


def _cols(tree, cols):
    """Slice the slot (first) axis of every tensor in a NamedTuple tree."""
    if isinstance(tree, tuple):
        return type(tree)(*[_cols(x, cols) for x in tree])
    return tree[cols]


# ──────────────────────────── chain constants ────────────────────────────


class ChainParams(NamedTuple):
    """One sample rate's chain with its two model choices: the step
    functions' params, and the flat float64 constant buffer the kernels
    read (`flat`, NumPy; the melange block last, melange engines only)."""

    sample_rate: float
    os_sample_rate: float
    oversample: bool
    tremolo: tremolo.TremoloParams
    preamp: dk_preamp.PreampParams
    power_amp: power_amp.PowerAmpParams
    speaker: speaker.SpeakerParams
    flat: np.ndarray
    offsets: dict
    preamp_model: str = "dk"
    pa_model: str = "circuit"
    melange: melange_preamp.MelangePreampParams = None


def solver_block(netlist, params: mna.SolverParams) -> np.ndarray:
    """One netlist's solver constants in the kernels' order (SolverLayout
    in csrc/engine.cu): 4 scalars [trap_i, n_nodes, trap_primary, 0], then
    s, a_hist, n_v, n_i, s_ni, k, w, w_scale, v_dc, i_dc, v_nl_dc, s_be,
    a_hist_be, s_ni_be, k_be, w_scale_be, nvt, vcrit, the GP derivative
    params (n_bjt × 13, gp.PARAM_NAMES) and the current params (n_bjt ×
    13, gp.CURRENT_NAMES), row-major."""
    if netlist.diodes:
        raise NotImplementedError("the engine kernels take BJTs only")
    nvt, vcrit = mna.junction_limits(netlist)
    models = [b[4] for b in netlist.bjts]
    trap = float(params.trap_i_hist)
    parts = [np.array([trap, netlist.n_nodes, trap != 0.0, 0.0]),
             params.s, params.a_hist, params.n_v, params.n_i, params.s_ni,
             params.k, params.w, params.w_scale, params.v_dc, params.i_dc,
             params.v_nl_dc, params.s_be, params.a_hist_be, params.s_ni_be,
             params.k_be, params.w_scale_be, nvt, vcrit,
             gp.pack_bjt_params(models, np.float64),
             gp.pack_current_params(models)]
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in parts])


def solver_block_size(n, m, nb):
    return 4 + 4 * n * n + 4 * n * m + 2 * m * m + 4 * n + 4 * m + 26 * nb


_NM, _MM = melange_preamp.N, melange_preamp.M
MEL_SPEC = (("a_hist", _NM * _NM), ("s", _NM * _NM), ("n_v", _MM * _NM),
            ("n_i", _NM * _MM), ("s_ni", _NM * _MM), ("k", _MM * _MM),
            ("ws_w", _NM), ("v_dc", _NM), ("i_dc", _MM), ("v_nl_dc", _MM),
            ("s_fb_col", _NM), ("s_fb_fb", 1), ("k_outer", _MM * _MM),
            ("sfb_ni", _MM), ("inject", _NM * melange_preamp.N_RES),
            ("sigma", melange_preamp.N_RES), ("cur", 26), ("der", 26),
            ("diode", 2), ("idx", 3))


def melange_block(params: melange_preamp.MelangePreampParams) -> np.ndarray:
    """The melange step's constants in MEL_SPEC order (MelOffset in
    csrc/engine.cu), row-major: the step_tensors, each BJT's 13 current
    (gp.CURRENT_NAMES) and 13 derivative (gp.PARAM_NAMES) params, the
    diode's (is_, n·vt), and the node indices (fb, out, input row)."""
    c = melange_preamp.step_tensors(params)
    nl = melange_preamp.build_netlist()
    models = [b[4] for b in nl.bjts]
    (_, _, _, diode), = nl.diodes
    parts = {k: c[k].numpy() for k, _ in MEL_SPEC
             if k not in ("cur", "der", "diode", "idx")}
    parts.update(cur=gp.pack_current_params(models),
                 der=gp.pack_bjt_params(models, np.float64),
                 diode=np.array([diode.is_, diode.n * diode.vt]),
                 idx=np.array([c["fb"], c["out"], c["input_row"]],
                              np.float64))
    out = []
    for name, size in MEL_SPEC:
        a = np.asarray(parts[name], np.float64).reshape(-1)
        if a.size != size:
            raise AssertionError(f"melange block {name}: {a.size} != {size}")
        out.append(a)
    return np.concatenate(out)


PRE_SPEC = (("a_neg_base", 64), ("s_base", 64), ("two_w", 8), ("k", 4),
            ("k_outer", 4), ("s_fb_col", 8), ("ni_col0", 8), ("ni_col1", 8),
            ("sfb_ni", 2), ("v_dc", 8), ("v_nl_dc", 2), ("i_nl_dc", 2),
            ("s_fb_fb", 1), ("g_cin", 1), ("c_cin", 1), ("gc_1pc", 1),
            ("j_cin_dc", 1))
MISC_NAMES = ("trem_out", "trem_att", "trem_rel", "pa_out", "pa_v1",
              "pa_v2", "pa_in", "pa_att", "pa_rel", "pa_iavg", "spk_sr",
              "spk_alpha", "oversample", "post_gain", "ln_rmax", "ln_span")


@functools.lru_cache(maxsize=None)
def chain_params(sample_rate: float, preamp_model: str = "dk",
                 pa_model: str = "circuit") -> ChainParams:
    """The chain's params at base rate `sample_rate` with its preamp
    ("dk" or "melange") and power amp ("circuit" or "behavioral")
    (cached)."""
    if preamp_model not in PREAMP_MODELS:
        raise ValueError(f"preamp_model {preamp_model!r}")
    if pa_model not in PA_MODELS:
        raise ValueError(f"pa_model {pa_model!r}")
    sr = float(sample_rate)
    oversample = sr < 88_200.0
    os_sr = 2.0 * sr if oversample else sr
    tp = tremolo.make_params(os_sr)
    pp = dk_preamp.make_params(os_sr)
    ap = power_amp.make_params(os_sr)
    sp = speaker.make_params(sr)
    pre_t = dk_preamp.step_tensors(pp)
    blocks = [
        ("trem", solver_block(tremolo.build_netlist(), tp.solver)),
        ("pa", solver_block(power_amp.build_netlist(), ap.solver)),
        ("pre", np.concatenate([pre_t[k].numpy().ravel()
                                for k, _ in PRE_SPEC])),
        ("misc", np.array([tp.out_idx, tp.ldr_attack, tp.ldr_release,
                           ap.out_idx, ap.v1_row, ap.v2_row, ap.input_row,
                           ap.alpha_attack, ap.alpha_release, ap.alpha_i_avg,
                           sp.sample_rate, sp.thermal_alpha, oversample,
                           tables.POST_SPEAKER_GAIN, tremolo._LN_R_MAX,
                           tremolo._LN_MIN_MINUS_MAX], np.float64)),
    ]
    offsets, off = {}, 0
    for name, arr in blocks:
        offsets[name] = off
        off += arr.size
    mel = None
    if preamp_model == "melange":
        mel = melange_preamp.make_params(os_sr)
        offsets["mel"] = off
        blocks.append(("mel", melange_block(mel)))
    if blocks[0][1].size != solver_block_size(N_T, M_T, NB_T) or \
            blocks[1][1].size != solver_block_size(N_PA, M_PA, NB_PA):
        raise AssertionError("netlist dimensions differ from the kernels'")
    return ChainParams(sr, os_sr, oversample, tp, pp, ap, sp,
                       np.concatenate([a for _, a in blocks]), offsets,
                       preamp_model, pa_model, mel)


@functools.lru_cache(maxsize=None)
def _flat_on(cp_key, device: str):
    return torch.from_numpy(chain_params(*cp_key).flat).to(device)


def _cp_key(cp: ChainParams):
    return (cp.sample_rate, cp.preamp_model, cp.pa_model)


# ───────────────────────── chain state packing ─────────────────────────


class ChainState(NamedTuple):
    os: allpass.OversamplerState
    trem: tremolo.TremoloState
    pre: dk_preamp.PreampState
    pa: power_amp.PowerAmpState
    spk: speaker.SpeakerState
    volume: torch.Tensor     # (4,) smoother: current, target, step, rem
    depth: torch.Tensor
    char: torch.Tensor
    mel: melange_preamp.MelangePreampState  # key words as int64


def _seg(flat, name):
    a, b = CHAIN_OFF[name]
    return flat[a:b]


def _diag(x):
    return mna.SolverDiag(*[x[k].to(torch.int32) for k in range(N_DIAG)])


def unpack_chain(flat) -> ChainState:
    """(CHAIN_ROWS,) float64 → ChainState of tensors (copies)."""
    g = {n: _seg(flat, n).clone() for n, _ in CHAIN_SPEC}
    rails = g["pa_rails"]
    spk = g["spk"]
    return ChainState(
        os=allpass.OversamplerState(g["os_up_a"], g["os_up_b"],
                                    g["os_down_a"], g["os_down_b"],
                                    g["os_delay"][0]),
        trem=tremolo.TremoloState(
            osc=mna.SolverState(g["trem_v"], g["trem_i"], g["trem_vnl"],
                                g["trem_resid"][0], _diag(g["trem_diag"])),
            ldr_envelope=g["trem_env"][0], r_ldr=g["trem_rldr"][0]),
        pre=dk_preamp.PreampState(
            v=g["pre_v"].view(2, 8), i_nl=g["pre_i"].view(2, 2),
            v_nl=g["pre_vnl"].view(2, 2), j_cin=g["pre_jcin"],
            cin_rhs_prev=g["pre_cinprev"], g_ldr_prev=g["pre_gprev"][0]),
        pa=power_amp.PowerAmpState(
            circuit=mna.SolverState(g["pa_v"], g["pa_i"], g["pa_vnl"],
                                    g["pa_resid"][0], _diag(g["pa_diag"])),
            rails=power_amp.RailState(*rails.unbind(0)),
            last_good=g["pa_last"][0]),
        spk=speaker.SpeakerState(biquad.BiquadState(spk[0], spk[1]),
                                 biquad.BiquadState(spk[2], spk[3]), spk[4]),
        volume=g["sm_volume"], depth=g["sm_depth"], char=g["sm_char"],
        mel=melange_preamp.MelangePreampState(
            v=g["mel_v"].view(2, _NM), i_nl=g["mel_i"].view(2, _MM),
            v_nl=g["mel_vnl"].view(2, _MM), g_ldr_prev=g["mel_gprev"][0],
            noise_key=g["mel_key"].to(torch.int64),
            noise_w_prev=g["mel_wprev"]))


def pack_chain(st: ChainState, out=None):
    """ChainState → (CHAIN_ROWS,) float64 (into `out` when given)."""
    def f(x):
        return torch.as_tensor(x).to(torch.float64).reshape(-1)

    def diag(d):
        return torch.stack([f(x)[0] for x in d])

    o, t, p, a, s, m = st.os, st.trem, st.pre, st.pa, st.spk, st.mel
    parts = [o.up_a, o.up_b, o.down_a, o.down_b, o.down_delay,
             t.osc.v, t.osc.i_nl, t.osc.v_nl, t.osc.nr_resid,
             diag(t.osc.diag), t.ldr_envelope, t.r_ldr,
             p.v, p.i_nl, p.v_nl, p.j_cin, p.cin_rhs_prev, p.g_ldr_prev,
             a.circuit.v, a.circuit.i_nl, a.circuit.v_nl, a.circuit.nr_resid,
             diag(a.circuit.diag), *a.rails, a.last_good,
             s.hpf.z1, s.hpf.z2, s.lpf.z1, s.lpf.z2, s.thermal_state,
             st.volume, st.depth, st.char, m.v, m.i_nl, m.v_nl, m.g_ldr_prev,
             m.noise_key, m.noise_w_prev]
    flat = torch.cat([f(x) for x in parts])
    if flat.numel() != CHAIN_ROWS:
        raise AssertionError(f"chain state has {flat.numel()} rows")
    if out is None:
        return flat
    out.copy_(flat)
    return out


def smoother(value, device="cpu"):
    return torch.tensor([value, value, 0.0, 0.0], dtype=torch.float64,
                        device=device)


def init_melange_rows(cp: ChainParams, device="cpu"):
    """The melange rows' reset state: the preamp's DC point and its noise
    key at PRNGKey(0x5EED) on a melange engine, zeros (unused) on a DK
    engine."""
    if cp.melange is not None:
        return melange_preamp.init_state(cp.melange, device=device)

    def z(*shape, dtype=torch.float64):
        return torch.zeros(shape, dtype=dtype, device=device)

    return melange_preamp.MelangePreampState(
        z(2, _NM), z(2, _MM), z(2, _MM), z(), z(2, dtype=torch.int64),
        z(melange_preamp.N_RES))


def init_chain_parts(cp: ChainParams, device="cpu"):
    """The chain's reset state (guard #2's targets) and the tremolo's."""
    return dict(os=allpass.init_state(device=device),
                pre=dk_preamp.init_state(cp.preamp, device),
                pa=power_amp.init_state(cp.power_amp, device),
                spk=speaker.init_state(device),
                mel=init_melange_rows(cp, device))


def init_chain(cp: ChainParams, device="cpu", volume=0.5, depth=0.5,
               character=0.0):
    """The engine's initial chain state, packed."""
    parts = init_chain_parts(cp, device)
    return pack_chain(ChainState(
        trem=tremolo.init_state(cp.os_sample_rate, device),
        volume=smoother(volume, device), depth=smoother(depth, device),
        char=smoother(character, device), **parts))


def smoother_next(s):
    """(4,) smoother → (smoother', value)."""
    cur, target, step, rem = s.unbind(0)
    active = rem > 0
    nxt = torch.where(active, cur + step, cur)
    rem = torch.where(active, rem - 1.0, rem)
    nxt = torch.where(active & (rem == 0.0), target, nxt)
    return torch.stack([nxt, target, step, rem]), nxt


def chain_plain(cp: ChainParams, mono, flat, rail_sag: bool,
                noise_scale: float = 0.0):
    """Plain E2 on the tensors' device: mono (T,) float64 → out (T,)
    float32; `flat` (CHAIN_ROWS,) is updated in place. `noise_scale` is
    the melange preamp's noise_enabled · noise_gain."""
    dev = mono.device
    st = unpack_chain(flat)
    melange = cp.preamp_model == "melange"
    pre_c = (melange_preamp.step_tensors(cp.melange, dev) if melange
             else dk_preamp.step_tensors(cp.preamp, dev))
    inits = init_chain_parts(cp, dev)
    os_, trem, pa, spk = st.os, st.trem, st.pa, st.spk
    pre = st.mel if melange else st.pre
    vol_s, dep_s, chr_s = st.volume, st.depth, st.char
    out = torch.empty(mono.shape[0], dtype=torch.float32, device=dev)
    drive = tables.FIXED_CIRCUIT_DRIVE
    scale = torch.tensor(float(noise_scale), dtype=torch.float64, device=dev)

    def nonlinear(trem, pre, pa, u, depth):
        trem, shunt = tremolo.step(cp.tremolo, trem, depth)
        g = dk_preamp.ldr_conductance(shunt)
        if melange:
            pre, pre_out = melange_preamp.step(pre_c, pre, g, u, scale)
        else:
            pre, pre_out = dk_preamp.step(pre_c, pre, g, u)
        if cp.pa_model == "circuit":
            pa, y = power_amp.step(cp.power_amp, pa, pre_out * drive,
                                   rail_sag)
        else:
            y = power_amp.behavioral_process(pre_out * drive)
        return trem, pre, pa, y

    with torch.inference_mode():
        for t in range(mono.shape[0]):
            dep_s, depth = smoother_next(dep_s)
            vol_s, user_vol = smoother_next(vol_s)
            chr_s, char = smoother_next(chr_s)
            if cp.oversample:
                os_, (e, o) = allpass.up_step(os_, mono[t])
                trem, pre, pa, y0 = nonlinear(trem, pre, pa, e, depth)
                trem, pre, pa, y1 = nonlinear(trem, pre, pa, o, depth)
                os_, amp_out = allpass.down_step(os_, y0, y1)
            else:
                trem, pre, pa, amp_out = nonlinear(trem, pre, pa, mono[t],
                                                   depth)
            coeffs = speaker.coeffs_t(char, cp.speaker.sample_rate)
            spk, shaped = speaker.step(cp.speaker, spk, coeffs, amp_out)
            y = shaped * tables.POST_SPEAKER_GAIN * user_vol
            if not bool(torch.isfinite(y)):
                # NaN guard #2: reset preamp (the melange one's noise key
                # and draws included), oversampler, power amp and speaker
                # (not the tremolo), emit silence
                os_, pa, spk = inits["os"], inits["pa"], inits["spk"]
                pre = inits["mel"] if melange else inits["pre"]
                y = torch.zeros_like(y)
            out[t] = y.to(torch.float32)
        pack_chain(ChainState(
            os_, trem, st.pre if melange else pre, pa, spk, vol_s, dep_s,
            chr_s, pre if melange else st.mel), out=flat)
    return out


# ──────────────────────────── tremolo settle ────────────────────────────


def osc_flat(osc: mna.SolverState):
    """SolverState → (OSC_ROWS,) float64 (E3's state)."""
    return torch.cat([osc.v, osc.i_nl, osc.v_nl,
                      torch.as_tensor(osc.nr_resid,
                                      device=osc.v.device).reshape(1)
                      .to(torch.float64),
                      torch.stack([d.to(torch.float64) for d in osc.diag])
                      if osc.diag is not None else
                      torch.zeros(N_DIAG, dtype=torch.float64,
                                  device=osc.v.device)])


def osc_unflat(x) -> mna.SolverState:
    a = N_T + 2 * M_T
    return mna.SolverState(v=x[:N_T].clone(), i_nl=x[N_T:N_T + M_T].clone(),
                           v_nl=x[N_T + M_T:a].clone(), nr_resid=x[a].clone(),
                           diag=_diag(x[a + 1:a + 1 + N_DIAG]))


def settle_plain(sample_rate, state, n_steps):
    """Plain E3: n_steps of the oscillator step at `sample_rate` on state
    (OSC_ROWS,), in place."""
    osc = osc_unflat(state)
    step = tremolo.osc_step_fn(tremolo.make_params(sample_rate),
                               state.device)
    w0 = torch.zeros(N_T, dtype=torch.float64, device=state.device)
    with torch.inference_mode():
        for _ in range(n_steps):
            osc, _ = step(osc, w0)
        state.copy_(osc_flat(osc))
    return state


@functools.lru_cache(maxsize=None)
def _trem_block_on(sample_rate: float, device: str):
    return torch.from_numpy(solver_block(
        tremolo.build_netlist(), tremolo.make_params(sample_rate).solver)).to(
            device)


# ───────────────────────────── CUDA wrappers ─────────────────────────────


def _check(name, x, shape, dtype):
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lib_call(name, fn, *args, device):
    from openwurli_tpu_torch import _build

    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(_build.library())(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel failed: {_build.error(err)}")


def render_voices(vpar, vst, vsti, eng_i, num_samples: int, fade_len: float,
                  sample_rate: float):
    """E1: one chunk of the 128 voice slots → mono (num_samples,) float64;
    vst, vsti and eng_i are updated in place (the chunk-end cleanup
    included)."""
    global VOICES_LAUNCHES, VOICES_PLAIN_CALLS
    f64, i64 = torch.float64, torch.int64
    _check("vpar", vpar, (NPAR, SLOTS), f64)
    _check("vst", vst, (NST, SLOTS), f64)
    _check("vsti", vsti, (NSTI, SLOTS), i64)
    _check("eng_i", eng_i, (ENG_I,), i64)
    dev = vpar.device
    if not (vst.device == vsti.device == eng_i.device == dev):
        raise ValueError("the voice tensors must be on one device")
    n = int(num_samples)
    if dev.type == "cpu":
        VOICES_PLAIN_CALLS += 1
        return voices_plain(vpar, vst, vsti, eng_i, n, float(fade_len),
                            float(sample_rate))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    mono = torch.empty(n, dtype=f64, device=dev)
    _lib_call("engine_voices", lambda lib: lib.ow_engine_voices,
              vpar.data_ptr(), vst.data_ptr(), vsti.data_ptr(),
              eng_i.data_ptr(), mono.data_ptr(), n,
              ctypes.c_double(fade_len), ctypes.c_double(sample_rate),
              device=dev)
    VOICES_LAUNCHES += 1
    return mono


def render_chain(cp: ChainParams, mono, chain, rail_sag: bool,
                 noise_scale: float = 0.0):
    """E2: the chain over mono (T,) float64 → out (T,) float32; `chain`
    (CHAIN_ROWS,) float64 is updated in place. The instantiation is
    `cp`'s (preamp_model, pa_model); `noise_scale` (noise_enabled ·
    noise_gain) acts on the melange preamp only."""
    global CHAIN_PLAIN_CALLS
    n = mono.shape[0]
    _check("mono", mono, (n,), torch.float64)
    _check("chain", chain, (CHAIN_ROWS,), torch.float64)
    dev = mono.device
    if chain.device != dev:
        raise ValueError("mono and chain must be on one device")
    if dev.type == "cpu":
        CHAIN_PLAIN_CALLS += 1
        return chain_plain(cp, mono, chain, bool(rail_sag),
                           float(noise_scale))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    flat = _flat_on(_cp_key(cp), str(dev))
    out = torch.empty(n, dtype=torch.float32, device=dev)
    _lib_call("engine_chain", lambda lib: lib.ow_engine_chain,
              flat.data_ptr(), flat.numel(), mono.data_ptr(),
              chain.data_ptr(), out.data_ptr(), n, int(bool(rail_sag)),
              PREAMP_MODELS.index(cp.preamp_model),
              PA_MODELS.index(cp.pa_model), ctypes.c_double(noise_scale),
              device=dev)
    CHAIN_LAUNCHES_BY_MODELS[cp.preamp_model, cp.pa_model] += 1
    return out


def settle(sample_rate: float, state, n_steps: int):
    """E3: n_steps of the tremolo oscillator at `sample_rate` on state
    (OSC_ROWS,) float64, in place; returns state."""
    global SETTLE_LAUNCHES, SETTLE_PLAIN_CALLS
    _check("state", state, (OSC_ROWS,), torch.float64)
    dev = state.device
    if dev.type == "cpu":
        SETTLE_PLAIN_CALLS += 1
        return settle_plain(float(sample_rate), state, int(n_steps))
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    block = _trem_block_on(float(sample_rate), str(dev))
    _lib_call("tremolo_settle", lambda lib: lib.ow_tremolo_settle,
              block.data_ptr(), block.numel(), state.data_ptr(),
              int(n_steps), device=dev)
    SETTLE_LAUNCHES += 1
    return state


def tremolo_settle(sample_rate: float, osc: mna.SolverState,
                   n_steps: int) -> mna.SolverState:
    """The settle scan from `osc` (tensors on the card or the CPU)."""
    return osc_unflat(settle(sample_rate, osc_flat(osc), n_steps))
