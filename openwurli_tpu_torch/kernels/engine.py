"""The f64 engine's kernels: E1 (voice bank), E2 (mono chain), E3
(tremolo settle scan), and the stage benchmark's E8 (tremolo scan) and E9
(power-amp scan).

The reference runs its float64 engine as one jitted `lax.scan` per chunk
(`openwurli_tpu/engine.py:452` `_render`) and settles the tremolo with
another (`openwurli_tpu/circuits/tremolo.py:160`); neither is a Pallas
kernel. In eager PyTorch one base sample of that scan is some 10⁴ small
ops, so on the card the sample loops are kernels of `csrc/engine.cu`:

  * **E1 `engine_voices`**: the 64 main + 64 steal voice slots over a
    chunk (reed + hammer noise + pickup, the active and steal-fade masks,
    NaN guard #1) and the chunk-end cleanup; writes each sample's mono
    sum. Up to `VOICES_LANES_MAX_ENGINES` engines eight threads per slot
    on E4's group body, a cluster of eight blocks of 16 slots per engine,
    the gated samples summed in slot order on the cluster's leader; above
    it a thread per slot, a block per engine. The two forms agree bit for
    bit. The voice bank never reads the chain, so E1 runs a whole chunk
    before E2.
  * **E2 `engine_chain<PRE, PA>`**: the chain over the chunk's mono
    input: the three smoothers, 2× allpass oversampling, per oversampled
    step the tremolo → LDR → preamp (the twin DK preamp, or the 12-node
    melange preamp with its thermal noise) → power amp (the circuit, or
    the memoryless behavioral model), downsampling, the speaker with its
    per-sample coefficient design, post gain and volume, NaN guard #2, the
    f32 cast. The two model choices are template arguments. Every
    instantiation has three forms, in bands of width (`chain_form`): a
    warp per engine (`engine_chain_warp_kernel`: the tremolo's, the
    preamp's and the circuit power amp's steps, or the behavioral one's
    Newton loop, on the whole warp, the rest on lane 0) up to
    `CHAIN_WARP_MAX_ENGINES`, a half-warp per engine
    (`engine_chain_half_kernel`: the same on a 16-lane segment, two
    engines to a warp) up to `CHAIN_HALF_MAX_ENGINES`, and a thread per
    engine (`engine_chain_kernel`; the behavioral instantiations with
    each step's values in registers and the engine's rows in shared
    memory) above. The three forms agree bit for bit.
  * **E3 `tremolo_settle`**: the tremolo oscillator's mna step alone, n
    times, on one warp (E2's tremolo step without the vactrol).
  * **E8 `tremolo_scan`**: G tremolo circuits, a warp each (four to a
    block), over n steps at the tremolo's own rate (`tremolo.step`:
    oscillator, vactrol, the divider's shunt at the circuit's depth), E2's
    warp tremolo step.
  * **E9 `power_amp_scan`**: G streams, a warp each (four to a block),
    over n samples of `power_amp.step` with rail sag on at the input's
    rate, E2's and E6's warp power-amp step alone (E6 without volume² and
    the speaker). E8 and E9 replace the reference's per-stage scans
    (`tools/stage_bench.py:82-83`), which `tools/torch_stage_bench.py`
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
TREM_ROWS = CHAIN_OFF["trem_rldr"][1] - CHAIN_OFF["trem_v"][0]  # E8's
PA_ROWS = CHAIN_OFF["pa_last"][1] - CHAIN_OFF["pa_v"][0]        # E9's
SM_CUR, SM_TARGET, SM_STEP, SM_REM = range(4)
PREAMP_MODELS = ("dk", "melange")
PA_MODELS = ("circuit", "behavioral")

# Launch counters: *_LAUNCHES count CUDA launches, *_PLAIN_CALLS the calls
# served by the plain version.
SETTLE_LAUNCHES = 0
VOICES_PLAIN_CALLS = CHAIN_PLAIN_CALLS = SETTLE_PLAIN_CALLS = 0
TREMOLO_SCAN_LAUNCHES = TREMOLO_SCAN_PLAIN_CALLS = 0
POWER_AMP_SCAN_LAUNCHES = POWER_AMP_SCAN_PLAIN_CALLS = 0
# E1's launches by form: "lanes" eight threads per slot (a cluster of
# blocks per engine), "thread" a thread per slot (a block per engine)
VOICES_LAUNCHES_BY_FORM = {"lanes": 0, "thread": 0}
# The widest batch (engines) at which E1 runs its cluster form; wider
# batches run the thread form (None: the cluster form at every width, 0:
# the thread form). Per 256-sample chunk the cluster form takes
# 0.145-0.146 ms at 1 engine, 0.285 at 64, 0.324-0.325 at 96 and
# 0.448-0.451 at 128; the thread form (its libm behind warp votes) 0.410,
# 0.413-0.414, 0.414 and 0.415-0.417: at 128 the thread form wins, and
# from there on (192: 0.439 against 0.604-0.610; 1024: 1.244 against
# 2.715-2.716): eight threads per slot repeat the voice's serial tail on
# every thread, which a full card pays for. (NVIDIA H100 80GB HBM3, 700 W,
# tools/torch_voices_sweep.py --form lanes / thread, three calls each;
# PERF.md §6.)
VOICES_LANES_MAX_ENGINES = 96
# E2's forms, in ow_engine_chain's numbering: "thread" a thread per
# engine, "warp" a warp per engine, "half" a half-warp per engine (two
# engines to a warp)
CHAIN_FORMS = ("thread", "warp", "half")
# E2's launches by (preamp_model, pa_model, form)
CHAIN_LAUNCHES_BY_FORM = {(p, a, f): 0 for p in ("dk", "melange")
                          for a in ("circuit", "behavioral")
                          for f in CHAIN_FORMS}
# E2's bands of width, by (preamp_model, pa_model): a warp per engine up
# to CHAIN_WARP_MAX_ENGINES engines, a half-warp per engine above that up
# to CHAIN_HALF_MAX_ENGINES, a thread per engine above both (None: no
# upper limit, 0: the form never runs). Set on distinct engines, since a
# broadcast never lets a warp's two segments diverge: aggregate realtime
# factor, 256-sample chunks, three calls each, warp / half / thread
# (tools/torch_perf_sweep.py --traffic distinct --form: chip_smoke.py
# phase 28 (a)'s 128 distinct engines tiled; NVIDIA H100 80GB HBM3,
# 700 W; PERF.md §5-6):
#   <dk, circuit>: the half form leads at every width: 256: 78.7-78.9 /
#   82.4-83.1; 512: 154.1-155.3 / 161.9-163.1; 1024: 248.1-251.7 /
#   311.6-312.7; 2048: 209.8-213.1 / 487.8-491.8; 8192: 505.2-513.0 /
#   248.6-250.3 (thread); 16384: 517.5-524.8 / 376.8-377.2 (thread). One
#   engine (the broadcast chord, the kernel alone): 18.04 / 16.98 ms.
#   <melange, circuit>: 256: 13.2 / 13.3; 512: 25.9-26.0 / 26.5; 1024:
#   48.3-48.5 / 52.6-52.7; 2048: 63.6-65.1 / 98.7; 8192: 116.2-117.5 /
#   38.9-39.3 (thread); 16384: 118.3-119.3 / 54.5-54.6 (thread). One
#   engine (chord, the kernel alone) 24.49 / 24.59 ms, so one engine (the
#   melange Engine and its plugin) keeps the warp form; 2-255 engines are
#   not measured on distinct engines.
#   <dk, behavioral>: 256: 178.5-181.8 / 178.6-182.1; 512: 342.0-347.5 /
#   339.1-340.5; 1024: 573.3-577.6 / 628.3-634.1. Half / thread (the
#   thread form with its working set in registers and shared memory):
#   512: 336.1-337.4 / 214.5-215.2; 1024: 625.9-633.5 / 401.4-405.2;
#   2048: 1021.2-1024.3 / 736.9-744.2; 4096: 995.3-1002.0 /
#   1275.3-1281.5; 8192: 1195.1-1212.7 / 1994.4-2005.2; 16384:
#   1220.7-1226.0 / 2780.3-2790.2.
#   <melange, behavioral>: 256: 40.1-43.7 / 42.6-42.9; 512: 85.3-86.1 /
#   84.5-85.2; 1024: 159.1-160.3 / 164.8-166.7. Half / thread (as
#   above): 512: 84.3-85.0 / 28.6-28.8; 1024: 164.9-166.6 / 57.4-57.8;
#   2048: 298.7-301.9 / 114.1-114.9; 4096: 287.3-291.0 / 222.8-224.4;
#   8192: 367.6-370.9 / 425.2-427.9; 16384: 372.8-376.6 / 777.0-782.9.
# The broadcast chord's sweeps (PERF.md §5) gave the same bands but for
# <melange, circuit>, whose warp form led there up to 512 engines.
CHAIN_WARP_MAX_ENGINES = {("dk", "circuit"): 0,
                          ("melange", "circuit"): 1,
                          ("dk", "behavioral"): 512,
                          ("melange", "behavioral"): 512}
CHAIN_HALF_MAX_ENGINES = {("dk", "circuit"): None,
                          ("melange", "circuit"): None,
                          ("dk", "behavioral"): 2048,
                          ("melange", "behavioral"): 4096}


def chain_form(preamp_model: str, pa_model: str, b: int) -> str:
    """The form of E2 that render_chain launches for b engines."""
    models = (preamp_model, pa_model)
    for form, limits in (("warp", CHAIN_WARP_MAX_ENGINES),
                         ("half", CHAIN_HALF_MAX_ENGINES)):
        widest = limits[models]
        if widest is None or b <= widest:
            return form
    return "thread"


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
    """(..., SLOTS) gated voice outputs → (...) mono: the main slots summed
    in slot order, then the steal slots, then the two added."""
    cols = outs.unbind(-1)
    main, steal = cols[0], cols[MAX_VOICES]
    for k in range(1, MAX_VOICES):
        main = main + cols[k]
        steal = steal + cols[MAX_VOICES + k]
    return main + steal


def _flat_slots(x):
    """(B, rows, SLOTS) → (rows, B·SLOTS), engine b's slots in columns
    b·SLOTS .. b·SLOTS + 127 (a copy)."""
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def voices_plain(vpar, vst, vsti, eng_i, num_samples, fade_len,
                 sample_rate):
    """Plain E1 on the tensors' device. One engine: vpar (NPAR, SLOTS), vst
    (NST, SLOTS), vsti (NSTI, SLOTS), eng_i (ENG_I,) → mono (num_samples,)
    float64; B engines: the same with a leading B axis → mono (B,
    num_samples). The state tensors are updated in place. The B engines'
    slots step as one batch of B·SLOTS voices, elementwise, and each
    engine's slot sum runs in slot order, so each engine's row equals its
    one-engine call."""
    if vpar.dim() == 2:
        return voices_plain(*[x.unsqueeze(0) for x in (vpar, vst, vsti,
                                                       eng_i)],
                            num_samples, fade_len, sample_rate)[0]
    b = vpar.shape[0]
    params, state = unpack_voices(_flat_slots(vpar), _flat_slots(vst),
                                  _flat_slots(vsti))
    slot_state = eng_i[:, :MAX_VOICES].clone()
    steal_fade = eng_i[:, MAX_VOICES:SLOTS].clone()
    outs = torch.empty((num_samples, b, SLOTS), dtype=torch.float64,
                       device=vpar.device)
    bad_any = torch.empty((num_samples, b), dtype=torch.bool,
                          device=vpar.device)
    with torch.inference_mode():
        for t in range(num_samples):
            state, out = voice.step(params, state)
            out = out.view(b, SLOTS)
            v_out = torch.where(slot_state != FREE, out[:, :MAX_VOICES], 0.0)
            gain = exact.div(steal_fade.to(torch.float64), fade_len)
            s_out = torch.where(steal_fade > 0, out[:, MAX_VOICES:] * gain,
                                0.0)
            steal_fade = torch.clamp(steal_fade - 1, min=0)
            v_bad = ~torch.isfinite(v_out)
            s_bad = ~torch.isfinite(s_out)
            bad_any[t] = torch.any(v_bad, -1) | torch.any(s_bad, -1)
            outs[t, :, :MAX_VOICES] = torch.where(v_bad, 0.0, v_out)
            outs[t, :, MAX_VOICES:] = torch.where(s_bad, 0.0, s_out)
            slot_state = torch.where(v_bad, FREE, slot_state)
            steal_fade = torch.where(s_bad, 0, steal_fade)
        mono = mono_sum(outs).T.contiguous()
        # chunk-end cleanup: silent main voices go FREE
        main = (torch.arange(b, device=vpar.device)[:, None] * SLOTS
                + torch.arange(MAX_VOICES, device=vpar.device)).reshape(-1)
        silent = voice.is_silent(
            voice.VoiceParams(*[_cols(x, main) for x in params]),
            voice.VoiceState(*[_cols(x, main) for x in state]),
            sample_rate).view(b, MAX_VOICES)
        slot_state = torch.where((slot_state != FREE) & silent, FREE,
                                 slot_state)
        flat_st = torch.empty((NST, b * SLOTS), dtype=torch.float64,
                              device=vpar.device)
        flat_sti = torch.empty((NSTI, b * SLOTS), dtype=torch.int64,
                               device=vpar.device)
        write_voice_state(flat_st, flat_sti, state)
        vst.copy_(flat_st.view(NST, b, SLOTS).transpose(0, 1))
        vsti.copy_(flat_sti.view(NSTI, b, SLOTS).transpose(0, 1))
        eng_i[:, :MAX_VOICES] = slot_state
        eng_i[:, MAX_VOICES:SLOTS] = steal_fade
        eng_i[:, EI_FIRES] += bad_any.sum(0)
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
    return flat[..., a:b]


def _diag(x):
    return mna.SolverDiag(*[x[..., k].to(torch.int32) for k in range(N_DIAG)])


def unpack_chain(flat) -> ChainState:
    """(..., CHAIN_ROWS) float64 → ChainState of tensors (copies) with the
    batch shape (...) first; the DK preamp's twin axis follows it."""
    g = {n: _seg(flat, n).clone() for n, _ in CHAIN_SPEC}
    batch = tuple(flat.shape[:-1])
    rails = g["pa_rails"]
    spk = g["spk"]

    def one(x):
        return x[..., 0]

    return ChainState(
        os=allpass.OversamplerState(g["os_up_a"], g["os_up_b"],
                                    g["os_down_a"], g["os_down_b"],
                                    one(g["os_delay"])),
        trem=tremolo.TremoloState(
            osc=mna.SolverState(g["trem_v"], g["trem_i"], g["trem_vnl"],
                                one(g["trem_resid"]), _diag(g["trem_diag"])),
            ldr_envelope=one(g["trem_env"]), r_ldr=one(g["trem_rldr"])),
        pre=dk_preamp.PreampState(
            v=g["pre_v"].view(batch + (2, 8)),
            i_nl=g["pre_i"].view(batch + (2, 2)),
            v_nl=g["pre_vnl"].view(batch + (2, 2)), j_cin=g["pre_jcin"],
            cin_rhs_prev=g["pre_cinprev"], g_ldr_prev=one(g["pre_gprev"])),
        pa=power_amp.PowerAmpState(
            circuit=mna.SolverState(g["pa_v"], g["pa_i"], g["pa_vnl"],
                                    one(g["pa_resid"]), _diag(g["pa_diag"])),
            rails=power_amp.RailState(*rails.unbind(-1)),
            last_good=one(g["pa_last"])),
        spk=speaker.SpeakerState(
            biquad.BiquadState(one(spk), spk[..., 1]),
            biquad.BiquadState(spk[..., 2], spk[..., 3]), spk[..., 4]),
        volume=g["sm_volume"], depth=g["sm_depth"], char=g["sm_char"],
        mel=melange_preamp.MelangePreampState(
            v=g["mel_v"].view(batch + (2, _NM)),
            i_nl=g["mel_i"].view(batch + (2, _MM)),
            v_nl=g["mel_vnl"].view(batch + (2, _MM)),
            g_ldr_prev=one(g["mel_gprev"]),
            noise_key=g["mel_key"].to(torch.int64),
            noise_w_prev=g["mel_wprev"]))


def pack_chain(st: ChainState, out=None):
    """ChainState (batch shape (...) first, as unpack_chain gives it) →
    (..., CHAIN_ROWS) float64 (into `out` when given)."""
    batch = tuple(torch.as_tensor(st.volume).shape[:-1])

    def f(x):
        return torch.as_tensor(x).to(torch.float64).reshape(batch + (-1,))

    def diag(d):
        return torch.stack([f(x)[..., 0] for x in d], -1)

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
    flat = torch.cat([f(x) for x in parts], -1)
    if flat.shape[-1] != CHAIN_ROWS:
        raise AssertionError(f"chain state has {flat.shape[-1]} rows")
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
        trem=tremolo.init_state(cp.os_sample_rate, device=device),
        volume=smoother(volume, device), depth=smoother(depth, device),
        char=smoother(character, device), **parts))


def smoother_next(s):
    """(..., 4) smoother → (smoother', value)."""
    cur, target, step, rem = s.unbind(-1)
    active = rem > 0
    nxt = torch.where(active, cur + step, cur)
    rem = torch.where(active, rem - 1.0, rem)
    nxt = torch.where(active & (rem == 0.0), target, nxt)
    return torch.stack([nxt, target, step, rem], -1), nxt


def _twin_first(pre: dk_preamp.PreampState, axis):
    """The DK preamp's state between the chain's layout (engines first,
    the twin axis after them) and dk_preamp.step's (twin axis first):
    axis 0 moves the twin axis to the front, -1 moves it back."""
    src, dst = (-2, 0) if axis == 0 else (0, -2)
    j_src, j_dst = (-1, 0) if axis == 0 else (0, -1)
    return pre._replace(v=pre.v.movedim(src, dst),
                        i_nl=pre.i_nl.movedim(src, dst),
                        v_nl=pre.v_nl.movedim(src, dst),
                        j_cin=pre.j_cin.movedim(j_src, j_dst),
                        cin_rhs_prev=pre.cin_rhs_prev.movedim(j_src, j_dst))


def _where_engines(bad, ini, cur):
    """Per engine (bad (B,)), `ini` (one engine's state, broadcast) where
    bad, `cur` elsewhere, over a NamedTuple tree."""
    if isinstance(cur, tuple):
        return type(cur)(*[_where_engines(bad, i, c)
                           for i, c in zip(ini, cur)])
    return torch.where(bad.view((-1,) + (1,) * (cur.dim() - 1)), ini, cur)


def chain_plain(cp: ChainParams, mono, flat, rail_sag, noise_scale=0.0):
    """Plain E2 on the tensors' device. One engine: mono (T,) float64,
    `flat` (CHAIN_ROWS,), rail_sag a bool, noise_scale a float → out (T,)
    float32; B engines: mono (B, T), flat (B, CHAIN_ROWS), rail_sag (B,)
    bool and noise_scale (B,) float64 tensors → out (B, T). `flat` is
    updated in place; `noise_scale` is the melange preamp's noise_enabled
    · noise_gain. The engines run as one batch, elementwise, each leaving
    its Newton loops on its own and taking NaN guard #2 on its own, as a
    kernel thread does, so each engine's row equals its one-engine call.
    (On the CPU, torch vectorises `pow` over longer tensors, from 16
    elements on with AVX-512, and rounds it there otherwise than one at a
    time: the tremolo's and the speaker's `pow` over that many engines
    may differ from one engine's in the last place.)"""
    dev = mono.device
    if mono.dim() == 1:
        return chain_plain(cp, mono[None], flat[None],
                           torch.tensor([bool(rail_sag)], device=dev),
                           torch.tensor([float(noise_scale)],
                                        dtype=torch.float64, device=dev))[0]
    st = unpack_chain(flat)
    melange = cp.preamp_model == "melange"
    pre_c = (melange_preamp.step_tensors(cp.melange, dev) if melange
             else dk_preamp.step_tensors(cp.preamp, dev))
    inits = init_chain_parts(cp, dev)
    os_, trem, pa, spk = st.os, st.trem, st.pa, st.spk
    pre = st.mel if melange else st.pre
    pre_init = inits["mel"] if melange else inits["pre"]
    vol_s, dep_s, chr_s = st.volume, st.depth, st.char
    out = torch.empty(mono.shape, dtype=torch.float32, device=dev)
    drive = tables.FIXED_CIRCUIT_DRIVE

    def nonlinear(trem, pre, pa, u, depth):
        trem, shunt = tremolo.step(cp.tremolo, trem, depth)
        g = dk_preamp.ldr_conductance(shunt)
        if melange:
            pre, pre_out = melange_preamp.step(pre_c, pre, g, u, noise_scale)
        else:
            pre, pre_out = dk_preamp.step(pre_c, _twin_first(pre, 0), g, u)
            pre = _twin_first(pre, -1)
        if cp.pa_model == "circuit":
            pa, y = power_amp.step(cp.power_amp, pa, pre_out * drive,
                                   rail_sag)
        else:
            y = power_amp.behavioral_process(pre_out * drive)
        return trem, pre, pa, y

    with torch.inference_mode():
        for t in range(mono.shape[1]):
            x = mono[:, t]
            dep_s, depth = smoother_next(dep_s)
            vol_s, user_vol = smoother_next(vol_s)
            chr_s, char = smoother_next(chr_s)
            if cp.oversample:
                os_, (e, o) = allpass.up_step(os_, x)
                trem, pre, pa, y0 = nonlinear(trem, pre, pa, e, depth)
                trem, pre, pa, y1 = nonlinear(trem, pre, pa, o, depth)
                os_, amp_out = allpass.down_step(os_, y0, y1)
            else:
                trem, pre, pa, amp_out = nonlinear(trem, pre, pa, x, depth)
            coeffs = speaker.coeffs_t(char, cp.speaker.sample_rate)
            spk, shaped = speaker.step(cp.speaker, spk, coeffs, amp_out)
            y = shaped * tables.POST_SPEAKER_GAIN * user_vol
            # NaN guard #2, per engine: reset preamp (the melange one's
            # noise key and draws included), oversampler, power amp and
            # speaker (not the tremolo), emit silence
            bad = ~torch.isfinite(y)
            os_ = _where_engines(bad, inits["os"], os_)
            pa = _where_engines(bad, inits["pa"], pa)
            spk = _where_engines(bad, inits["spk"], spk)
            pre = _where_engines(bad, pre_init, pre)
            out[:, t] = torch.where(bad, 0.0, y).to(torch.float32)
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


# ──────────────── E8, E9: the stage benchmark's scans ────────────────


SCAN_STAGES = ("tremolo", "power_amp")


@functools.lru_cache(maxsize=None)
def scan_consts(sample_rate: float, stage: str) -> np.ndarray:
    """The constants of a one-stage scan: E8's ("tremolo"), E9's and E6's
    ("power_amp"). The f64 chain's layout (csrc/engine.cu ConstOffset)
    with that stage's solver block and misc entries built at
    `sample_rate` itself (the chain builds them at its oversampled rate);
    every other block and entry, which the scan never reads, zero (so no
    other circuit's operating point is solved for it)."""
    at_pa = solver_block_size(N_T, M_T, NB_T)
    at_misc = (at_pa + solver_block_size(N_PA, M_PA, NB_PA)
               + sum(k for _, k in PRE_SPEC))
    flat = np.zeros(at_misc + len(MISC_NAMES))
    if stage == "tremolo":
        tp = tremolo.make_params(sample_rate)
        flat[:at_pa] = solver_block(tremolo.build_netlist(), tp.solver)
        misc = dict(trem_out=tp.out_idx, trem_att=tp.ldr_attack,
                    trem_rel=tp.ldr_release, ln_rmax=tremolo._LN_R_MAX,
                    ln_span=tremolo._LN_MIN_MINUS_MAX)
    elif stage == "power_amp":
        ap = power_amp.make_params(sample_rate)
        pa = solver_block(power_amp.build_netlist(), ap.solver)
        flat[at_pa:at_pa + pa.size] = pa
        misc = dict(pa_out=ap.out_idx, pa_v1=ap.v1_row, pa_v2=ap.v2_row,
                    pa_in=ap.input_row, pa_att=ap.alpha_attack,
                    pa_rel=ap.alpha_release, pa_iavg=ap.alpha_i_avg)
    else:
        raise ValueError(f"scan stage {stage!r}")
    for k, name in enumerate(MISC_NAMES):
        flat[at_misc + k] = misc.get(name, 0.0)
    return flat


@functools.lru_cache(maxsize=None)
def _scan_consts_on(sample_rate, stage, device):
    return torch.from_numpy(scan_consts(sample_rate, stage)).to(device)


def _rows(parts, batch):
    """Fields of streams with batch shape `batch`, each a value per stream
    (batch) or a row vector per stream (batch + (k,)) → rows (sum of the
    widths,) + batch, float64."""
    dev = parts[0].device
    cols = []
    for x in parts:
        x = torch.as_tensor(x, device=dev).to(torch.float64)
        if x.dim() <= len(batch):
            x = x.expand(batch)[..., None]
        cols.append(x.expand(batch + x.shape[-1:]))
    return torch.cat(cols, dim=-1).movedim(-1, 0)


def _unrows(rows, first):
    """Rows (k, ...) whose first row is CHAIN_SPEC's `first` → a function
    giving a named segment as (..., width) copies."""
    x = rows.movedim(0, -1)
    a0 = CHAIN_OFF[first][0]

    def seg(name):
        a, b = CHAIN_OFF[name]
        return x[..., a - a0:b - a0].clone()

    return seg


def tremolo_rows(trem: tremolo.TremoloState):
    """Tremolo states (batch (...)) → rows (TREM_ROWS, ...)."""
    o = trem.osc
    return _rows([o.v, o.i_nl, o.v_nl, o.nr_resid, *o.diag,
                  trem.ldr_envelope, trem.r_ldr], tuple(o.v.shape[:-1]))


def tremolo_unrows(rows) -> tremolo.TremoloState:
    """Rows (TREM_ROWS, ...) → TremoloState (copies, counters int32)."""
    seg = _unrows(rows, "trem_v")
    return tremolo.TremoloState(
        osc=mna.SolverState(seg("trem_v"), seg("trem_i"), seg("trem_vnl"),
                            seg("trem_resid")[..., 0],
                            _diag(seg("trem_diag"))),
        ldr_envelope=seg("trem_env")[..., 0], r_ldr=seg("trem_rldr")[..., 0])


def power_amp_rows(pa: power_amp.PowerAmpState):
    """Power-amp states (batch (...)) → rows (PA_ROWS, ...)."""
    c = pa.circuit
    return _rows([c.v, c.i_nl, c.v_nl, c.nr_resid, *c.diag, *pa.rails,
                  pa.last_good], tuple(c.v.shape[:-1]))


def power_amp_unrows(rows) -> power_amp.PowerAmpState:
    """Rows (PA_ROWS, ...) → PowerAmpState (copies, counters int32)."""
    seg = _unrows(rows, "pa_v")
    return power_amp.PowerAmpState(
        circuit=mna.SolverState(seg("pa_v"), seg("pa_i"), seg("pa_vnl"),
                                seg("pa_resid")[..., 0],
                                _diag(seg("pa_diag"))),
        rails=power_amp.RailState(*seg("pa_rails").unbind(-1)),
        last_good=seg("pa_last")[..., 0])


def init_tremolo_scan_state(sample_rate: float, circuits: int,
                            device="cpu"):
    """(TREM_ROWS, circuits): the tremolo at `sample_rate` settled, its
    counters fresh, the LDR dark (tremolo.init_state)."""
    return tremolo_rows(tremolo.init_state(
        sample_rate, (int(circuits),), device=device)).contiguous()


def init_power_amp_scan_state(sample_rate: float, streams: int,
                              device="cpu"):
    """(PA_ROWS, streams): the power amp at `sample_rate` at its DC point,
    the rails at rest."""
    col = power_amp_rows(power_amp.init_state(
        power_amp.make_params(sample_rate), device))
    return col[:, None].repeat(1, int(streams)).contiguous()


def tremolo_scan_plain(sample_rate, state, depth, n):
    """Plain E8 on the tensors' device: n steps of `tremolo.step` over the
    circuits of `state` (updated in place) at depth (G,) → out (n, G)."""
    params = tremolo.make_params(sample_rate)
    trem = tremolo_unrows(state)
    out = torch.empty((n, state.shape[1]), dtype=torch.float64,
                      device=state.device)
    with torch.inference_mode():
        for t in range(n):
            trem, out[t] = tremolo.step(params, trem, depth)
        state.copy_(tremolo_rows(trem))
    return out


def power_amp_scan_plain(sample_rate, x, state):
    """Plain E9 on the tensors' device: `power_amp.step` with rail sag on
    over x (n, G) → out (n, G); `state` is updated in place."""
    params = power_amp.make_params(sample_rate)
    pa = power_amp_unrows(state)
    out = torch.empty_like(x)
    with torch.inference_mode():
        for t in range(x.shape[0]):
            pa, out[t] = power_amp.step(params, pa, x[t], rail_sag=True)
        state.copy_(power_amp_rows(pa))
    return out


# ───────────────────────────── CUDA wrappers ─────────────────────────────


def _check(name, x, shape, dtype):
    if not torch.is_tensor(x):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
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
    """E1: one chunk of the 128 voice slots of one engine (vpar (NPAR,
    SLOTS), vst (NST, SLOTS), vsti (NSTI, SLOTS) int64, eng_i (ENG_I,)
    int64) → mono (num_samples,) float64, or of B engines (the same with a
    leading B axis) → mono (B, num_samples). On the card E1 runs a cluster
    of eight blocks per engine, eight threads per slot, up to
    VOICES_LANES_MAX_ENGINES engines, a block per engine and a thread per
    slot above. vst, vsti and eng_i are updated in place (the chunk-end
    cleanup included). B = 0 launches nothing and returns a (0,
    num_samples) tensor."""
    global VOICES_PLAIN_CALLS
    f64, i64 = torch.float64, torch.int64
    lead = tuple(vpar.shape[:-2]) if vpar.dim() == 3 else ()
    _check("vpar", vpar, lead + (NPAR, SLOTS), f64)
    _check("vst", vst, lead + (NST, SLOTS), f64)
    _check("vsti", vsti, lead + (NSTI, SLOTS), i64)
    _check("eng_i", eng_i, lead + (ENG_I,), i64)
    dev = vpar.device
    if not (vst.device == vsti.device == eng_i.device == dev):
        raise ValueError("the voice tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    n = int(num_samples)
    if n < 0:
        raise ValueError(f"num_samples {n} < 0")
    if lead == (0,):
        return torch.empty((0, n), dtype=f64, device=dev)
    if dev.type == "cpu":
        VOICES_PLAIN_CALLS += 1
        return voices_plain(vpar, vst, vsti, eng_i, n, float(fade_len),
                            float(sample_rate))
    mono = torch.empty(lead + (n,), dtype=f64, device=dev)
    b = lead[0] if lead else 1
    lanes = VOICES_LANES_MAX_ENGINES is None or b <= VOICES_LANES_MAX_ENGINES
    _lib_call("engine_voices",
              lambda lib: (lib.ow_engine_voices if lanes
                           else lib.ow_engine_voices_thread),
              vpar.data_ptr(), vst.data_ptr(), vsti.data_ptr(),
              eng_i.data_ptr(), mono.data_ptr(), n, b,
              ctypes.c_double(fade_len), ctypes.c_double(sample_rate),
              device=dev)
    VOICES_LAUNCHES_BY_FORM["lanes" if lanes else "thread"] += 1
    return mono


def render_chain(cp: ChainParams, mono, chain, rail_sag,
                 noise_scale=0.0):
    """E2: the chain of one engine over mono (T,) float64 with `chain`
    (CHAIN_ROWS,) float64, rail_sag a bool and noise_scale a float → out
    (T,) float32; or of B engines over mono (B, T) with chain (B,
    CHAIN_ROWS), rail_sag (B,) bool and noise_scale (B,) float64 tensors
    on the same device → out (B, T). On the card E2 runs the form that
    chain_form gives for B engines: a warp per engine, a half-warp per
    engine or a thread per engine. `chain` is updated in place. The instantiation is
    `cp`'s (preamp_model, pa_model); `noise_scale` (noise_enabled ·
    noise_gain) acts on the melange preamp only. B = 0 launches nothing
    and returns a (0, T) tensor."""
    global CHAIN_PLAIN_CALLS
    dev = mono.device
    if mono.dim() == 1:
        _check("mono", mono, mono.shape, torch.float64)
        _check("chain", chain, (CHAIN_ROWS,), torch.float64)
        return render_chain(
            cp, mono[None], chain[None],
            torch.tensor([bool(rail_sag)], device=dev),
            torch.tensor([float(noise_scale)], dtype=torch.float64,
                         device=dev))[0]
    b, n = mono.shape if mono.dim() == 2 else (None, None)
    _check("mono", mono, (b, n), torch.float64)
    _check("chain", chain, (b, CHAIN_ROWS), torch.float64)
    _check("rail_sag", rail_sag, (b,), torch.bool)
    _check("noise_scale", noise_scale, (b,), torch.float64)
    if not (chain.device == rail_sag.device == noise_scale.device == dev):
        raise ValueError("mono, chain and the flags must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    if dev.type == "cpu":
        CHAIN_PLAIN_CALLS += 1
        return chain_plain(cp, mono, chain, rail_sag, noise_scale)
    flat = _flat_on(_cp_key(cp), str(dev))
    form = chain_form(cp.preamp_model, cp.pa_model, b)
    _lib_call("engine_chain", lambda lib: lib.ow_engine_chain,
              flat.data_ptr(), flat.numel(), mono.data_ptr(),
              chain.data_ptr(), out.data_ptr(), n, b, rail_sag.data_ptr(),
              PREAMP_MODELS.index(cp.preamp_model),
              PA_MODELS.index(cp.pa_model), noise_scale.data_ptr(),
              CHAIN_FORMS.index(form), device=dev)
    CHAIN_LAUNCHES_BY_FORM[cp.preamp_model, cp.pa_model, form] += 1
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


def tremolo_scan(sample_rate: float, state, depth, n: int):
    """E8: G tremolo circuits (state (TREM_ROWS, G) float64, updated in
    place) stepped n times at `sample_rate`, circuit j at depth[j] (G,)
    float64 → the shunt impedance after each step, (n, G) float64."""
    global TREMOLO_SCAN_LAUNCHES, TREMOLO_SCAN_PLAIN_CALLS
    g = state.shape[1] if state.dim() == 2 else -1
    _check("state", state, (TREM_ROWS, g), torch.float64)
    _check("depth", depth, (g,), torch.float64)
    n = int(n)
    if n < 0:
        raise ValueError(f"n {n} < 0")
    dev = state.device
    if depth.device != dev:
        raise ValueError("state and depth must be on one device")
    if dev.type == "cpu":
        TREMOLO_SCAN_PLAIN_CALLS += 1
        return tremolo_scan_plain(float(sample_rate), state, depth, n)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    consts = _scan_consts_on(float(sample_rate), "tremolo", str(dev))
    out = torch.empty((n, g), dtype=torch.float64, device=dev)
    _lib_call("tremolo_scan", lambda lib: lib.ow_tremolo_scan,
              consts.data_ptr(), consts.numel(), state.data_ptr(),
              depth.data_ptr(), out.data_ptr(), n, g, device=dev)
    TREMOLO_SCAN_LAUNCHES += 1
    return out


def power_amp_scan(sample_rate: float, x, state):
    """E9: G power-amp streams over x (n, G) float64 at `sample_rate`,
    rail sag on → out (n, G) float64; `state` (PA_ROWS, G) is updated in
    place."""
    global POWER_AMP_SCAN_LAUNCHES, POWER_AMP_SCAN_PLAIN_CALLS
    n, g = (x.shape if x.dim() == 2 else (-1, -1))
    _check("x", x, (n, g), torch.float64)
    _check("state", state, (PA_ROWS, g), torch.float64)
    dev = x.device
    if state.device != dev:
        raise ValueError("x and state must be on one device")
    if dev.type == "cpu":
        POWER_AMP_SCAN_PLAIN_CALLS += 1
        return power_amp_scan_plain(float(sample_rate), x, state)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    consts = _scan_consts_on(float(sample_rate), "power_amp", str(dev))
    out = torch.empty_like(x)
    _lib_call("power_amp_scan", lambda lib: lib.ow_power_amp_scan,
              consts.data_ptr(), consts.numel(), x.data_ptr(),
              state.data_ptr(), out.data_ptr(), n, g, device=dev)
    POWER_AMP_SCAN_LAUNCHES += 1
    return out
