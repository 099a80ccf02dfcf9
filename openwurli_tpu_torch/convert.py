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


def preroll_captures_from_numpy(caps, device="cpu"):
    """The reference's tremolo pre-roll captures (n_captures, 19) → float32
    tensor."""
    caps = np.asarray(caps)
    if caps.ndim != 2 or caps.shape[1] != mc.PREROLL_ROWS:
        raise ValueError(f"captures shape {caps.shape} is not "
                         f"(n, {mc.PREROLL_ROWS})")
    return torch.from_numpy(np.array(caps, dtype=np.float32, order="C",
                                     copy=True)).to(device)


def check_preroll_rows(rows):
    """Raise unless the reference's `preroll_rows()` table equals the
    port's: the captures are injected into the chain state by these spans.
    Returns the port's table."""
    mine = mc.preroll_rows()
    theirs = [(str(n), int(a), int(b), int(ca), int(cb))
              for n, a, b, ca, cb in rows]
    if theirs != mine:
        raise ValueError(f"preroll rows differ: {theirs} != {mine}")
    return mine


def fast_engine_from_numpy(sample_rate, midis, vels, onsets, releases,
                           n_used, ringing, pending, sustain, horizon,
                           chain_state=None, voice_state=None, device="cpu",
                           **engine_kw):
    """A port `FastEngine` in the session state of a reference engine: its
    host arrays (`_midis`, `_vels`, `_onsets`, `_releases`, `_n_used`,
    `_ringing`, `_pending`, `_sustain`, `_horizon`) and, optionally, its
    packed chain state (328, 1) and voice-bank state (48, 128).

    Without a voice state every used lane starts from its note-on state at
    the next block, as in an engine that has not rendered yet; with one,
    the lanes carry on from it."""
    from openwurli_tpu_torch.fast_engine import LANES, FastEngine

    eng = FastEngine(sample_rate, device=device, **engine_kw)
    for name, arr in (("_midis", midis), ("_vels", vels),
                      ("_onsets", onsets), ("_releases", releases)):
        a = np.array(arr, dtype=np.float64)
        if a.shape != (LANES,):
            raise ValueError(f"{name} shape {a.shape} != ({LANES},)")
        setattr(eng, name, a)
    eng._n_used = int(n_used)
    eng._ringing = {int(k): int(v) for k, v in dict(ringing).items()}
    eng._pending = {int(x) for x in pending}
    eng._sustain = bool(sustain)
    eng._horizon = int(horizon)
    eng._params_dirty = True
    if chain_state is not None:
        st = state_from_numpy(chain_state, device)
        if tuple(st.shape) != (mc.STATE_ROWS, 1):
            raise ValueError(f"chain state shape {tuple(st.shape)} != "
                             f"({mc.STATE_ROWS}, 1)")
        eng._chain_state = st
    if voice_state is not None:
        st = state_from_numpy(voice_state, device)
        if tuple(st.shape) != (vb.STATE_ROWS, LANES):
            raise ValueError(f"voice state shape {tuple(st.shape)} != "
                             f"({vb.STATE_ROWS}, {LANES})")
        eng._vstate = st
    return eng


# ── the f64 engine: the reference's state pytrees, as NumPy leaves ──


def solver_params_from_numpy(sp):
    """A reference `mna.SolverParams` (NumPy leaves) → the port's."""
    from openwurli_tpu_torch.circuits import mna

    return mna.SolverParams(**{
        k: (float(np.asarray(getattr(sp, k))) if k == "trap_i_hist"
            else np.asarray(getattr(sp, k), np.float64))
        for k in mna.SolverParams._fields})


def solver_state_from_numpy(st, device="cpu"):
    """A reference `mna.SolverState` → the port's, float64 / int32
    tensors."""
    from openwurli_tpu_torch.circuits import mna

    def t(x):
        return torch.tensor(np.asarray(x, np.float64), device=device)

    return mna.SolverState(
        v=t(st.v), i_nl=t(st.i_nl), v_nl=t(st.v_nl), nr_resid=t(st.nr_resid),
        diag=mna.SolverDiag(*[torch.tensor(np.asarray(d, np.int32),
                                           device=device)
                              for d in st.diag]))


def melange_params_from_numpy(mp):
    """A reference `MelangePreampParams` (NumPy leaves) → the port's."""
    from openwurli_tpu_torch.circuits import melange_preamp

    fields = {k: np.asarray(getattr(mp, k), np.float64)
              for k in ("s_fb_col", "nv_sfb", "sfb_ni", "noise_inject",
                        "noise_sigma")}
    return melange_preamp.MelangePreampParams(
        solver=solver_params_from_numpy(mp.solver), fb_idx=int(mp.fb_idx),
        out_idx=int(mp.out_idx), input_row=int(mp.input_row),
        sample_rate=float(mp.sample_rate),
        s_fb_fb=float(np.asarray(mp.s_fb_fb)), **fields)


def melange_state_from_numpy(st, device="cpu"):
    """A reference `MelangePreampState` → the port's: float64 tensors, the
    noise key's u32 words as int64."""
    from openwurli_tpu_torch.circuits import melange_preamp

    def t(x):
        return torch.tensor(np.asarray(x, np.float64), device=device)

    return melange_preamp.MelangePreampState(
        v=t(st.v), i_nl=t(st.i_nl), v_nl=t(st.v_nl),
        g_ldr_prev=t(st.g_ldr_prev),
        noise_key=torch.tensor(np.asarray(st.noise_key).astype(np.int64),
                               device=device),
        noise_w_prev=t(st.noise_w_prev))


def chain_state_from_numpy(sample_rate, st, device="cpu", preamp_model="dk",
                           pa_model="circuit"):
    """The chain and smoother parts of a reference `EngineState` at base
    rate `sample_rate` → the port's packed (CHAIN_ROWS,) float64 chain
    state. The reference's preamp state fills the DK preamp's rows, or on
    a melange engine the melange rows; the other preamp's rows hold what
    the port's engine of these models starts with."""
    from openwurli_tpu_torch.kernels import engine as ek

    def t(x):
        return torch.tensor(np.asarray(x, np.float64), device=device)

    def sm(s):
        return t([s.current, s.target, s.step, s.remaining])

    tr, pa = st.trem, st.pa
    cp = ek.chain_params(float(sample_rate), preamp_model, pa_model)
    if preamp_model == "melange":
        pre = ek.dk_preamp.init_state(cp.preamp, device)
        mel = melange_state_from_numpy(st.pre, device)
    else:
        pre = ek.dk_preamp.PreampState(*[t(x) for x in st.pre])
        mel = ek.init_melange_rows(cp, device)
    return ek.pack_chain(ek.ChainState(
        os=ek.allpass.OversamplerState(*[t(x) for x in st.os]),
        trem=ek.tremolo.TremoloState(
            osc=solver_state_from_numpy(tr.osc, device),
            ldr_envelope=t(tr.ldr_envelope), r_ldr=t(tr.r_ldr)),
        pre=pre, mel=mel,
        pa=ek.power_amp.PowerAmpState(
            circuit=solver_state_from_numpy(pa.circuit, device),
            rails=ek.power_amp.RailState(*[t(x) for x in pa.rails]),
            last_good=t(pa.last_good)),
        spk=ek.speaker.SpeakerState(
            ek.biquad.BiquadState(t(st.spk.hpf.z1), t(st.spk.hpf.z2)),
            ek.biquad.BiquadState(t(st.spk.lpf.z1), t(st.spk.lpf.z2)),
            t(st.spk.thermal_state)),
        volume=sm(st.volume), depth=sm(st.trem_depth), char=sm(st.spk_char)))


def _engine_tensors(sample_rate, st, device, preamp_model, pa_model):
    """One reference `EngineState` (NumPy leaves, read by field name) →
    the port's (vpar, vst, vsti, eng_i, chain) tensors on `device`."""
    from openwurli_tpu_torch.kernels import engine as ek

    main = ek.pack_voice_columns(st.vparams, st.vstate)
    steal = ek.pack_voice_columns(st.sparams, st.sstate)
    vpar, vst, vsti = (torch.from_numpy(np.concatenate([a, b], axis=1))
                       .to(device) for a, b in zip(main, steal))
    eng_i = torch.from_numpy(np.concatenate([
        np.asarray(st.slot_state, np.int64),
        np.asarray(st.steal_fade, np.int64),
        [int(np.asarray(st.nan_guard_fires))]])).to(device)
    chain = chain_state_from_numpy(sample_rate, st, device, preamp_model,
                                   pa_model)
    return vpar, vst, vsti, eng_i, chain


def engine_from_numpy(sample_rate, st, device="cpu", preamp_model="dk",
                      pa_model="circuit"):
    """A port `engine.Engine` in the state of a reference `Engine` built
    with the same models: `st` is its `EngineState` with NumPy leaves
    (`jax.tree.map(np.asarray, eng.state)`), read by field name. Voices,
    steal bank, gates, notes, ages, chain (the melange preamp's twin
    state and noise key included), smoothers, flags and counters are all
    carried over."""
    from openwurli_tpu_torch.engine import Engine

    eng = Engine(sample_rate, device=device, preamp_model=preamp_model,
                 pa_model=pa_model)
    for name, x in zip(("vpar", "vst", "vsti", "eng_i", "chain"),
                       _engine_tensors(sample_rate, st, device,
                                       preamp_model, pa_model)):
        getattr(eng, name).copy_(x)
    eng._slots, eng._slots_stale = eng.eng_i.cpu().numpy().copy(), False
    eng.midi_note = np.asarray(st.midi_note, np.int64).copy()
    eng.age = np.asarray(st.age, np.int64).copy()
    eng.age_counter = int(np.asarray(st.age_counter))
    eng._targets = {"volume": float(np.asarray(st.volume.target)),
                    "depth": float(np.asarray(st.trem_depth.target)),
                    "char": float(np.asarray(st.spk_char.target))}
    eng.sustain_held = bool(np.asarray(st.sustain_held))
    eng.mlp_enabled = bool(np.asarray(st.mlp_enabled))
    eng.rail_sag = bool(np.asarray(st.rail_sag))
    eng.noise_enabled = bool(np.asarray(st.noise_enabled))
    eng.noise_gain = float(np.asarray(st.noise_gain))
    return eng


def _engine_at(tree, b):
    """Engine b of a stacked reference EngineState (NumPy leaves)."""
    if isinstance(tree, tuple):
        return type(tree)(*[_engine_at(x, b) for x in tree])
    return np.asarray(tree)[b]


def engine_states_from_numpy(sample_rate, st, device="cpu",
                             preamp_model="dk", pa_model="circuit"):
    """A stacked reference `EngineState` (NumPy leaves with a leading B,
    e.g. `jax.tree.map(np.asarray, stacked)` of what `jax.vmap` renders)
    → the port's `engine.EngineState` of B engines on `device`, each
    engine's fields mapped as `engine_from_numpy` maps them, its own
    rail_sag and noise_enabled · noise_gain included. The notes, ages and
    the sustain pedal are host bookkeeping and stay behind."""
    from openwurli_tpu_torch.engine import EngineState

    b = np.asarray(st.rail_sag).shape[0]
    engines = [_engine_at(st, k) for k in range(b)]
    parts = [_engine_tensors(sample_rate, e, device, preamp_model, pa_model)
             for e in engines]
    return EngineState(
        *[torch.stack(xs) for xs in zip(*parts)],
        rail_sag=torch.tensor([bool(e.rail_sag) for e in engines],
                              device=device),
        noise_scale=torch.tensor(
            [(1.0 if bool(e.noise_enabled) else 0.0) * float(e.noise_gain)
             for e in engines], dtype=torch.float64, device=device))


# ── the calibration pipeline's parameters ──


def onset_params_from_numpy(params: dict, device="cpu") -> dict:
    """The reference onset model's params (NumPy dict, `fmt` included) →
    the port's dict of tensors on `device` (float32, `fmt` int32)."""
    from openwurli_tpu_torch.calib import onset_model

    return onset_model.params_to({k: np.asarray(v)
                                  for k, v in params.items()}, device)


def mlp_weights_from_numpy(weights, device="cpu") -> mlp.MlpWeights:
    """The reference's MlpWeights (any arrays, e.g. `calib.train`'s
    initial weights) → MlpWeights of float64 tensors on `device`."""
    return mlp.MlpWeights(*[
        torch.from_numpy(np.array(getattr(weights, k), np.float64)).to(
            device) for k in mlp.MlpWeights._fields])


def train_batch_from_numpy(batch, device="cpu"):
    """The reference's TrainBatch (any arrays) → the port's, tensors on
    `device` (float64; the mask bool)."""
    from openwurli_tpu_torch.calib import train

    def t(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(device)

    return train.TrainBatch(inputs=t(batch.inputs, np.float64),
                            targets=t(batch.targets, np.float64),
                            mask=t(batch.mask, bool),
                            weights=t(batch.weights, np.float64))
