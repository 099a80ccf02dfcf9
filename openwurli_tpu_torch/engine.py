"""The float64 polyphonic engine, the port of `openwurli_tpu/engine.py`,
in each of its configurations: the DK preamp or the 12-node melange
preamp (with its authentic thermal noise), and the circuit power amp or
the behavioral one.

64 voice slots plus a bank of 64 "steal" slots that render a stolen voice
under a 5 ms linear fade; the sustain state machine; 5 ms linear
smoothers for volume, tremolo depth and speaker character; NaN guards
before the oversampler and at the output; the 0.6 s warm-up.

`render` splits a request into chunks of the reference's CHUNK_LADDER
(16384, 2048, 256, then the remainder). A chunk is two launches: E1 runs
the voice slots over the chunk and ends with the voice cleanup (silent
voices go FREE), E2 runs the chain over E1's mono sum
(`kernels/engine.py`), the instantiation of E2 for the engine's two
models. The chunking decides when a slot goes FREE, so it is the
reference's.

State: the voice slots, their gates and the chain live in packed tensors
on the engine's device, updated in place. The host keeps the slots' notes
and ages, the flags and the smoother targets, and a copy of the slot
states that one read-back refreshes after a render, when a MIDI call or a
count needs it: nothing is read back per sample. MIDI calls write the
affected slot columns on the device.

Batches of engines: `EngineState` holds what one chunk of the reference's
`_render` reads and writes, for B engines, as device tensors with a
leading B axis. `render_states(eng, states, n)` renders one chunk of n
samples for all of them (E1 a cluster of eight blocks per engine, or a
thread per slot above `kernels.engine.VOICES_LANES_MAX_ENGINES`; E2 a
warp, a half-warp or a thread per engine, by width:
`kernels.engine.chain_form`),
the counterpart of `jax.vmap(lambda s: engine._render(eng, s, n))`;
`Engine.render` is its B = 1 call. `Engine.state` gets and sets one
engine's `EngineState`; `stack_states` and `broadcast_state` build
batches.

Runs on `device`, the card unless the caller asks for the CPU (where the
kernels' plain versions run).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from openwurli_tpu_torch import tables, voice
from openwurli_tpu_torch.kernels import engine as ek

MAX_VOICES = ek.MAX_VOICES
STEAL_FADE_S = 0.005
SMOOTH_S = 0.005
WARM_UP_S = 0.6
FREE, HELD, SUSTAINED, RELEASING = ek.FREE, ek.HELD, ek.SUSTAINED, \
    ek.RELEASING


class EngineState(NamedTuple):
    """B engines' render state on one device: what a chunk of the
    reference's `_render` reads and writes (its `EngineState` less the host
    bookkeeping: notes, ages, the sustain pedal and the MLP flag, which no
    render changes)."""

    vpar: torch.Tensor         # (B, NPAR, SLOTS) float64 voice constants
    vst: torch.Tensor          # (B, NST, SLOTS) float64 voice state
    vsti: torch.Tensor         # (B, NSTI, SLOTS) int64 voice state
    eng_i: torch.Tensor        # (B, ENG_I) int64 slot states, fades, fires
    chain: torch.Tensor        # (B, CHAIN_ROWS) float64 chain and smoothers
    rail_sag: torch.Tensor     # (B,) bool
    noise_scale: torch.Tensor  # (B,) float64 noise_enabled · noise_gain

    @property
    def batch(self) -> int:
        return self.vpar.shape[0]


def stack_states(states) -> EngineState:
    """Concatenate EngineStates along their engine axis (copies)."""
    return EngineState(*[torch.cat(xs) for xs in zip(*states)])


def broadcast_state(state: EngineState, b: int) -> EngineState:
    """b copies of a one-engine EngineState, as `jnp.broadcast_to` of
    every leaf (the melange preamp's noise key included: the copies draw
    the same noise, as under vmap)."""
    if state.batch != 1:
        raise ValueError(f"broadcast_state takes one engine, got "
                         f"{state.batch}")
    return EngineState(*[x.expand((int(b),) + x.shape[1:]).clone()
                         for x in state])


def render_states(eng: "Engine", states: EngineState, num_samples: int):
    """One chunk of num_samples for each of B engines that share `eng`'s
    sample rate and models: the voice slots (E1), the chunk-end cleanup,
    the chain (E2) → (states, out (B, num_samples) float32 on the states'
    device). The reference is `jax.vmap(lambda s: engine._render(eng, s,
    n))`. The state tensors are updated in place and returned. A CPU
    state takes the kernels' plain versions, a CUDA state the kernels; any
    other device raises. B = 0 renders nothing and returns a (0, n)
    output."""
    mono = ek.render_voices(states.vpar, states.vst, states.vsti,
                            states.eng_i, num_samples, eng.fade_len,
                            eng.sample_rate)
    out = ek.render_chain(eng.params, mono, states.chain, states.rail_sag,
                          states.noise_scale)
    return states, out


class Engine:
    """Host-facing engine: MIDI and parameter calls, `render`, counts."""

    CHUNK_LADDER = (16384, 2048, 256)

    def __init__(self, sample_rate: float, device="cuda",
                 preamp_model: str = "dk", pa_model: str = "circuit"):
        """preamp_model: "dk" (the 8-node DK preamp) or "melange" (the
        12-node preamp with the protection diode and thermal noise);
        pa_model: "circuit" (the 8-BJT solver) or "behavioral" (the
        closed-loop model)."""
        assert preamp_model in ("dk", "melange"), preamp_model
        assert pa_model in ("circuit", "behavioral"), pa_model
        self.sample_rate = float(sample_rate)
        self.device = torch.device(device)
        self.preamp_model = preamp_model
        self.pa_model = pa_model
        self.params = ek.chain_params(self.sample_rate, preamp_model,
                                      pa_model)
        self.oversample = self.params.oversample
        self.os_sample_rate = self.params.os_sample_rate
        self.ramp_samples = max(int(self.sample_rate * SMOOTH_S), 1)
        self.fade_samples = int(np.int32(self.sample_rate * STEAL_FADE_S))
        self.fade_len = float(max(int(self.sample_rate * STEAL_FADE_S), 1))
        self.mlp_enabled = True
        self.rail_sag = True
        self.noise_enabled = False
        self.noise_gain = 1.0
        self._flag_key = None
        self._init_state({"volume": 0.5, "depth": 0.5, "char": 0.0})

    # ── state ──

    def _init_state(self, targets):
        dummy = np.full(MAX_VOICES, 60.0)
        zero_vel = np.zeros(MAX_VOICES)
        vparams, detuned = voice.note_on_params(dummy, zero_vel,
                                                self.sample_rate,
                                                mlp_enabled=False)
        vstate = voice.init_state(vparams, detuned, zero_vel,
                                  self.sample_rate,
                                  np.zeros(MAX_VOICES, np.uint32))
        cols = ek.pack_voice_columns(vparams, vstate)
        vpar, vst, vsti = (torch.from_numpy(np.concatenate([c, c], axis=1))
                           .to(self.device) for c in cols)
        self.vpar, self.vst, self.vsti = vpar, vst, vsti
        self.eng_i = torch.zeros(ek.ENG_I, dtype=torch.int64,
                                 device=self.device)
        self.chain = ek.init_chain(self.params, self.device,
                                   targets["volume"], targets["depth"],
                                   targets["char"])
        self._targets = dict(targets)
        self.midi_note = np.zeros(MAX_VOICES, np.int64)
        self.age = np.zeros(MAX_VOICES, np.int64)
        self.age_counter = 0
        self.sustain_held = False
        self._slots = np.zeros(ek.ENG_I, np.int64)  # host copy of eng_i
        self._slots_stale = False

    def _host_slots(self):
        """The host copy of eng_i, refreshed by one read-back if a render
        ran since."""
        if self._slots_stale:
            self._slots = self.eng_i.cpu().numpy().copy()
            self._slots_stale = False
        return self._slots

    def _set_slots(self, idx, value):
        idx = np.atleast_1d(np.asarray(idx, np.int64))
        if idx.size == 0:
            return
        self._slots[idx] = value
        self.eng_i[torch.from_numpy(idx).to(self.device)] = int(value)

    def _damp(self, mask):
        """Start the damper of the main slots in `mask` (NumPy bool)."""
        if not mask.any():
            return
        main = slice(0, MAX_VOICES)
        vparams, vstate = ek.unpack_voices(self.vpar, self.vst, self.vsti,
                                           main)
        act = torch.from_numpy(mask).to(self.device)
        ek.write_voice_state(self.vst, self.vsti, voice.note_off(
            vparams, vstate, self.sample_rate, act), main)

    # ── MIDI ──

    def note_on(self, note, velocity):
        note = int(np.clip(int(note), tables.MIDI_LO, tables.MIDI_HI))
        velocity = float(velocity)
        slots = self._host_slots()
        slot_state = slots[:MAX_VOICES]
        # re-strike of a sustained note: damp the old vibration first
        restrike = (slot_state == SUSTAINED) & (self.midi_note == note)
        self._damp(restrike)
        self._set_slots(np.flatnonzero(restrike), RELEASING)
        slot_state = self._slots[:MAX_VOICES]

        # allocation: first FREE > oldest RELEASING > oldest SUSTAINED >
        # oldest HELD
        big = 1 << 40
        prio = np.where(
            slot_state == FREE, np.arange(MAX_VOICES),
            np.where(slot_state == RELEASING, big + self.age,
                     np.where(slot_state == SUSTAINED, 2 * big + self.age,
                              3 * big + self.age)))
        idx = int(np.argmin(prio))
        if slot_state[idx] != FREE:
            # steal: the voice moves to the steal bank under a 5 ms fade
            for t in (self.vpar, self.vst, self.vsti):
                t[:, MAX_VOICES + idx] = t[:, idx]
            self._set_slots(MAX_VOICES + idx, self.fade_samples)

        self.age_counter += 1
        seed = np.uint32((note * 2654435761 + self.age_counter)
                         & 0xFFFFFFFF)
        vparams, detuned = voice.note_on_params(
            np.array([float(note)]), np.array([velocity]), self.sample_rate,
            mlp_enabled=self.mlp_enabled)
        vstate = voice.init_state(vparams, detuned, np.array([velocity]),
                                  self.sample_rate, np.array([seed]))
        for t, col in zip((self.vpar, self.vst, self.vsti),
                          ek.pack_voice_columns(vparams, vstate)):
            t[:, idx] = torch.from_numpy(col[:, 0]).to(self.device)
        self._set_slots(idx, HELD)
        self.midi_note[idx] = note
        self.age[idx] = self.age_counter

    def note_off(self, note):
        note = int(np.clip(int(note), tables.MIDI_LO, tables.MIDI_HI))
        slot_state = self._host_slots()[:MAX_VOICES]
        held = (slot_state == HELD) & (self.midi_note == note)
        if not held.any():
            return
        idx = int(np.argmin(np.where(held, self.age, np.int64(1) << 62)))
        if self.sustain_held:
            self._set_slots(idx, SUSTAINED)
        else:
            mask = np.zeros(MAX_VOICES, bool)
            mask[idx] = True
            self._damp(mask)
            self._set_slots(idx, RELEASING)

    def set_sustain(self, held: bool):
        held = bool(held)
        if self.sustain_held and not held:
            mask = self._host_slots()[:MAX_VOICES] == SUSTAINED
            self._damp(mask)
            self._set_slots(np.flatnonzero(mask), RELEASING)
        self.sustain_held = held

    # ── parameters ──

    def _smooth_to(self, name, target):
        """The reference's smoother_set: a change of 1e-9 or more starts a
        5 ms ramp from the current value (on the device)."""
        target = float(target)
        if abs(target - self._targets[name]) < 1e-9:
            return
        self._targets[name] = target
        a, _ = ek.CHAIN_OFF["sm_" + name]
        cur = self.chain[a + ek.SM_CUR]
        self.chain[a + ek.SM_STEP] = (target - cur) / self.ramp_samples
        self.chain[a + ek.SM_TARGET] = target
        self.chain[a + ek.SM_REM] = float(self.ramp_samples)

    def set_volume(self, v):
        self._smooth_to("volume", v)

    def set_tremolo_depth(self, d):
        self._smooth_to("depth", d)

    def set_speaker_character(self, c):
        self._smooth_to("char", c)

    def set_mlp_enabled(self, on: bool):
        self.mlp_enabled = bool(on)

    def set_rail_sag(self, on: bool):
        self.rail_sag = bool(on)

    def set_noise_enabled(self, on: bool):
        """Authentic circuit noise: active on the melange preamp only (the
        DK preamp has no noise model, as in the reference)."""
        self.noise_enabled = bool(on)

    def set_noise_gain(self, gain: float):
        self.noise_gain = float(gain)

    # ── state ──

    def _flags(self):
        """The flags as one-element device tensors, (rail_sag, noise_scale),
        made anew only when a flag changed: a render does not wait for a
        host-to-device copy per chunk."""
        key = (bool(self.rail_sag), bool(self.noise_enabled),
               float(self.noise_gain))
        if key != self._flag_key:
            self._flag_key = key
            self._flag_t = (
                torch.tensor([key[0]], device=self.device),
                torch.tensor([(1.0 if key[1] else 0.0) * key[2]],
                             dtype=torch.float64, device=self.device))
        return self._flag_t

    def _state_views(self) -> EngineState:
        """This engine as a batch of one: views of its tensors (a render
        through them updates the engine) and its flags."""
        return EngineState(
            *[x.unsqueeze(0) for x in (self.vpar, self.vst, self.vsti,
                                       self.eng_i, self.chain)],
            *self._flags())

    @property
    def state(self) -> EngineState:
        """A copy of this engine's render state, a batch of one (the
        counterpart of the reference's `Engine.state`)."""
        return EngineState(*[x.clone() for x in self._state_views()])

    @state.setter
    def state(self, st: EngineState):
        """Take a one-engine EngineState: voices, gates, chain and flags
        (noise_scale s ≠ 0 becomes noise on at gain s; 0 turns the noise
        off and keeps the gain). The notes, ages and the sustain pedal stay
        the engine's."""
        if st.batch != 1:
            raise ValueError(f"Engine.state takes one engine, got "
                             f"{st.batch}")
        for name in ("vpar", "vst", "vsti", "eng_i", "chain"):
            getattr(self, name).copy_(getattr(st, name)[0])
        self.rail_sag = bool(st.rail_sag[0])
        scale = float(st.noise_scale[0])
        self.noise_enabled = scale != 0.0
        if self.noise_enabled:
            self.noise_gain = scale
        self._slots_stale = True

    # ── rendering ──

    def _render_chunk(self, n):
        _, out = render_states(self, self._state_views(), n)
        self._slots_stale = True
        return out[0]

    def render(self, num_samples: int) -> torch.Tensor:
        """num_samples mono float32 samples through the full chain, as a
        tensor on the engine's device."""
        chunks = []
        n = int(num_samples)
        for size in self.CHUNK_LADDER:
            while n >= size:
                chunks.append(self._render_chunk(size))
                n -= size
        if n:
            chunks.append(self._render_chunk(n))
        if not chunks:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        return torch.cat(chunks) if len(chunks) > 1 else chunks[0]

    def reset(self):
        """Back to the initial state with the smoothers at their targets
        and the MLP and rail-sag flags kept; then the warm-up."""
        self._init_state(self._targets)
        self.noise_enabled, self.noise_gain = False, 1.0
        self.warm_up()

    def warm_up(self):
        """Settle preamp, shadow pump and CdS (0.6 s of silence)."""
        self.render(int(self.sample_rate * WARM_UP_S))

    def set_sample_rate(self, sr: float):
        """Rebuild the chain at a new rate (models, targets and flags
        kept)."""
        keep = (self.mlp_enabled, self.rail_sag, self.noise_enabled,
                self.noise_gain)
        targets = dict(self._targets)
        sm = {k: self.chain[slice(*ek.CHAIN_OFF["sm_" + k])].clone()
              for k in targets}
        self.__init__(sr, device=self.device,
                      preamp_model=self.preamp_model, pa_model=self.pa_model)
        self.mlp_enabled, self.rail_sag, self.noise_enabled, \
            self.noise_gain = keep
        self._targets = targets
        for k in targets:
            self.chain[slice(*ek.CHAIN_OFF["sm_" + k])] = sm[k]
        self.warm_up()

    # ── inspection ──

    def active_voice_count(self):
        return int((self._host_slots()[:MAX_VOICES] != FREE).sum())

    def held_voice_count(self):
        return self.count_voices_in_state(HELD)

    def sustained_voice_count(self):
        return self.count_voices_in_state(SUSTAINED)

    def count_voices_in_state(self, s):
        return int((self._host_slots()[:MAX_VOICES] == s).sum())

    def count_voices_with_note_in_state(self, note, s):
        return int(((self._host_slots()[:MAX_VOICES] == s)
                    & (self.midi_note == note)).sum())

    def has_steal_voice_for(self, note):
        fades = self._host_slots()[MAX_VOICES:ek.SLOTS]
        return bool(((self.midi_note == note) & (fades > 0)).any())

    def is_sustain_held(self):
        return self.sustain_held

    def slot_state(self) -> np.ndarray:
        return self._host_slots()[:MAX_VOICES].copy()

    def nan_guard_fires(self):
        return int(self._host_slots()[ek.EI_FIRES])

    def _diag(self, name):
        a, b = ek.CHAIN_OFF[name]
        vals = self.chain[a:b].cpu().numpy()
        return {k: int(v) for k, v in zip(
            ("cooldown", "nr_fail", "nan_reset", "damp", "be_steps"), vals)}

    def power_amp_diag(self):
        """Solver robustness counters: all stay 0 on normal content."""
        return self._diag("pa_diag")

    def tremolo_diag(self):
        return self._diag("trem_diag")
