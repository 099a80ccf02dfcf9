"""FastEngine: the interactive engine on the fused kernels, the port of
`openwurli_tpu/fast_engine.py`.

It is the online (incremental) form of `fast.render_events`: the same
voice-bank kernel with events (K3) and the same mono chain (K2, or K5 when
thermal noise is compiled in), driven by a live note_on / note_off /
set_sustain API with the state carried from block to block. A block is
one K3 launch over the fixed 128-lane bank, the lane sum, and one chain
launch at one stream. `steady` and `min_release` are pinned (None and 0.0),
so no schedule fact is read back from the device inside a block.

Semantics (those of the reference engine):
  * events land at `offset` samples into the NEXT un-rendered block
    (default 0, the block's start), then quantize to the kernel's 16-sample
    jitter grid. A host that knows its events' sample positions within the
    upcoming block passes them as offsets; callers that omit the offset get
    block-boundary placement;
  * controls (volume, tremolo depth, speaker character, noise gain) are
    static per block;
  * voices are appended per note instance over a 128-lane bank, and when
    the bank is full the lane whose voice ended longest ago is reused;
  * `lookahead=k` queues k extra blocks before the oldest one is copied to
    the host (launches are asynchronous, so the card renders block N+1
    while block N is copied). Events that arrive after a block went in flight
    land k blocks later.

A session produces bit for bit the audio of a block loop over
`vb.render_voice_bank` and `mc.render` with the same two pins and the same
schedule: pre-onset lanes are frozen at their note-on state in the kernel,
so re-initialising a lane at its (later) note-on equals having scheduled it
from t=0. Against `fast.render_events`, which passes the schedule's own
`min_release` and `steady_limits`, it agrees at a level only (the kernel's
two stages round differently).

All device work happens in `render`, `warm_up` and `precompile`; the MIDI
and control calls are host bookkeeping. The engine runs on `device`: the
CUDA kernels on a CUDA device, their plain versions on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from openwurli_tpu_torch.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import voice_bank as vb

LANES = 128
BLOCK = 1024          # internal render block (a multiple of 16)
WARM_UP_S = 0.6


class FastEngine:
    """Interactive fused-kernel engine."""

    def __init__(self, sample_rate: float = 44100.0, volume: float = 0.5,
                 tremolo_depth: float = 0.5, speaker_character: float = 0.0,
                 t_tile: int | None = None, lookahead: int = 0,
                 noise: bool = False, noise_level: float = 1.0,
                 device="cuda"):
        self.sample_rate = float(sample_rate)
        self.device = torch.device(device)
        # Thermal noise: `noise` selects the chain kernel (K5 instead of
        # K2); noise_level is a live runtime gain (set_noise_gain).
        self._noise = bool(noise)
        self._noise_on = bool(noise)
        self._noise_level = float(noise_level)
        self.lookahead = int(lookahead)
        self.t_tile = int(t_tile or mc.T_TILE)
        if BLOCK % self.t_tile and self.t_tile % BLOCK:
            raise ValueError(f"t_tile={self.t_tile} neither divides nor is a "
                             f"multiple of the block ({BLOCK})")
        self.block = max(BLOCK, self.t_tile)
        if self.block % vb.JITTER_SUBSAMPLE:
            raise ValueError(f"block={self.block} must be a multiple of "
                             f"{vb.JITTER_SUBSAMPLE}")
        self._volume = float(volume)
        self._depth = float(tremolo_depth)
        self._char = float(speaker_character)
        self._ctrl_dirty = True
        self._ctrl = None

        # host-side schedule (one instance per note-on, lanes reused), in
        # fixed-length arrays with a used-lane count
        self._midis = np.full(LANES, 60.0)
        self._vels = np.zeros(LANES)
        self._onsets = np.zeros(LANES)
        self._releases = np.full(LANES, np.inf)
        self._n_used = 0
        self._ringing: dict[int, int] = {}   # note → lane
        self._pending: set[int] = set()      # lanes held by the pedal
        self._sustain = False
        self._params_dirty = True
        self._params = None                  # packed params on the device
        self._new_lanes: list[int] = []      # lanes needing state re-init

        self._horizon = 0                    # samples rendered internally
        self._surplus = np.zeros(0, dtype=np.float32)
        self._inflight: list = []            # queued, not yet on the host

        self._chain_state = mc.init_state(self.sample_rate, 1,
                                          device=self.device)
        self._vstate = None

    # ── MIDI / parameter surface ─────────────────────────────────────

    def note_on(self, note: int, velocity: float, offset: int = 0):
        """velocity in [0, 1] (hosts pass midi_vel/127). offset: samples
        into the next un-rendered block."""
        t = float(self._horizon + self._clip_offset(offset))
        old = self._ringing.get(int(note))
        if old is not None and not np.isfinite(self._releases[old]):
            self._releases[old] = t          # damp the re-struck voice
            self._pending.discard(old)
        lane = self._alloc_lane()
        self._midis[lane] = float(note)
        self._vels[lane] = float(velocity)
        self._onsets[lane] = t
        self._releases[lane] = np.inf
        self._ringing[int(note)] = lane
        self._new_lanes.append(lane)
        self._params_dirty = True

    def note_off(self, note: int, offset: int = 0):
        lane = self._ringing.get(int(note))
        if lane is None or np.isfinite(self._releases[lane]):
            return
        if self._sustain:
            self._pending.add(lane)
        else:
            self._releases[lane] = float(self._horizon
                                         + self._clip_offset(offset))
            self._params_dirty = True

    def set_sustain(self, held: bool, offset: int = 0):
        held = bool(held)
        if self._sustain and not held:
            t = float(self._horizon + self._clip_offset(offset))
            for lane in self._pending:
                self._releases[lane] = t
            self._pending.clear()
            self._params_dirty = True
        self._sustain = held

    def _clip_offset(self, offset) -> int:
        # Offsets address the next un-rendered block only: the block
        # renders as soon as render() needs it, so anything farther out
        # would need the host to re-send it (and a negative offset would
        # rewrite already-rendered audio).
        return max(0, min(int(offset), self.block - 1))

    # Setters mark the controls dirty only on CHANGE: hosts re-sync every
    # block (host.FastWurliPlugin._sync_params), and an unconditional mark
    # would rebuild and re-upload the control rows per block.

    def set_volume(self, v: float):
        if float(v) != self._volume:
            self._volume = float(v)
            self._ctrl_dirty = True

    def set_tremolo_depth(self, d: float):
        if float(d) != self._depth:
            self._depth = float(d)
            self._ctrl_dirty = True

    def set_speaker_character(self, c: float):
        if float(c) != self._char:
            self._char = float(c)
            self._ctrl_dirty = True

    def set_noise_gain(self, g: float):
        """Runtime thermal-noise gain (silent unless the engine was built,
        or later enabled, with noise=True)."""
        if float(g) != self._noise_level:
            self._noise_level = float(g)
            self._ctrl_dirty = True

    def set_noise_enabled(self, enabled: bool):
        """Enable or disable thermal noise. Enabling on an engine built
        with noise=False switches later blocks to the noise kernel;
        disabling only zeroes the runtime gain."""
        enabled = bool(enabled)
        if enabled and not self._noise:
            self._noise = True
            # Blocks in flight were queued under the old kernel but their
            # horizon and state already advanced: materialize them into
            # the surplus (dropping them would skip real audio).
            if self._inflight:
                self._surplus = np.concatenate(
                    [self._surplus]
                    + [b.cpu().numpy() for b in self._inflight])
                self._inflight = []
        if enabled != self._noise_on:
            self._noise_on = enabled
            self._ctrl_dirty = True

    def active_voice_count(self):
        if self._n_used == 0:
            return 0
        rel = self._releases[:self._n_used]
        ring = ~np.isfinite(rel)
        # released voices count until their damper tail has rendered
        tail = np.isfinite(rel) & (rel + 2.0 * self.sample_rate
                                   > self._horizon)
        return int((ring | tail).sum())

    def is_sustain_held(self):
        return self._sustain

    # ── rendering ─────────────────────────────────────────────────────

    def warm_up(self):
        """Settle the chain on WARM_UP_S of silence (rounded up to whole
        tiles)."""
        t_warm = -(-int(WARM_UP_S * self.sample_rate)
                   // self.t_tile) * self.t_tile
        silence = torch.zeros((t_warm, 1), dtype=torch.float32,
                              device=self.device)
        _, self._chain_state = mc.render(
            self.sample_rate, self._controls(), self._chain_state, silence,
            noise=self._noise)

    def precompile(self):
        """Everything a first note would otherwise wait for: build and load
        the kernel library (on a CUDA device), run one throwaway block on
        its own params and states, then settle the chain."""
        if self.device.type == "cuda":
            from openwurli_tpu_torch import _build

            _build.library()
        params, _ = vb.make_kernel_params(
            self._midis, self._vels, self.sample_rate, onsets=self._onsets,
            releases=self._releases, lanes=LANES, n_active=0,
            device=self.device)
        self._block(params, vb.init_bank_state(params),
                    mc.init_state(self.sample_rate, 1, device=self.device), 0)
        self.warm_up()
        if self.device.type == "cuda":
            # launches are asynchronous: wait, so that the first note does
            # not pay for the warm-up
            torch.cuda.synchronize(self.device)

    def render(self, num_samples: int) -> np.ndarray:
        """Render the next num_samples mono float32 samples."""
        out = []
        n = int(num_samples)
        while n > 0:
            if self._surplus.size:
                take = min(n, self._surplus.size)
                out.append(self._surplus[:take])
                self._surplus = self._surplus[take:]
                n -= take
                continue
            # Keep `lookahead` extra blocks queued BEFORE waiting for the
            # oldest one's copy to the host.
            while len(self._inflight) < 1 + self.lookahead:
                self._inflight.append(self._dispatch_block())
            self._surplus = self._inflight.pop(0).cpu().numpy()
        return (np.concatenate(out) if out
                else np.zeros(0, dtype=np.float32))

    def reset(self):
        self._midis = np.full(LANES, 60.0)
        self._vels = np.zeros(LANES)
        self._onsets = np.zeros(LANES)
        self._releases = np.full(LANES, np.inf)
        self._n_used = 0
        self._ringing.clear()
        self._pending.clear()
        self._params = None
        self._params_dirty = True
        self._new_lanes = []
        self._vstate = None
        self._horizon = 0
        self._surplus = np.zeros(0, dtype=np.float32)
        self._inflight = []
        self._chain_state = mc.init_state(self.sample_rate, 1,
                                          device=self.device)
        self.warm_up()

    # ── internals ─────────────────────────────────────────────────────
    # Events land at the first un-rendered sample (self._horizon): surplus
    # audio already handed to render() was rendered before the event
    # arrived, so the event quantizes to the next block boundary.

    def _alloc_lane(self) -> int:
        if self._n_used < LANES:
            self._n_used += 1
            return self._n_used - 1
        # lane reuse: retire the lane whose voice ended longest ago
        # (release + damper tail, or natural silence for old onsets)
        rel = np.where(np.isfinite(self._releases), self._releases,
                       self._onsets + 30.0 * self.sample_rate)
        lane = int(np.argmin(rel))
        note = int(self._midis[lane])
        if self._ringing.get(note) == lane:
            del self._ringing[note]
        self._pending.discard(lane)
        return lane

    def _controls(self):
        if self._ctrl_dirty or self._ctrl is None:
            self._ctrl = mc.make_controls(
                self.sample_rate, 1, volume=self._volume, depth=self._depth,
                character=self._char,
                noise_level=(self._noise_level if self._noise_on else 0.0),
                device=self.device)
            self._ctrl_dirty = False
        return self._ctrl

    def _repack(self):
        params, _ = vb.make_kernel_params(
            self._midis, self._vels, self.sample_rate, onsets=self._onsets,
            releases=self._releases, lanes=LANES, n_active=self._n_used,
            device=self.device)
        fresh = vb.init_bank_state(params)
        if self._vstate is None:
            vstate = fresh
        elif not self._new_lanes:
            vstate = self._vstate
        else:
            # A lane re-initialised at its (future) onset is bit-identical
            # to one scheduled from t=0: the kernel freezes pre-onset lanes
            # at note-on state. The columns are copied on the device into a
            # new tensor, so a queued launch that still reads the old state
            # is not disturbed and nothing waits for the card.
            idx = torch.tensor(sorted(set(self._new_lanes)),
                               dtype=torch.long, device=self.device)
            vstate = self._vstate.index_copy(1, idx,
                                             fresh.index_select(1, idx))
        self._new_lanes = []
        self._params = params
        self._vstate = vstate
        self._params_dirty = False

    def _block(self, params, vstate, chain_state, n0):
        """One block from explicit states → (out (block,), vstate',
        chain_state'): K3 over the bank, the lane sum, the chain at one
        stream. steady=None and min_release=0.0 are the same for every
        block of every session, whatever its note events."""
        voices, vstate = vb.render_voice_bank(
            params, self.block, steady=None, state=vstate, n0=n0,
            return_state=True, events=True, min_release=0.0)
        audio = voices.sum(-1, keepdim=True)
        out, chain_state = mc.render(self.sample_rate, self._controls(),
                                     chain_state, audio, noise=self._noise)
        return out[:, 0], vstate, chain_state

    def _dispatch_block(self):
        """Queue one block; returns the output tensor on the device (the
        host does not wait here). Silent sessions run the same kernels on
        the all-silent param pack (zero-amplitude voices emit exact 0.0)."""
        if self._params_dirty or self._params is None:
            self._repack()
        out, self._vstate, self._chain_state = self._block(
            self._params, self._vstate, self._chain_state, self._horizon)
        self._horizon += self.block
        return out
