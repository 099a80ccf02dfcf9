"""The host-facing parameter surface and block processor, the port of the
fast half of `openwurli_tpu/host.py`: the 6 host parameters, MIDI events
with in-block sample offsets, and `FastWurliPlugin`, a block-based
`process()` (parameter sync per block, event dispatch with offsets, CC64
sustain, mono → stereo fan-out) over `fast_engine.FastEngine`. Consumable
from any Python host: offline renderers, an audio bridge, test harnesses.

`WurliPlugin` is the same surface over the f64 `engine.Engine`, with
the reference's choice of preamp (the melange preamp carries the
"Authentic Noise" and "Noise Level" parameters).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from openwurli_tpu_torch.engine import Engine
from openwurli_tpu_torch.fast_engine import FastEngine


@dataclasses.dataclass
class WurliParams:
    """The 6 host parameters (defaults of the reference plugin)."""

    volume: float = 0.5              # linear post-amp gain
    tremolo_depth: float = 0.5       # vibrato pot position
    speaker_character: float = 0.0   # 0 = bypass, 1 = authentic cabinet
    mlp_corrections: bool = True     # per-note MLP corrections
    authentic_noise: bool = False    # circuit thermal noise
    noise_level: float = 1.0         # noise gain multiplier, up to 30x


@dataclasses.dataclass
class MidiEvent:
    """sample_offset is relative to the current block start."""

    sample_offset: int
    kind: str  # "note_on" | "note_off" | "cc"
    note: int = 0
    velocity: float = 0.0
    cc: int = 0
    value: int = 0


class WurliPlugin:
    """Block processor over the f64 engine, with the reference plugin's
    semantics: events split the block at their sample offsets."""

    CLAP_ID = "com.openwurli-tpu.wurlitzer-200a"

    def __init__(self, sample_rate: float = 44100.0,
                 preamp_model: str = "dk", device="cuda"):
        self.engine = Engine(sample_rate, device=device,
                             preamp_model=preamp_model)
        self.params = WurliParams()

    def set_sample_rate(self, sr: float):
        self.engine.set_sample_rate(sr)

    def reset(self):
        self.engine.reset()

    def _sync_params(self):
        e = self.engine
        e.set_volume(self.params.volume)
        e.set_tremolo_depth(self.params.tremolo_depth)
        e.set_speaker_character(self.params.speaker_character)
        e.set_mlp_enabled(self.params.mlp_corrections)
        e.set_noise_enabled(self.params.authentic_noise)
        e.set_noise_gain(self.params.noise_level)

    def _dispatch(self, ev: MidiEvent):
        if ev.kind == "note_on":
            if ev.velocity > 0:
                self.engine.note_on(ev.note, ev.velocity)
            else:
                self.engine.note_off(ev.note)
        elif ev.kind == "note_off":
            self.engine.note_off(ev.note)
        elif ev.kind == "cc" and ev.cc == 64:
            self.engine.set_sustain(ev.value >= 64)

    def process(self, num_samples: int,
                events: Sequence[MidiEvent] = ()) -> np.ndarray:
        """Render one block with sample-accurate event splitting →
        (num_samples, 2) float32."""
        self._sync_params()
        chunks = []
        cursor = 0
        for ev in sorted(events, key=lambda e: e.sample_offset):
            off = min(max(int(ev.sample_offset), cursor), num_samples)
            if off > cursor:
                chunks.append(self.engine.render(off - cursor))
                cursor = off
            self._dispatch(ev)
        if cursor < num_samples:
            chunks.append(self.engine.render(num_samples - cursor))
        mono = (torch.cat(chunks).cpu().numpy() if chunks
                else np.zeros(0, dtype=np.float32))
        return np.repeat(mono[:, None], 2, axis=1)


class FastWurliPlugin:
    """Plugin-surface adapter over the fused-kernel FastEngine.

    Trade-offs inherited from FastEngine: controls are static per block,
    and the first enable of authentic_noise switches later blocks to the
    noise kernel (noise_level changes are live). Event placement is
    sample-accurate up to the kernel's 16-sample jitter grid (events
    forward their block offsets into FastEngine) as long as process()
    block sizes keep the engine's internal blocks aligned: with an
    odd-sized surplus buffered, an event inside the already-rendered
    surplus slips to the next internal boundary.
    """

    CLAP_ID = "com.openwurli-tpu.wurlitzer-200a"

    def __init__(self, sample_rate: float = 44100.0, **engine_kw):
        self._engine_kw = dict(engine_kw)
        self.engine = FastEngine(sample_rate, **engine_kw)
        self.params = WurliParams()
        self._pos = 0  # stream samples handed out via process()

    def set_sample_rate(self, sr: float):
        self.engine = FastEngine(sr, **self._engine_kw)
        self._pos = 0

    def reset(self):
        self.engine.reset()
        self._pos = 0

    def precompile(self):
        self.engine.precompile()

    def _sync_params(self):
        e = self.engine
        e.set_volume(self.params.volume)
        e.set_tremolo_depth(self.params.tremolo_depth)
        e.set_speaker_character(self.params.speaker_character)
        e.set_noise_enabled(self.params.authentic_noise)
        e.set_noise_gain(self.params.noise_level)

    def _dispatch(self, ev: MidiEvent, offset: int = 0):
        if ev.kind == "note_on":
            if ev.velocity > 0:
                self.engine.note_on(ev.note, ev.velocity, offset=offset)
            else:
                self.engine.note_off(ev.note, offset=offset)
        elif ev.kind == "note_off":
            self.engine.note_off(ev.note, offset=offset)
        elif ev.kind == "cc" and ev.cc == 64:
            self.engine.set_sustain(ev.value >= 64, offset=offset)

    def process(self, num_samples: int,
                events: Sequence[MidiEvent] = ()) -> np.ndarray:
        """Render one block → (num_samples, 2) float32 (stereo fan-out).

        Each event is dispatched BEFORE the audio containing it renders,
        carrying its in-block sample offset into FastEngine: placement is
        exact up to the kernel's 16-sample jitter grid whenever the
        event's engine-internal block has not rendered yet (see the class
        docstring for the surplus caveat)."""
        self._sync_params()
        n = int(num_samples)
        pos = self._pos
        blk = self.engine.block
        chunks = []
        cursor = 0
        for ev in sorted(events, key=lambda e: e.sample_offset):
            off = min(max(int(ev.sample_offset), 0), max(n - 1, 0))
            q = pos + off  # absolute stream sample of the event
            # Emit audio up to the engine-block boundary containing the
            # event (never past the event itself) so the event's offset
            # addresses the engine's next un-rendered block.
            off_b = max(cursor, min(off, q // blk * blk - pos))
            if off_b > cursor:
                chunks.append(self.engine.render(off_b - cursor))
                cursor = off_b
            self._dispatch(ev, max(0, q - self.engine._horizon))
        if cursor < n:
            chunks.append(self.engine.render(n - cursor))
        self._pos = pos + n
        mono = (np.concatenate(chunks) if chunks
                else np.zeros(0, dtype=np.float32))
        return np.repeat(mono[:, None], 2, axis=1)
