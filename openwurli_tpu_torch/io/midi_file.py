"""Minimal Standard MIDI File reader for render_midi_file (a copy of
`openwurli_tpu/io/midi_file.py`; malformed files raise ValueError).

Parses note-on / note-off / CC64 (sustain) / tempo events from all tracks
and merges them into a single absolute-time event list.
"""

from __future__ import annotations

import dataclasses
import struct


@dataclasses.dataclass
class Event:
    time_s: float
    kind: str  # "on" | "off" | "sustain"
    note: int
    velocity: int


def _read_varlen(data, pos):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def load_events(path):
    """Returns (events sorted by time, total duration in seconds)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"{path}: not a MIDI file")
    _hlen, _fmt, ntracks, division = struct.unpack(">IHHH", data[4:14])
    if division & 0x8000:
        raise ValueError(f"{path}: SMPTE time division unsupported")

    pos = 14
    raw = []  # (tick, order, kind, note, vel) and tempo events
    tempo_map = [(0, 500000)]  # (tick, us/quarter)
    order = 0
    for _ in range(ntracks):
        if data[pos:pos + 4] != b"MTrk":
            raise ValueError(f"{path}: track chunk expected at byte {pos}")
        tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        tpos = pos + 8
        tend = tpos + tlen
        tick = 0
        status = 0
        while tpos < tend:
            delta, tpos = _read_varlen(data, tpos)
            tick += delta
            b = data[tpos]
            if b & 0x80:
                status = b
                tpos += 1
            ev = status & 0xF0
            if ev == 0x90:
                note, vel = data[tpos], data[tpos + 1]
                tpos += 2
                raw.append((tick, order, "on" if vel > 0 else "off",
                            note, vel))
            elif ev == 0x80:
                note, vel = data[tpos], data[tpos + 1]
                tpos += 2
                raw.append((tick, order, "off", note, vel))
            elif ev == 0xB0:
                cc, val = data[tpos], data[tpos + 1]
                tpos += 2
                if cc == 64:
                    raw.append((tick, order, "sustain", 0, val))
            elif ev in (0xA0, 0xE0):
                tpos += 2
            elif ev in (0xC0, 0xD0):
                tpos += 1
            elif status == 0xFF:
                mtype = data[tpos]
                tpos += 1
                mlen, tpos = _read_varlen(data, tpos)
                if mtype == 0x51:
                    tempo = int.from_bytes(data[tpos:tpos + 3], "big")
                    tempo_map.append((tick, tempo))
                tpos += mlen
            elif status in (0xF0, 0xF7):
                mlen, tpos = _read_varlen(data, tpos)
                tpos += mlen
            else:
                tpos += 1
            order += 1
        pos = tend

    tempo_map.sort()

    def tick_to_s(tick):
        s = 0.0
        prev_tick, prev_tempo = tempo_map[0]
        for t, tempo in tempo_map[1:]:
            if t >= tick:
                break
            s += (t - prev_tick) * prev_tempo / 1e6 / division
            prev_tick, prev_tempo = t, tempo
        s += (tick - prev_tick) * prev_tempo / 1e6 / division
        return s

    raw.sort(key=lambda e: (e[0], e[1]))
    events = [Event(tick_to_s(t), kind, note, vel)
              for t, _o, kind, note, vel in raw]
    total = events[-1].time_s if events else 0.0
    return events, total
