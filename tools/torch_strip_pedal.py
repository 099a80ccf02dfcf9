#!/usr/bin/env python3
"""Strip CC64 (sustain) from a MIDI file, extending note durations instead.

The PyTorch port's copy of tools/strip_pedal.py, on the port's own MIDI
reader (`openwurli_tpu_torch.io.midi_file`): every note held by the pedal
gets its note-off moved to the moment the pedal releases (or the next
re-strike), then all CC64 events are dropped. The file it writes is a
format-0 SMF at 480 ticks per quarter, 120 bpm. It does no tensor work.

    python tools/torch_strip_pedal.py in.mid out.mid
"""

import argparse
import os
import struct
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from openwurli_tpu_torch.io import midi_file  # noqa: E402


def strip(events, total):
    """Events with the pedal simulated: the note-offs of pedal-held notes
    moved to the pedal's release or the next re-strike, CC64 dropped."""
    out = []
    sustain = False
    deferred = {}  # note -> original off velocity
    for ev in events:
        if ev.kind == "sustain":
            new_state = ev.velocity >= 64
            if sustain and not new_state:
                t = ev.time_s
                for note, vel in deferred.items():
                    out.append(midi_file.Event(t, "off", note, vel))
                deferred.clear()
            sustain = new_state
        elif ev.kind == "off" and sustain:
            deferred[ev.note] = ev.velocity
        elif ev.kind == "on":
            if ev.note in deferred:
                out.append(midi_file.Event(ev.time_s, "off", ev.note,
                                           deferred.pop(ev.note)))
            out.append(ev)
        else:
            out.append(ev)
    for note, vel in deferred.items():
        out.append(midi_file.Event(total, "off", note, vel))
    out.sort(key=lambda e: e.time_s)
    return out


def write_smf(path, events, tpq=480, uspq=500000):
    """A single-track format-0 SMF of note-ons and note-offs."""
    track = bytearray()
    last_tick = 0
    for ev in events:
        tick = int(ev.time_s * 1e6 / uspq * tpq)
        delta = max(tick - last_tick, 0)
        last_tick = tick
        var = [delta & 0x7F]
        delta >>= 7
        while delta:
            var.append((delta & 0x7F) | 0x80)
            delta >>= 7
        track.extend(reversed(var))
        status = 0x90 if ev.kind == "on" else 0x80
        track.extend([status, ev.note & 0x7F, ev.velocity & 0x7F])
    track.extend([0x00, 0xFF, 0x2F, 0x00])
    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, tpq))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("input")
    p.add_argument("output")
    args = p.parse_args(argv)

    events, total = midi_file.load_events(args.input)
    out = strip(events, total)
    write_smf(args.output, out)
    print(f"{args.input}: {len(events)} events → {args.output}: "
          f"{len(out)} (pedal stripped)")


if __name__ == "__main__":
    main()
