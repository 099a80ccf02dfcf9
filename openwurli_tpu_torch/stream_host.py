"""Block-streaming host, the port of `openwurli_tpu/stream_host.py`: a
pipe protocol over `host.WurliPlugin` (the f64 engine, the default) or
`host.FastWurliPlugin` (`engine="fast"`).

  * **serve mode** (`--serve`): newline-delimited JSON commands on stdin,
    raw interleaved stereo float32 PCM on stdout (pipe into `aplay -f
    FLOAT_LE -c 2`, sox, ffplay, …), acks/errors on stderr. Commands:
      {"cmd": "init", "sample_rate": 44100, "block": 4096}
      {"cmd": "param", "name": "volume", "value": 0.6}
      {"cmd": "events", "events": [{"offset": 0, "kind": "note_on",
                                    "note": 60, "velocity": 0.8}, …]}
      {"cmd": "render", "blocks": 8}
      {"cmd": "quit"}
  * **MIDI pipe mode** (`--midi f.mid`): schedules the file's events
    (note on/off, CC64 sustain) with sample accuracy and streams the
    rendered audio; `--realtime` paces output to wall-clock (drops to
    as-fast-as-possible when the engine is slower than realtime, and
    reports the achieved realtime factor on stderr either way).

    python -m openwurli_tpu_torch.stream_host --engine fast --midi f.mid -o out.wav

The engine runs on `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from openwurli_tpu_torch.host import FastWurliPlugin, MidiEvent, WurliPlugin


def _make_plugin(sample_rate, engine, lookahead=0, device="cuda"):
    if engine == "fast":
        p = FastWurliPlugin(sample_rate, lookahead=lookahead, device=device)
        p.precompile()
        return p
    if engine == "f64":
        return WurliPlugin(sample_rate, device=device)
    raise ValueError(f"unknown engine {engine!r}")


class StreamHost:
    """NDJSON-control / raw-PCM-data streaming server."""

    def __init__(self, sample_rate=44100.0, block=4096, engine="f64",
                 lookahead=0, device="cuda"):
        self.plugin = _make_plugin(sample_rate, engine, lookahead, device)
        self.block = int(block)
        self.pending = []

    def handle(self, line, out):
        """Process one NDJSON command; write PCM to `out`. Returns False
        on quit."""
        msg = json.loads(line)
        cmd = msg.get("cmd")
        if cmd == "init":
            sr = float(msg.get("sample_rate", 44100.0))
            self.plugin.set_sample_rate(sr)
            self.block = int(msg.get("block", self.block))
        elif cmd == "param":
            name = msg["name"]
            if not hasattr(self.plugin.params, name):
                raise ValueError(f"unknown param {name!r}")
            setattr(self.plugin.params, name, msg["value"])
        elif cmd == "events":
            for e in msg.get("events", []):
                self.pending.append(MidiEvent(
                    sample_offset=int(e.get("offset", 0)),
                    kind=e["kind"], note=int(e.get("note", 0)),
                    velocity=float(e.get("velocity", 0.0)),
                    cc=int(e.get("cc", 0)), value=int(e.get("value", 0))))
        elif cmd == "render":
            for _ in range(int(msg.get("blocks", 1))):
                audio = self.plugin.process(self.block, self.pending)
                self.pending = []
                out.write(np.ascontiguousarray(
                    audio, dtype=np.float32).tobytes())
            out.flush()
        elif cmd == "quit":
            return False
        else:
            raise ValueError(f"unknown cmd {cmd!r}")
        return True

    def serve(self, stdin, out, err=sys.stderr):
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                if not self.handle(line, out):
                    break
                print("ok", file=err, flush=True)
            except Exception as e:  # keep serving on malformed input
                print(f"error: {e}", file=err, flush=True)


def _blocks_from_midi(path, sample_rate, block, tail_seconds):
    """Yield (n_samples, [MidiEvent...]) per block for a MIDI file."""
    from openwurli_tpu_torch.io import midi_file

    events, total_s = midi_file.load_events(path)
    total = int((total_s + tail_seconds) * sample_rate)
    idx = 0
    evs = [(int(e.time_s * sample_rate), e) for e in events]
    for start in range(0, total, block):
        n = min(block, total - start)
        blk = []
        while idx < len(evs) and evs[idx][0] < start + n:
            s, e = evs[idx]
            kind = {"on": "note_on", "off": "note_off",
                    "sustain": "cc"}[e.kind]
            blk.append(MidiEvent(
                sample_offset=max(s - start, 0), kind=kind, note=e.note,
                velocity=e.velocity / 127.0, cc=64,
                value=e.velocity if e.kind == "sustain" else 0))
            idx += 1
        yield n, blk


def play_midi(path, out, sample_rate=44100.0, block=4096,
              realtime=False, tail_seconds=2.0, err=sys.stderr,
              engine="f64", device="cuda"):
    """Stream a MIDI file as raw stereo f32 PCM; returns achieved RTF."""
    plugin = _make_plugin(sample_rate, engine, device=device)
    rendered = 0
    t0 = time.time()
    for n, evs in _blocks_from_midi(path, sample_rate, block,
                                    tail_seconds):
        audio = plugin.process(n, evs)
        out.write(np.ascontiguousarray(audio, dtype=np.float32).tobytes())
        out.flush()
        rendered += n
        if realtime:
            ahead = rendered / sample_rate - (time.time() - t0)
            if ahead > block / sample_rate:
                time.sleep(ahead - block / sample_rate)
    wall = max(time.time() - t0, 1e-9)
    rtf = rendered / sample_rate / wall
    print(f"streamed {rendered / sample_rate:.1f}s in {wall:.1f}s "
          f"({rtf:.2f}x realtime)", file=err, flush=True)
    return rtf


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--serve", action="store_true",
                   help="NDJSON control on stdin, PCM on stdout")
    p.add_argument("--midi", help="stream a MIDI file as PCM")
    p.add_argument("--sr", type=float, default=44100.0)
    p.add_argument("--block", type=int, default=4096)
    p.add_argument("--realtime", action="store_true",
                   help="pace MIDI streaming to wall clock")
    p.add_argument("--engine", choices=("f64", "fast"), default="f64",
                   help="f64 engine (E1/E2 kernels) or the fused-kernel "
                        "FastEngine")
    p.add_argument("--lookahead", type=int, default=1,
                   help="fast engine only: blocks queued ahead of the copy "
                        "being waited on (events land lookahead blocks "
                        "later)")
    p.add_argument("--tail", type=float, default=2.0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default: the card)")
    p.add_argument("-o", "--output", default="-",
                   help="'-' = stdout (raw PCM), else .wav path")
    args = p.parse_args(argv)

    if args.output == "-":
        out = sys.stdout.buffer
        close = None
    else:
        import io

        out = io.BytesIO()
        close = args.output

    if args.serve:
        StreamHost(args.sr, args.block, args.engine,
                   args.lookahead if args.engine == "fast" else 0,
                   device=args.device).serve(sys.stdin, out)
    elif args.midi:
        play_midi(args.midi, out, args.sr, args.block, args.realtime,
                  args.tail, engine=args.engine, device=args.device)
    else:
        p.error("need --serve or --midi")

    if close:
        from openwurli_tpu_torch.io import wav

        pcm = np.frombuffer(out.getvalue(), dtype=np.float32)
        wav.write_wav(close, pcm.reshape(-1, 2)[:, 0].astype(np.float64),
                      args.sr, bits=24)
        print(f"wrote {close}", file=sys.stderr)


if __name__ == "__main__":
    main()
