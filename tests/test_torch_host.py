"""The PyTorch port's host surface on the CPU: `host.WurliParams`,
`host.MidiEvent`, `host.FastWurliPlugin` and `stream_host` against the JAX
package's, with one stub engine on both sides.

The stub records every engine call and renders a ramp (sample k of the
stream is k), keeping the real engine's horizon rule: it renders whole
blocks and buffers the surplus. The two plugins get the same blocks and
events and must make exactly the same engine calls (exact: host arithmetic
in integers) and return the same audio.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from openwurli_tpu import fast_engine as jfast_engine
from openwurli_tpu import host as jhost
from openwurli_tpu import stream_host as jstream
from openwurli_tpu_torch import host, stream_host
from test_torch_song import SONG, write_midi

BLK = 64


class StubEngine:
    """The call surface of FastEngine; render(n) is the ramp pos..pos+n."""

    def __init__(self, sample_rate=44100.0, **kw):
        self.sample_rate = float(sample_rate)
        self.kw = kw
        self.block = BLK
        self._horizon = 0
        self._pos = 0
        self._sustain = False
        self.calls = []

    def _log(self, *call):
        self.calls.append(call)

    def note_on(self, note, velocity, offset=0):
        self._log("note_on", note, velocity, offset)

    def note_off(self, note, offset=0):
        self._log("note_off", note, offset)

    def set_sustain(self, held, offset=0):
        self._sustain = bool(held)
        self._log("set_sustain", bool(held), offset)

    def set_volume(self, v):
        self._log("set_volume", v)

    def set_tremolo_depth(self, d):
        self._log("set_tremolo_depth", d)

    def set_speaker_character(self, c):
        self._log("set_speaker_character", c)

    def set_noise_enabled(self, on):
        self._log("set_noise_enabled", on)

    def set_noise_gain(self, g):
        self._log("set_noise_gain", g)

    def is_sustain_held(self):
        return self._sustain

    def precompile(self):
        self._log("precompile")

    def reset(self):
        self._log("reset")
        self._horizon = self._pos = 0

    def render(self, n):
        self._log("render", int(n))
        while self._horizon < self._pos + n:
            self._horizon += self.block
        out = np.arange(self._pos, self._pos + n, dtype=np.float32)
        self._pos += n
        return out


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' FastEngine replaced by the stub."""
    monkeypatch.setattr(jfast_engine, "FastEngine", StubEngine)
    monkeypatch.setattr(host, "FastEngine", StubEngine)


def test_params_and_events_equal_the_reference():
    assert dataclasses.asdict(host.WurliParams()) == \
        dataclasses.asdict(jhost.WurliParams())
    assert [f.name for f in dataclasses.fields(host.MidiEvent)] == \
        [f.name for f in dataclasses.fields(jhost.MidiEvent)]
    ev, jev = host.MidiEvent(3, "cc"), jhost.MidiEvent(3, "cc")
    assert dataclasses.asdict(ev) == dataclasses.asdict(jev)
    assert host.FastWurliPlugin.CLAP_ID == jhost.FastWurliPlugin.CLAP_ID


def test_process_block_semantics(stubbed):
    plug = host.FastWurliPlugin(44100.0, lookahead=1, device="cpu")
    assert plug.engine.kw == {"lookahead": 1, "device": "cpu"}
    plug.params.volume = 0.6
    plug.params.authentic_noise = True
    plug.params.noise_level = 4.0
    out = plug.process(100, [
        host.MidiEvent(70, "note_on", 60, 0.9),
        host.MidiEvent(10, "cc", cc=64, value=127),
        host.MidiEvent(20, "note_on", 62, 0.0),      # velocity 0: note-off
        host.MidiEvent(90, "note_off", 60),
        host.MidiEvent(95, "cc", cc=1, value=5),     # not the pedal
        host.MidiEvent(99, "cc", cc=64, value=63)])
    assert out.shape == (100, 2) and out.dtype == np.float32
    np.testing.assert_array_equal(out[:, 0], out[:, 1])        # fan-out
    np.testing.assert_array_equal(out[:, 0], np.arange(100))
    calls = plug.engine.calls
    assert calls[:5] == [("set_volume", 0.6), ("set_tremolo_depth", 0.5),
                         ("set_speaker_character", 0.0),
                         ("set_noise_enabled", True),
                         ("set_noise_gain", 4.0)]
    assert "set_mlp_enabled" not in [c[0] for c in calls]
    # sorted by offset; events in engine block 0 carry their offsets, the
    # ones past sample 64 are dispatched after that block was rendered
    assert calls[5:] == [
        ("set_sustain", True, 10), ("note_off", 62, 20),
        ("render", 64), ("note_on", 60, 0.9, 6), ("note_off", 60, 26),
        ("set_sustain", False, 35), ("render", 36)]
    assert not plug.engine.is_sustain_held()
    assert plug.process(0).shape == (0, 2)
    plug.reset()
    assert plug._pos == 0 and plug.engine.calls[-1] == ("reset",)
    plug.set_sample_rate(48000.0)
    assert plug.engine.sample_rate == 48000.0 and plug.engine.calls == []


def test_process_chunking_equals_the_reference(stubbed):
    """Random blocks and events through both plugins: the same engine
    calls, the same audio."""
    a = host.FastWurliPlugin(44100.0)
    b = jhost.FastWurliPlugin(44100.0)
    rng = np.random.default_rng(11)
    for _ in range(60):
        n = int(rng.choice([1, 17, BLK - 1, BLK, BLK + 1, 100, 4 * BLK, 333]))
        evs = []
        for _e in range(int(rng.integers(0, 5))):
            off = int(rng.integers(-3, n + 3))
            kind = rng.choice(["note_on", "note_off", "cc"])
            evs.append(dict(
                sample_offset=off, kind=str(kind),
                note=int(rng.integers(40, 80)),
                velocity=float(rng.choice([0.0, 0.5, 1.0])),
                cc=int(rng.choice([64, 64, 1])),
                value=int(rng.integers(0, 128))))
        vol = float(rng.choice([0.5, 0.7]))
        a.params.volume = b.params.volume = vol
        out_a = a.process(n, [host.MidiEvent(**e) for e in evs])
        out_b = b.process(n, [jhost.MidiEvent(**e) for e in evs])
        np.testing.assert_array_equal(out_a, out_b)
        assert a.engine.calls == b.engine.calls
        assert (a._pos, a.engine._horizon) == (b._pos, b.engine._horizon)
    assert len(a.engine.calls) > 500


def _serve_lines():
    return [
        {"cmd": "init", "sample_rate": 48000, "block": 96},
        {"cmd": "param", "name": "volume", "value": 0.8},
        {"cmd": "param", "name": "authentic_noise", "value": True},
        {"cmd": "events", "events": [
            {"offset": 5, "kind": "note_on", "note": 60, "velocity": 0.8},
            {"offset": 80, "kind": "cc", "cc": 64, "value": 127},
            {"kind": "note_off", "note": 60}]},
        {"cmd": "render", "blocks": 3},
        {"cmd": "events", "events": [
            {"offset": 95, "kind": "cc", "cc": 64, "value": 0}]},
        {"cmd": "render"},
    ]


def test_stream_host_protocol_equals_the_reference(stubbed):
    a = stream_host.StreamHost(44100.0, block=128, engine="fast",
                               lookahead=2, device="cpu")
    b = jstream.StreamHost(44100.0, block=128, engine="fast", lookahead=2)
    assert a.plugin.engine.kw == {"lookahead": 2, "device": "cpu"}
    assert a.plugin.engine.calls == b.plugin.engine.calls == [("precompile",)]
    out_a, out_b = io.BytesIO(), io.BytesIO()
    for msg in _serve_lines():
        line = json.dumps(msg)
        assert a.handle(line, out_a) is True
        assert b.handle(line, out_b) is True
    assert a.block == b.block == 96
    assert a.plugin.engine.sample_rate == 48000.0
    assert a.plugin.engine.calls == b.plugin.engine.calls
    assert out_a.getvalue() == out_b.getvalue()
    pcm = np.frombuffer(out_a.getvalue(), np.float32).reshape(-1, 2)
    assert pcm.shape == (4 * 96, 2)
    np.testing.assert_array_equal(pcm[:, 0], pcm[:, 1])
    assert a.pending == []
    assert a.handle('{"cmd": "quit"}', out_a) is False


def test_stream_host_errors(stubbed):
    h = stream_host.StreamHost(44100.0, engine="fast", device="cpu")
    out = io.BytesIO()
    with pytest.raises(ValueError, match="unknown param"):
        h.handle('{"cmd": "param", "name": "reverb", "value": 1}', out)
    with pytest.raises(ValueError, match="unknown cmd"):
        h.handle('{"cmd": "dance"}', out)
    with pytest.raises(json.JSONDecodeError):
        h.handle("not json", out)
    # serve keeps going on a malformed command, as the reference does
    err = io.StringIO()
    h.serve(["not json\n", "\n", '{"cmd": "render"}\n', '{"cmd": "quit"}\n',
             '{"cmd": "render"}\n'], out, err=err)
    lines = err.getvalue().splitlines()
    assert lines[0].startswith("error:") and lines[1:] == ["ok"]
    assert len(out.getvalue()) == 4096 * 2 * 4


def test_f64_engine_is_not_ported_and_never_falls_back(stubbed):
    """The default engine is the f64 WurliPlugin over `engine.Engine`: on
    the card by default, which this CPU-only run lacks, so it raises and
    nothing falls back to the CPU or to the fast engine; on the CPU when
    asked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would work")
    with pytest.raises((RuntimeError, AssertionError)):
        stream_host.StreamHost()                    # the default engine
    h = stream_host.StreamHost(engine="f64", device="cpu")
    assert type(h.plugin) is host.WurliPlugin
    assert h.plugin.engine.device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        stream_host.play_midi("none.mid", io.BytesIO(), device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        stream_host.StreamHost(engine="turbo")


def test_blocks_from_midi_and_play_midi_equal_the_reference(stubbed,
                                                            tmp_path):
    path = str(tmp_path / "song.mid")
    write_midi(path, SONG, tempo_us=400000, tempo_tick=300)
    for block in (64, 1000):
        got = list(stream_host._blocks_from_midi(path, 44100.0, block, 0.25))
        ref = list(jstream._blocks_from_midi(path, 44100.0, block, 0.25))
        assert [n for n, _ in got] == [n for n, _ in ref]
        assert [[dataclasses.asdict(e) for e in evs] for _, evs in got] == \
            [[dataclasses.asdict(e) for e in evs] for _, evs in ref]
    assert sum(len(evs) for _, evs in got) == len(SONG) - 1   # no CC7

    out_a, out_b = io.BytesIO(), io.BytesIO()
    err = io.StringIO()
    rtf = stream_host.play_midi(path, out_a, block=256, tail_seconds=0.1,
                                err=err, engine="fast", device="cpu")
    jstream.play_midi(path, out_b, block=256, tail_seconds=0.1, err=err,
                      engine="fast")
    assert rtf > 0 and out_a.getvalue() == out_b.getvalue()
    assert len(out_a.getvalue()) > 0


def test_main_writes_a_wav(stubbed, tmp_path):
    from openwurli_tpu_torch.io import wav

    path = str(tmp_path / "song.mid")
    write_midi(path, SONG)
    out = str(tmp_path / "out.wav")
    stream_host.main(["--midi", path, "--engine", "fast", "--device", "cpu",
                      "--tail", "0.05", "--block", "512", "-o", out])
    x, sr = wav.read_wav_mono(out)
    assert sr == 44100 and x.size > 44100 and np.isfinite(x).all()
    with pytest.raises(SystemExit):
        stream_host.main([])
