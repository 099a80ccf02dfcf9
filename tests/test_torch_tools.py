"""The PyTorch port's tools (`tools/torch_*.py`) against the JAX package's
(`tools/*.py`), on the CPU at tiny sizes.

  * `torch_strip_pedal`: the file it writes, byte-identical to the
    reference tool's, on a synthetic SMF with pedal holds, a release under
    the pedal, a re-strike and a note held past the pedal's last release.
  * `torch_analyze_pump_dynamics` (the port CLI's `_pump_trace`, E7's
    plain version) at a 2 kHz rate and 3 points: the same printed lines,
    the fit's line (whose numbers hold the pump at 1 MΩ, ~1e-13 V of
    solver noise) within 1e-12 of the pump's range.
  * `torch_h3_analysis`: the model sweep's H3/H1 (E4's plain version and
    `calib.harmonics`) at 0.25 s, within 1e-6 dB.
  * `torch_wurli_compare` (`calib.notes`, `calib.harmonics`, `di.render_di`)
    and `torch_recording_analyzer` (`calib.notes`, `calib.harmonics`,
    `io.wav`) on a two-note recording the reference's voice renders: the
    same notes and tiers, the same extracted WAV files, and every number
    of their JSON reports within 1e-6 relative (the model side's DI render
    within the -120 dB of tests/test_torch_di.py moves a feature in dB by
    far less).
  * `torch_gen_settled_states` with SETTLE_SECONDS cut to 0.02 s at an
    uncached rate (64 kHz): the npz it writes against the reference's
    settle there, within 1e-9 of the node swing (tests/test_torch_settle.py).
  * `torch_perf_sweep` (`engine.render_states`, the plain E1 and E2) at
    widths 1 and 2 × 88 samples: the reference tool's CSV header and one
    row per width, the aggregate realtime factor the per-stream one times
    the width within the print's rounding.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import voice as jvoice
from openwurli_tpu.circuits import tremolo as jtrem
from openwurli_tpu.io import wav as jwav
from openwurli_tpu_torch.circuits import tremolo

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv, monkeypatch=None, name="tool"):
    """stdout of main(argv), or of main() with sys.argv set."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", [name, *argv])
            main()
    return buf.getvalue()


def _smf(path, events, tpq=480):
    """A format-0 SMF from (tick, status, data1, data2) events."""
    track, last = bytearray(), 0
    for tick, status, d1, d2 in events:
        delta, last = tick - last, tick
        var = [delta & 0x7F]
        delta >>= 7
        while delta:
            var.append((delta & 0x7F) | 0x80)
            delta >>= 7
        track += bytes(reversed(var)) + bytes([status, d1, d2])
    track += bytes([0x00, 0xFF, 0x2F, 0x00])
    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, tpq))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + bytes(track))


def test_strip_pedal_file_byte_identical(tmp_path, monkeypatch):
    src = str(tmp_path / "in.mid")
    _smf(src, [
        (0, 0x90, 60, 100), (120, 0xB0, 64, 127), (240, 0x80, 60, 40),
        (300, 0x90, 62, 90), (360, 0x80, 62, 0), (420, 0x90, 62, 70),
        (600, 0xB0, 64, 0), (700, 0x80, 62, 30), (800, 0xB0, 64, 100),
        (900, 0x90, 67, 80), (960, 0x80, 67, 20), (2000, 0x90, 72, 1),
        (2400, 0x80, 72, 0)])
    port_out, ref_out = str(tmp_path / "port.mid"), str(tmp_path / "ref.mid")
    port = _run(_tool("torch_strip_pedal").main, [src, port_out])
    ref = _run(_tool("strip_pedal").main, [src, ref_out], monkeypatch)
    with open(port_out, "rb") as a, open(ref_out, "rb") as b:
        port_bytes, ref_bytes = a.read(), b.read()
    assert port_bytes == ref_bytes and len(port_bytes) > 60
    assert port.replace(port_out, "X") == ref.replace(ref_out, "X")
    from openwurli_tpu_torch.io import midi_file

    events, _ = midi_file.load_events(port_out)
    assert not [e for e in events if e.kind == "sustain"]
    assert sum(e.kind == "on" for e in events) == \
        sum(e.kind == "off" for e in events) == 5


def test_analyze_pump_dynamics_prints_match_reference(monkeypatch):
    argv = ["--sr", "2000", "--points", "3"]
    port = _run(_tool("torch_analyze_pump_dynamics").main,
                [*argv, "--device", "cpu"])
    ref = _run(_tool("analyze_pump_dynamics").main, argv, monkeypatch)
    print(port)
    port, ref = port.splitlines(), ref.splitlines()
    assert len(port) == len(ref) == 6  # header, 3 rows, fit, settle tau
    fit = [k for k, line in enumerate(ref) if line.startswith("# cubic")]
    assert fit == [4]
    assert port[:4] + port[5:] == ref[:4] + ref[5:]
    # the fit's numbers: the pump at 1 MΩ is at the solver's noise floor
    # (~1e-13 V), so they are held to the pump target, 1e-12 of its range
    nums = [[float(w) for w in line.replace("..", " ").split()
             if w[0].isdigit()] for line in (port[4], ref[4])]
    top = max(nums[1])
    assert all(abs(a - b) <= 1e-12 * top for a, b in zip(*nums)), nums


def test_h3_model_sweep_matches_reference():
    notes = [60, 76]
    port = _tool("torch_h3_analysis").model_sweep(notes, seconds=0.25,
                                                  device="cpu")
    ref = _tool("h3_analysis").model_sweep(notes, seconds=0.25)
    assert [m for m, _ in port] == [m for m, _ in ref] == notes
    for (_, a), (_, b) in zip(port, ref):
        print(f"H3/H1 {a:.6f} vs {b:.6f} dB")
        assert abs(a - b) <= 1e-6


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    """Two isolated notes (MIDI 60 and 67, 0.8 s each) rendered by the
    reference's voice, peak-normalized, between silences, 24-bit."""
    sr = 44100.0
    out = np.asarray(jvoice.render_note(jnp.array([60.0, 67.0]),
                                        jnp.array([0.8, 0.7]), 0.8, sr))
    chunks = [np.zeros(int(0.3 * sr))]
    for k in range(2):
        a = out[:, k]
        chunks += [a / np.abs(a).max() * 0.5, np.zeros(int(0.4 * sr))]
    path = str(tmp_path_factory.mktemp("rec") / "rec.wav")
    jwav.write_wav(path, np.concatenate(chunks), sr, bits=24)
    return path


def _assert_close(a, b, path="", rtol=1e-6):
    """JSON-like trees equal in structure, strings and ints; floats within
    rtol (NaN equal to NaN)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_close(a[k], b[k], f"{path}/{k}", rtol)
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_close(x, y, f"{path}/{k}", rtol)
    elif isinstance(b, float):
        if math.isnan(b):
            assert math.isnan(a), path
        else:
            assert abs(a - b) <= rtol * max(abs(b), 1e-300), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_wurli_compare_matches_reference(recording, tmp_path, monkeypatch):
    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    argv = [recording, "--model-seconds", "0.1", "--max-notes", "2"]
    port = _run(_tool("torch_wurli_compare").main,
                [*argv, "--output", a, "--device", "cpu"])
    _run(_tool("wurli_compare").main, [*argv, "--output", b], monkeypatch)
    print(port)
    with open(a) as fa, open(b) as fb:
        port_rep, ref_rep = json.load(fa), json.load(fb)
    assert sorted(e["midi"] for e in port_rep["notes"]) == [60, 67]
    _assert_close(port_rep, ref_rep)


def test_recording_analyzer_matches_reference(recording, tmp_path,
                                              monkeypatch):
    out = {k: (str(tmp_path / f"{k}.json"), str(tmp_path / k))
           for k in ("port", "ref")}
    _run(_tool("torch_recording_analyzer").main,
         ["full", recording, "-o", out["port"][1], "--json", out["port"][0],
          "--device", "cpu"])
    _run(_tool("recording_analyzer").main,
         ["full", recording, "-o", out["ref"][1], "--json", out["ref"][0]],
         monkeypatch)
    with open(out["port"][0]) as fa, open(out["ref"][0]) as fb:
        port_rep, ref_rep = json.load(fa), json.load(fb)
    assert len(port_rep[0]["notes"]) == 2
    _assert_close(port_rep, ref_rep)
    files = sorted(os.listdir(out["ref"][1]))
    assert sorted(os.listdir(out["port"][1])) == files and len(files) == 3
    for f in files:
        with open(os.path.join(out["port"][1], f), "rb") as fa, \
                open(os.path.join(out["ref"][1], f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_gen_settled_states_matches_reference(tmp_path, monkeypatch):
    tool = _tool("torch_gen_settled_states")
    sr = 64000.0
    monkeypatch.setattr(tool, "RATES", [sr])
    for mod in (tremolo, jtrem):
        monkeypatch.setattr(mod, "SETTLE_SECONDS", 0.02)
    jtrem.settled_osc_state.cache_clear()
    path = str(tmp_path / "settled.npz")
    try:
        printed = _run(tool.main, ["--out", path, "--device", "cpu"])
        ref = jtrem.settled_osc_state(sr)
    finally:
        jtrem.settled_osc_state.cache_clear()
    assert f"wrote {path}" in printed
    with np.load(path) as z:
        assert sorted(z.files) == ["sr64000_i", "sr64000_v", "sr64000_vnl"]
        swing = np.abs(np.asarray(ref.v)).max()
        for key, name in (("v", "v"), ("i", "i_nl"), ("vnl", "v_nl")):
            b = np.asarray(getattr(ref, name))
            scale = swing if name != "i_nl" else np.abs(b).max()
            assert np.abs(z[f"sr64000_{key}"] - b).max() <= 1e-9 * scale
    # the package data stays the first source of the settled state
    with np.load(tremolo.SETTLED_PATH) as d:
        assert "sr64000_v" not in d.files


def test_perf_sweep_prints_the_reference_csv():
    out = _run(_tool("torch_perf_sweep").main,
               ["--streams", "1,2", "--seconds", "0.002", "--reps", "1",
                "--device", "cpu"])
    lines = out.strip().splitlines()
    with open(os.path.join(TOOLS, "perf_sweep.py")) as f:
        header = '"streams,compile_s,wall_s,per_stream_rtf,aggregate_rtf"'
        assert header in f.read()
    assert lines[0] == header.strip('"')
    rows = [line.split(",") for line in lines[1:]]
    assert [int(r[0]) for r in rows] == [1, 2]
    for streams, compile_s, wall, per, agg in rows:
        assert float(wall) > 0.0 and int(compile_s) >= 0
        assert len(per.split(".")[1]) == len(agg.split(".")[1]) == 1
        assert abs(float(agg) - float(per) * int(streams)) \
            <= 0.05 * (int(streams) + 1)


def test_engine_chunk_holds_e1_and_e2_to_their_plain_versions():
    out = _run(_tool("torch_engine_chunk").main,
               ["--device", "cpu", "--history", "16", "--chord-s", "0.0065",
                "--warm-up-s", "0.001", "--reps", "1"])
    res = json.loads(out.strip().splitlines()[-1])
    assert res["root"] == os.path.dirname(TOOLS)
    assert res["chunk"] == 256 and res["chord_samples"] == 286
    assert res["warm_up_samples"] == 44
    assert res["e1_bit_identical"] and res["e2_bit_identical"]
    for key in ("warm_up_ms", "chord_ms", "e1_ms", "e1_plain_ms", "e2_ms",
                "e2_plain_ms"):
        assert res[key] > 0.0
    assert res["e2_us_per_base_sample"] == res["e2_ms"] * 1e3 / 256
