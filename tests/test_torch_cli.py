"""The PyTorch port's CLI (`openwurli_tpu_torch.cli`) against the JAX
package's (`openwurli_tpu.cli`), on the CPU.

  * Parser parity: the same 21 subcommands, each with the reference's
    options, defaults, types and actions; the port's one addition is the
    top-level `--device`.
  * `tables.intermod_risk`: every entry within 1e-12 of the reference's,
    relative to the largest magnitude of its key (the mode-7 spatial
    coupling of the notes where it nearly cancels, ~1e-19 of mode 1's,
    differs by a few ulps of libm inside the reference's own mode shapes),
    `nearest_integer` exactly; and `intermod-audit`'s stdout and stderr,
    the same text.
  * `reed-render` and `render` at 0.05 s: the WAVs both CLIs write, read
    back within 2 LSB of 24 bits.
  * The cases of tests/test_cli_integration.py (slow there) at sizes that
    fit: `reed-render` determinism and its WAV spec, velocity ordering,
    the `calibrate` CSV schema; and the CSV's parsed values, with
    `DURATION_S` cut to 20 ms in both packages as
    tests/test_torch_calibrate.py cuts it, within one unit of the CSV's
    printed place (its gates there are far below it).
"""

import argparse
import contextlib
import io

import numpy as np
import pytest
import torch

from openwurli_tpu import cli as jcli
from openwurli_tpu import tables as jtables
from openwurli_tpu.calib import calibrate as jcal
from openwurli_tpu.io import wav as jwav
from openwurli_tpu_torch import cli, tables, voice
from openwurli_tpu_torch.calib import calibrate
from openwurli_tpu_torch.io import wav

torch.set_num_threads(1)

LSB24 = 1.0 / (1 << 23)


def _subparsers(parser):
    (action,) = [a for a in parser._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(sub):
    """Every option of a subparser: what it parses, not its help text."""
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.default,
                     a.type, a.nargs, a.const, a.required, a.choices)
            for a in sub._actions if a.dest != "help"}


def test_parser_matches_reference():
    port, ref = cli.build_parser(), jcli.build_parser()
    subs, ref_subs = _subparsers(port), _subparsers(ref)
    assert list(subs) == list(ref_subs) and len(subs) == 21
    for name in subs:
        assert _options(subs[name]) == _options(ref_subs[name]), name
        assert subs[name].get_default("fn").__name__ == \
            ref_subs[name].get_default("fn").__name__, name
    top = {a.dest for a in port._actions} - {a.dest for a in ref._actions}
    assert top == {"device"} and port.get_default("device") == "cuda"
    args = port.parse_args(["--device", "cpu", "gain", "--freq", "440"])
    assert (args.device, args.freq, args.r_ldr) == ("cpu", 440.0, 1e6)


def test_intermod_risk_matches_reference():
    midis = np.arange(tables.MIDI_LO, tables.MIDI_HI + 1)
    port = tables.intermod_risk(midis)
    ref = {k: np.asarray(v) for k, v in jtables.intermod_risk(midis).items()}
    assert set(port) == set(ref) and len(port) == 12
    for k, v in port.items():
        assert v.shape == ref[k].shape and v.dtype == np.float64, k
        err = np.abs(v - ref[k]).max() / np.abs(ref[k]).max()
        assert err <= 1e-12, (k, err)
    np.testing.assert_array_equal(port["nearest_integer"],
                                  ref["nearest_integer"])
    # the pieces, on their own inputs
    beats = np.array([0.0, 0.49, 0.5, 1.9, 2.0, 5.0, 7.0, 10.0, 25.0, 40.0,
                      41.0])
    np.testing.assert_allclose(tables.perceptual_beat_weight(beats),
                               jtables.perceptual_beat_weight(beats),
                               rtol=1e-15, atol=0)


def _outputs(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(argv)
    return out.getvalue(), err.getvalue()


def test_intermod_audit_prints_match_reference():
    port = _outputs(cli.main, ["--device", "cpu", "intermod-audit"])
    ref = _outputs(jcli.main, ["intermod-audit"])
    assert port == ref
    assert len(port[0].splitlines()) == 65
    assert port[1].startswith("# worst: MIDI ")


@pytest.mark.parametrize("argv", [
    ["reed-render", "-n", "64", "-v", "90"],
    ["render", "-n", "57", "-v", "110"],
])
def test_wavs_match_reference(tmp_path, argv):
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "ref.wav")
    common = ["--duration", "0.05", "-o"]
    cli.main(["--device", "cpu", *argv, *common, a])
    jcli.main([*argv, *common, b])
    x, sr = wav.read_wav(a)
    y, sr_ref = jwav.read_wav(b)
    assert sr == sr_ref == 44100 and x.shape == y.shape == (2205,)
    err = np.abs(x - y).max()
    print(f"{argv[0]}: {err / LSB24:.2f} LSB, peak {np.abs(y).max():.4f}")
    assert err <= 2 * LSB24
    assert np.abs(x).max() > 1e-3


def test_reed_render_deterministic_wav_spec(tmp_path):
    for k in range(2):
        cli.main(["--device", "cpu", "reed-render", "-n", "72", "-v", "90",
                  "--duration", "0.05", "-o", str(tmp_path / f"d{k}.wav")])
    a, sr = wav.read_wav(str(tmp_path / "d0.wav"))
    b, _ = wav.read_wav(str(tmp_path / "d1.wav"))
    assert sr == 44100 and len(a) == int(0.05 * 44100)
    assert np.abs(a).max() > 0.1  # the normalized render has signal
    np.testing.assert_array_equal(a, b)


def test_reed_render_velocity_ordering(tmp_path):
    for vel in (40, 120):
        cli.main(["--device", "cpu", "reed-render", "-n", "60", "-v",
                  str(vel), "--duration", "0.05",
                  "-o", str(tmp_path / f"v{vel}.wav")])
    a40, _ = wav.read_wav(str(tmp_path / "v40.wav"))
    a120, _ = wav.read_wav(str(tmp_path / "v120.wav"))
    assert len(a40) == len(a120) == int(0.05 * 44100)
    # the files are peak-normalized: the ordering shows in the library
    out = voice.render_note(np.array([60.0, 60.0]),
                            np.array([40 / 127, 120 / 127]), 0.05, 44100.0,
                            device="cpu").numpy()
    assert np.abs(out[:, 1]).max() > np.abs(out[:, 0]).max()


@pytest.fixture(scope="module")
def calibrate_csvs(tmp_path_factory):
    """The `calibrate` CSV of both CLIs at one note × two velocities, the
    render cut to 20 ms in both packages."""
    d = tmp_path_factory.mktemp("cal")
    argv = ["calibrate", "--notes", "60", "--velocities", "64,127", "-o"]
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jcal, calibrate):
            mp.setattr(mod, "DURATION_S", 0.02)
            mp.setattr(mod, "MEASURE_START_S", 0.004)
            mp.setattr(mod, "MEASURE_END_S", 0.018)
        cli.main(["--device", "cpu", *argv, str(d / "port.csv")])
        jcli.main([*argv, str(d / "ref.csv")])
    return [(d / f).read_text().strip().splitlines()
            for f in ("port.csv", "ref.csv")]


def test_calibrate_csv_schema(calibrate_csvs):
    lines, _ = calibrate_csvs
    header = lines[0].split(",")
    assert header[:3] == ["midi", "note_name", "velocity"]
    assert "t5_rms_db" in header and "tanh_compression_db" in header
    assert len(header) == 21 and len(lines) == 3
    row = lines[1].split(",")
    assert row[0] == "60" and row[1] == "C4" and row[2] == "64"


def test_calibrate_csv_matches_reference(calibrate_csvs):
    port, ref = calibrate_csvs
    assert port[0] == ref[0] and len(port) == len(ref)
    for p_line, r_line in zip(port[1:], ref[1:]):
        p, r = p_line.split(","), r_line.split(",")
        assert p[:3] == r[:3]
        for name, a, b in zip(port[0].split(",")[3:], p[3:], r[3:]):
            unit = 10.0 ** -len(b.split(".")[1])
            assert abs(float(a) - float(b)) <= unit * (1 + 1e-9), (name, a, b)
