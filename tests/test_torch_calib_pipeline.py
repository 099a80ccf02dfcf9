"""The 7-stage calibration pipeline (`calib.pipeline.main`) in the PyTorch
port against the JAX package's (CPU), on one short synthetic recording
with the same `--data-dir` inputs.

  * stages 1-3: `notes.json` and `scored_notes.json` equal,
    `harmonics.json` within 1e-9 relative;
  * stage 4 at `--model-seconds 0.05`: the model renders (`di.render_di`,
    all pairs in one pass) under `test_torch_di_preamp.py`'s gate (-120 dB
    RMS, else the reference's 1-ulp DK twin + 3 dB), the JSON's keys and
    f0s equal;
  * stage 5 from the reference's `model_harmonics.json`:
    `training_data.npz` equal;
  * stage 6 (`--epochs 50`) from the reference's initial weights carried
    across: `model_weights.npz` within 1e-9 relative;
  * `--dry-run` prints the reference's stage list.
Stage 7 (installing the weights) is not run.
"""

import io
import json
import shutil
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import di as jdi
from openwurli_tpu import voice as jvoice
from openwurli_tpu.calib import pipeline as jpipe
from openwurli_tpu.calib import train as jtrain
from openwurli_tpu.io import wav as jwav
from openwurli_tpu_torch import convert, di
from openwurli_tpu_torch.calib import pipeline, train
from test_torch_di_preamp import _assert_di_gate, _twin_preamp_di

torch.set_num_threads(1)

SR = 44100.0


def _recording():
    """Three isolated decaying tones (MIDI 57, 64, 69) with a strong H2."""
    rng = np.random.default_rng(11)
    x = np.zeros(int(SR * 3.4))
    t = np.arange(int(SR * 0.9)) / SR
    for onset, midi in ((0.3, 57), (1.4, 64), (2.4, 69)):
        f0 = 440.0 * 2 ** ((midi - 69) / 12)
        tone = sum(a * np.sin(2 * np.pi * k * f0 * t) for k, a in
                   ((1, 1.0), (2, 0.5), (3, 0.2), (4, 0.08)))
        i = int(onset * SR)
        x[i:i + t.size] += 0.4 * tone * np.exp(-t * 2.5) * np.minimum(
            t / 0.005, 1.0)
    return x + 1e-5 * rng.normal(size=x.size)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    rec = root / "recordings"
    rec.mkdir()
    jwav.write_wav(str(rec / "take.wav"), _recording(), SR, bits=24)
    return rec, root / "port", root / "ref"


def _main(mod, rec, data, *args):
    argv = ["--input-dir", str(rec), "--data-dir", str(data), *args]
    if mod is pipeline:
        argv += ["--device", "cpu"]
    mod.main(argv)


def _load(path):
    with open(path) as f:
        return json.load(f)


def _close(a, b, path=""):
    """Nested JSON values: floats within 1e-9 relative (NaN equal)."""
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{k}]")
    elif isinstance(b, float):
        if np.isnan(b):
            assert np.isnan(a), path
        else:
            assert abs(a - b) <= 1e-9 * abs(b), (path, a, b)
    else:
        assert a == b, path


def test_stages_1_to_3_match_reference(dirs):
    rec, port, ref = dirs
    _main(pipeline, rec, port, "--through-stage", "3")
    _main(jpipe, rec, ref, "--through-stage", "3")
    found = _load(port / "notes.json")
    assert found == _load(ref / "notes.json")
    assert sorted(n["midi_note"] for n in found) == [57, 64, 69]
    assert _load(port / "scored_notes.json") == \
        _load(ref / "scored_notes.json")
    _close(_load(port / "harmonics.json"), _load(ref / "harmonics.json"))


def test_stage_4_matches_reference(dirs, monkeypatch):
    rec, port, ref = dirs
    if not (ref / "harmonics.json").exists():
        _main(jpipe, rec, ref, "--through-stage", "3")
    shutil.copy(ref / "harmonics.json", port / "harmonics.json")
    renders = {}

    def keep(name, fn):
        def wrapped(midis, vels, *a, **k):
            renders[name] = (np.asarray(midis), np.asarray(vels),
                             fn(midis, vels, *a, **k))
            return renders[name][2]
        return wrapped

    monkeypatch.setattr(di, "render_di", keep("port", di.render_di))
    monkeypatch.setattr(jdi, "render_di", keep("ref", jdi.render_di))
    for mod, d in ((pipeline, port), (jpipe, ref)):
        _main(mod, rec, d, "--from-stage", "4", "--through-stage", "4",
              "--model-seconds", "0.05")
    (m, v, out), (jm, jv, jout) = renders["port"], renders["ref"]
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(v, jv)
    assert out.shape == np.shape(jout) == (int(0.05 * SR), len(m))
    voices = np.asarray(jvoice.render_note(jnp.asarray(jm), jnp.asarray(jv),
                                           0.05, SR, mlp_enabled=False))
    twins = [_twin_preamp_di(voices, SR, s) for s in (1, 2)]
    _assert_di_gate("stage 4", out, np.asarray(jout), twins)
    a, b = _load(port / "model_harmonics.json"), \
        _load(ref / "model_harmonics.json")
    assert set(a) == set(b)
    for k in b:
        assert a[k]["f0_hz"] == b[k]["f0_hz"], k


def test_stages_5_and_6_match_reference(dirs, monkeypatch):
    rec, port, ref = dirs
    if not (ref / "model_harmonics.json").exists():
        _main(jpipe, rec, ref, "--through-stage", "4", "--model-seconds",
              "0.05")
    for name in ("harmonics.json", "model_harmonics.json"):
        shutil.copy(ref / name, port / name)
    for mod, d in ((pipeline, port), (jpipe, ref)):
        _main(mod, rec, d, "--from-stage", "5", "--through-stage", "5")
    with np.load(port / "training_data.npz") as a, \
            np.load(ref / "training_data.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert b["mask"].any()

    def carried(gen, hidden, target_means, target_stds, device):
        jw = jtrain.init_weights(jax.random.PRNGKey(0), hidden,
                                 np.asarray(target_means),
                                 np.asarray(target_stds))
        return convert.mlp_weights_from_numpy(jw, device)

    monkeypatch.setattr(train, "init_weights", carried)
    for mod, d in ((pipeline, port), (jpipe, ref)):
        _main(mod, rec, d, "--from-stage", "6", "--through-stage", "6",
              "--epochs", "50")
    with np.load(port / "model_weights.npz") as a, \
            np.load(ref / "model_weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            scale = max(np.max(np.abs(b[k])), 1e-300)
            assert np.max(np.abs(a[k] - b[k])) <= 1e-9 * scale, k


def test_dry_run_lists_the_same_stages():
    for args in ([], ["--from-stage", "2", "--through-stage", "4"],
                 ["--train"]):
        outs = []
        for mod in (pipeline, jpipe):
            buf = io.StringIO()
            with redirect_stdout(buf):
                mod.main(["--dry-run", *args])
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and "Stage 7" in outs[0]
    assert [s[:2] for s in pipeline.STAGES] == [s[:2] for s in jpipe.STAGES]
