"""The f64 engine with the melange preamp in the PyTorch port
(`Engine(44100, preamp_model="melange")`, its kernels' plain versions on
the CPU) against the JAX `Engine` with the same model, and
`WurliPlugin(preamp_model="melange")`.

Both engines start from the reference's state after one 256-sample chunk
(convert.engine_from_numpy carries the melange twin state and its noise
key over), then play a 1024-sample session in 256-sample chunks: a chord,
thermal noise switched on at gain 30, a note-off under the pedal, a
pedal lift. Target: output within -120 dB RMS of the reference's; slot
states, NaN-guard fires, the power amp's counters and the melange noise
key equal.

tests/test_torch_engine_behavioral.py does the same for the behavioral
power amp.
"""

import jax
import numpy as np
import pytest
import torch

from openwurli_tpu import engine as jengine
from openwurli_tpu_torch import convert, host
from openwurli_tpu_torch.engine import MAX_VOICES, Engine
from openwurli_tpu_torch.kernels import engine as ek

torch.set_num_threads(1)

SR = 44100.0
CHUNK = 256


def session(e, render, noise=True):
    """The scripted 4-chunk session; returns the concatenated chunks."""
    outs = []
    for n, v in ((60, 0.8), (64, 0.7), (67, 0.6)):
        e.note_on(n, v)
    outs.append(render(e))
    if noise:
        e.set_noise_enabled(True)
        e.set_noise_gain(30.0)
    e.set_sustain(True)
    e.note_on(72, 0.9)
    outs.append(render(e))
    e.note_off(60)  # under sustain
    outs.append(render(e))
    e.set_sustain(False)  # pedal lift
    outs.append(render(e))
    return np.concatenate(outs)


def check_engine(models, noise):
    """The port against the reference over the session, from the
    reference's state after one chunk."""
    preamp, pa = models
    jeng = jengine.Engine(SR, preamp_model=preamp, pa_model=pa)
    jeng.render(CHUNK)
    start = jax.tree.map(np.asarray, jeng.state)
    ref = session(jeng, lambda e: np.asarray(e.render(CHUNK)), noise)
    port = convert.engine_from_numpy(SR, start, device="cpu",
                                     preamp_model=preamp, pa_model=pa)
    out = session(port, lambda e: e.render(CHUNK).numpy(), noise)
    assert out.shape == ref.shape and np.isfinite(out).all()
    rms = np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    err = np.sqrt(np.mean((out.astype(np.float64) - ref) ** 2))
    db = 20 * np.log10(max(err, 1e-300) / rms)
    print(f"port vs reference engine {models}: {db:.1f} dB (rms {rms:.3g})")
    assert db < -120.0
    js = jeng.state
    assert np.array_equal(port.slot_state(), np.asarray(js.slot_state))
    assert np.array_equal(port.eng_i[MAX_VOICES:2 * MAX_VOICES].numpy(),
                          np.asarray(js.steal_fade))
    assert port.nan_guard_fires() == jeng.nan_guard_fires()
    assert port.power_amp_diag() == jeng.power_amp_diag()
    assert port.tremolo_diag() == jeng.tremolo_diag()
    return port, jeng


def test_melange_engine_matches_reference():
    port, jeng = check_engine(("melange", "circuit"), noise=True)
    a, b = ek.CHAIN_OFF["mel_key"]
    assert np.array_equal(port.chain[a:b].numpy().astype(np.int64),
                          np.asarray(jeng.state.pre.noise_key)
                          .astype(np.int64))
    assert port.noise_enabled and port.noise_gain == 30.0


def test_melange_plugin_syncs_the_noise_params(monkeypatch):
    """WurliPlugin(preamp_model="melange"): authentic_noise and
    noise_level reach the engine at the block's param sync, and the block
    equals the engine driven by hand."""
    plug = host.WurliPlugin(SR, preamp_model="melange", device="cpu")
    assert plug.engine.preamp_model == "melange"
    assert plug.engine.params.preamp_model == "melange"
    ref = Engine(SR, device="cpu", preamp_model="melange")
    plug.params.authentic_noise = True
    plug.params.noise_level = 30.0
    out = plug.process(48, [host.MidiEvent(8, "note_on", 62, 0.9)])
    assert plug.engine.noise_enabled and plug.engine.noise_gain == 30.0
    ref.set_noise_enabled(True)
    ref.set_noise_gain(30.0)
    parts = [ref.render(8)]
    ref.note_on(62, 0.9)
    parts.append(ref.render(40))
    assert np.array_equal(out[:, 0], torch.cat(parts).numpy())
    # the noise reaches the output: the same block without it differs
    quiet = Engine(SR, device="cpu", preamp_model="melange")
    q = [quiet.render(8)]
    quiet.note_on(62, 0.9)
    q.append(quiet.render(40))
    assert not np.array_equal(out[:, 0], torch.cat(q).numpy())
    # the models survive a reset and a new rate
    import openwurli_tpu_torch.engine as pe

    monkeypatch.setattr(pe, "WARM_UP_S", 0.0005)  # a 24-sample warm-up
    plug.reset()
    assert plug.engine.preamp_model == "melange"
    plug.engine.set_sample_rate(48000.0)
    assert plug.engine.preamp_model == "melange"
    assert plug.engine.params.preamp_model == "melange"


def test_engine_models_are_checked():
    with pytest.raises(AssertionError):
        Engine(SR, device="cpu", preamp_model="legacy")
    with pytest.raises(AssertionError):
        Engine(SR, device="cpu", pa_model="ideal")
