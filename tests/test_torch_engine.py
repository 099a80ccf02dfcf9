"""The f64 engine of the PyTorch port (`engine.Engine` on the CPU, its
kernels' plain versions), `host.WurliPlugin` and `StreamHost(engine="f64")`.

  * Lifecycle: the reference engine suite's checks that need no long
    render (tests/test_engine.py): allocation, stealing priority, sustain,
    clamping, re-strike, pedal-up.
  * Whole engine against the JAX `Engine`: both start from the JAX
    engine's state after a short warm-up (convert.engine_from_numpy), then
    play a chord, sustain, 64 held notes and a 65th that steals, a
    note_off under sustain and a pedal lift, rendering 256-sample chunks.
    Target: output within -120 dB RMS of the reference; slot states,
    NaN-guard fires and the solvers' counters equal.
  * WurliPlugin.process splits a block at its events' offsets (the engine
    driven by hand gives the same samples), and StreamHost(engine="f64")
    streams the plugin's audio.
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

from openwurli_tpu import engine as jengine
from openwurli_tpu_torch import convert, host, stream_host
from openwurli_tpu_torch.engine import (FREE, HELD, MAX_VOICES, RELEASING,
                                        SUSTAINED, Engine)

torch.set_num_threads(1)

SR = 44100.0
CHUNK = 256


@pytest.fixture
def eng():
    return Engine(SR, device="cpu")


def _lifecycle(e, case):
    if case == "allocates":
        e.note_on(60, 0.8)
        assert e.held_voice_count() == 1
    elif case == "releases":
        e.note_on(60, 0.8)
        e.note_off(60)
        assert e.held_voice_count() == 0
        assert e.count_voices_in_state(RELEASING) == 1
    elif case == "polyphony":
        for n in range(MAX_VOICES):
            e.note_on(36 + n, 0.8)
        assert e.held_voice_count() == MAX_VOICES
    elif case == "steals_when_full":
        for n in range(MAX_VOICES):
            e.note_on(36 + n, 0.8)
        e.note_on(96, 0.8)
        assert e.held_voice_count() == MAX_VOICES
        assert e.has_steal_voice_for(96)
    elif case == "sustain_defers":
        e.set_sustain(True)
        e.note_on(60, 0.8)
        e.note_off(60)
        assert e.sustained_voice_count() == 1
        assert e.held_voice_count() == 0
        e.set_sustain(False)
        assert e.sustained_voice_count() == 0
        assert e.count_voices_in_state(RELEASING) == 1
    elif case == "clamps":
        e.note_on(0, 0.8)
        e.note_on(127, 0.8)
        assert e.held_voice_count() == 2
        assert sorted(e.midi_note[e.slot_state() == HELD]) == [33, 96]
    elif case == "steal_prefers_sustained":
        e.set_sustain(True)
        for n in range(MAX_VOICES // 2):
            e.note_on(36 + n, 0.8)
            e.note_off(36 + n)
        for n in range(MAX_VOICES // 2, MAX_VOICES):
            e.note_on(36 + n, 0.8)
        sus, held = e.sustained_voice_count(), e.held_voice_count()
        assert sus + held == MAX_VOICES
        e.note_on(127, 0.8)
        assert e.held_voice_count() == held + 1
        assert e.sustained_voice_count() == sus - 1
        # the oldest sustained voice (note 36, slot 0) was stolen
        assert e.eng_i[MAX_VOICES].item() == e.fade_samples
    elif case == "restrike":
        e.set_sustain(True)
        e.note_on(60, 0.8)
        e.note_off(60)
        e.note_on(60, 0.8)
        assert e.count_voices_with_note_in_state(60, SUSTAINED) == 0
        assert e.count_voices_with_note_in_state(60, HELD) == 1
        assert e.count_voices_with_note_in_state(60, RELEASING) == 1
    elif case == "pedal_up_only_sustained":
        e.set_sustain(True)
        e.note_on(60, 0.8)
        e.note_off(60)
        e.note_on(64, 0.8)
        e.set_sustain(False)
        assert e.sustained_voice_count() == 0
        assert e.held_voice_count() == 1
    elif case == "note_off_unknown":
        e.note_on(60, 0.8)
        e.note_off(72)
        assert e.held_voice_count() == 1
    else:
        raise ValueError(case)


@pytest.mark.parametrize("case", [
    "allocates", "releases", "polyphony", "steals_when_full",
    "sustain_defers", "clamps", "steal_prefers_sustained", "restrike",
    "pedal_up_only_sustained", "note_off_unknown"])
def test_lifecycle(eng, case):
    _lifecycle(eng, case)
    # the device's slot states agree with the host's copy
    assert np.array_equal(eng.eng_i[:MAX_VOICES].numpy(), eng.slot_state())


def test_render_chunks_and_cleanup(eng):
    """The reference's CHUNK_LADDER; a voice whose envelope is below -80 dB
    goes FREE at the end of the chunk; a NaN voice fires guard #1."""
    eng.note_on(60, 0.8)
    eng.note_on(64, 0.8)
    eng.vst[14:21, 0] = 1e-9   # slot 0's envelope: silent
    eng.vst[0, 1] = float("nan")  # slot 1's quadrature: non-finite
    out = eng.render(40)
    assert out.dtype == torch.float32 and out.shape == (40,)
    assert torch.isfinite(out).all()
    assert eng.active_voice_count() == 0
    assert eng.nan_guard_fires() == 1
    calls = []
    eng._render_chunk = lambda n: calls.append(n) or torch.zeros(n)
    eng.render(16384 + 2 * 2048 + 256 + 7)
    assert calls == [16384, 2048, 2048, 256, 7]


# ── the whole engine against the JAX engine ──

NOTES_64 = [n for n in range(33, 97) if n not in (60, 64, 67)][:61]


def _session(e, render):
    """The scripted session; returns the concatenated chunks."""
    outs = []
    for n, v in ((60, 0.8), (64, 0.7), (67, 0.6)):
        e.note_on(n, v)
    outs.append(render(e))
    e.set_sustain(True)
    e.note_off(64)
    for n in NOTES_64:
        e.note_on(n, 0.5)
    e.note_on(90, 0.9)  # the 65th voice: steals the sustained 64
    outs.append(render(e))
    e.note_off(60)  # under sustain
    outs.append(render(e))
    e.set_sustain(False)  # pedal lift
    outs.append(render(e))
    return np.concatenate(outs)


@pytest.fixture(scope="module")
def reference():
    jeng = jengine.Engine(SR)
    for _ in range(4):
        jeng.render(CHUNK)
    start = jax.tree.map(np.asarray, jeng.state)
    out = _session(jeng, lambda e: np.asarray(e.render(CHUNK)))
    return start, out, jeng


def test_engine_matches_reference(reference):
    start, ref, jeng = reference
    port = convert.engine_from_numpy(SR, start, device="cpu")
    assert np.array_equal(port.slot_state(), start.slot_state)
    out = _session(port, lambda e: e.render(CHUNK).numpy())
    assert out.shape == ref.shape and np.isfinite(out).all()
    rms = np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    err = np.sqrt(np.mean((out.astype(np.float64) - ref) ** 2))
    db = 20 * np.log10(max(err, 1e-300) / rms)
    print(f"port vs reference engine: {db:.1f} dB (rms {rms:.3g})")
    assert db < -120.0
    js = jeng.state
    assert np.array_equal(port.slot_state(), np.asarray(js.slot_state))
    assert np.array_equal(port.eng_i[MAX_VOICES:2 * MAX_VOICES].numpy(),
                          np.asarray(js.steal_fade))
    assert port.nan_guard_fires() == jeng.nan_guard_fires()
    assert port.power_amp_diag() == jeng.power_amp_diag()
    assert port.tremolo_diag() == jeng.tremolo_diag()
    assert port.count_voices_in_state(FREE) < MAX_VOICES


# ── plugin and stream host ──


def test_wurli_plugin_splits_blocks_at_event_offsets():
    plug = host.WurliPlugin(SR, device="cpu")
    ref = Engine(SR, device="cpu")
    ev = [host.MidiEvent(37, "note_on", 62, 0.9),
          host.MidiEvent(5, "note_on", 69, 0.6),
          host.MidiEvent(37, "cc", cc=64, value=100),
          host.MidiEvent(70, "note_on", 62, 0.0)]
    plug.params.volume = 0.7
    out = plug.process(96, ev)
    assert out.shape == (96, 2) and out.dtype == np.float32
    assert np.array_equal(out[:, 0], out[:, 1])
    ref.set_volume(0.7)
    parts = [ref.render(5)]
    ref.note_on(69, 0.6)
    parts.append(ref.render(32))
    ref.note_on(62, 0.9)
    ref.set_sustain(True)
    parts.append(ref.render(33))
    ref.note_off(62)
    parts.append(ref.render(26))
    assert np.array_equal(out[:, 0], torch.cat(parts).numpy())
    assert plug.engine.sustained_voice_count() == 1
    assert plug.engine.mlp_enabled is True


def test_stream_host_f64_streams_the_plugin():
    h = stream_host.StreamHost(SR, block=48, engine="f64", device="cpu")
    assert isinstance(h.plugin, host.WurliPlugin)
    out = io.BytesIO()
    for line in ('{"cmd": "param", "name": "tremolo_depth", "value": 0.2}',
                 json.dumps({"cmd": "events", "events": [
                     {"offset": 3, "kind": "note_on", "note": 57,
                      "velocity": 0.7}]}),
                 '{"cmd": "render", "blocks": 2}'):
        assert h.handle(line, out) is True
    assert h.handle('{"cmd": "quit"}', out) is False
    pcm = np.frombuffer(out.getvalue(), dtype=np.float32).reshape(-1, 2)
    ref = host.WurliPlugin(SR, device="cpu")
    ref.params.tremolo_depth = 0.2
    want = np.concatenate([
        ref.process(48, [host.MidiEvent(3, "note_on", 57, 0.7)]),
        ref.process(48)])
    assert np.array_equal(pcm, want)
    assert np.abs(pcm).max() > 0.0


def _cu_enum(src, name):
    import re

    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    out, nxt = {}, 0
    for item in (x.strip() for x in body.replace("\n", " ").split(",")):
        if not item:
            continue
        key, _, val = item.partition("=")
        nxt = int(val) if val.strip() else nxt
        out[key.strip()] = nxt
        nxt += 1
    return out


def test_engine_cuda_layouts_match_python():
    """csrc/engine.cu's layout enums against kernels/engine.py."""
    import os

    from openwurli_tpu_torch.kernels import engine as ek

    with open(os.path.join(os.path.dirname(ek.__file__), "..", "csrc",
                           "engine.cu")) as f:
        src = f.read()
    for enum in ("VPar", "VSt", "VStI"):
        for k, v in _cu_enum(src, enum).items():
            assert getattr(ek, k) == v, k
    chain = _cu_enum(src, "ChainOffset")
    assert chain.pop("CHAIN_ROWS") == ek.CHAIN_ROWS
    assert chain == {"CH_" + n.upper(): a for n, (a, _b) in
                     ek.CHAIN_OFF.items()}
    cp = ek.chain_params(SR)
    consts = _cu_enum(src, "ConstOffset")
    assert consts == {"C_TREM": cp.offsets["trem"], "C_PA": cp.offsets["pa"],
                      "C_PRE": cp.offsets["pre"],
                      "C_MISC": cp.offsets["misc"], "C_TOTAL": cp.flat.size}
    pre, off = _cu_enum(src, "PreOffset"), 0
    for name, size in ek.PRE_SPEC:
        assert pre["PR_" + {"a_neg_base": "a_neg"}.get(name, name).upper()] \
            == off, name
        off += size
    misc = _cu_enum(src, "Misc")
    assert misc.pop("N_MISC") == len(ek.MISC_NAMES)
    assert list(misc) == ["M_" + n.upper() for n in ek.MISC_NAMES]
    assert list(misc.values()) == list(range(len(ek.MISC_NAMES)))
    assert ek.EI_FIRES == _cu_enum(src, "EngI")["EI_FIRES"]


def test_model_layouts_match_cuda():
    """csrc/engine.cu's melange, DK-preamp and E5 layouts against the
    Python packers (kernels/engine.py, kernels/render.py)."""
    import os

    from openwurli_tpu_torch.circuits import melange_preamp
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    with open(os.path.join(os.path.dirname(ek.__file__), "..", "csrc",
                           "engine.cu")) as f:
        src = f.read()
    mel, off = _cu_enum(src, "MelOffset"), 0
    for name, size in ek.MEL_SPEC:
        assert mel.pop("ML_" + name.upper()) == off, name
        off += size
    assert mel == {"ML_SIZE": off}
    cp = ek.chain_params(SR, "melange", "behavioral")
    assert cp.offsets["mel"] == _cu_enum(src, "ConstOffset")["C_TOTAL"]
    assert cp.flat.size == cp.offsets["mel"] + off
    assert ek.melange_block(melange_preamp.make_params(88200.0)).size == off
    ms = _cu_enum(src, "MelState")
    base = ek.CHAIN_OFF["mel_v"][0]
    for name in ("v", "i", "vnl", "gprev", "key", "wprev"):
        assert ms["MS_" + name.upper()] == ek.CHAIN_OFF["mel_" + name][0] \
            - base, name
    assert ms["MS_ROWS"] == kr.MEL_STATE_ROWS
    ps = _cu_enum(src, "PreState")
    base = ek.CHAIN_OFF["pre_v"][0]
    for name in ("v", "i", "vnl", "jcin", "cinprev", "gprev"):
        assert ps["PS_" + name.upper()] == ek.CHAIN_OFF["pre_" + name][0] \
            - base, name
    assert 13 + ps["PS_ROWS"] == kr.DK_ROWS
    assert [n for n, _ in kr.DK_SPEC] == [
        n for n, _ in ek.CHAIN_SPEC[:5]] + [
        n for n, _ in ek.CHAIN_SPEC if n.startswith("pre_")]
    models = _cu_enum(src, "Models")
    assert [models["PRE_" + m.upper()] for m in ek.PREAMP_MODELS] == [0, 1]
    assert [models["PA_" + m.upper()] for m in ek.PA_MODELS] == [0, 1]


def test_engine_wrappers_reject_bad_inputs(eng):
    from openwurli_tpu_torch.kernels import engine as ek

    args = (eng.vpar, eng.vst, eng.vsti, eng.eng_i)
    with pytest.raises(TypeError):
        ek.render_voices(eng.vpar.float(), *args[1:], 4, eng.fade_len, SR)
    with pytest.raises(ValueError):
        ek.render_voices(eng.vpar[:, :64].contiguous(), *args[1:], 4,
                         eng.fade_len, SR)
    with pytest.raises(ValueError, match="unsupported device"):
        ek.render_voices(*[a.to("meta") for a in args], 4, eng.fade_len,
                         SR)
    mono = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        ek.render_chain(eng.params, mono, eng.chain[:-1].contiguous(), True)
    with pytest.raises(TypeError):
        ek.render_chain(eng.params, mono.float(), eng.chain, True)
    with pytest.raises(ValueError):
        ek.settle(88200.0, torch.zeros(ek.OSC_ROWS + 1,
                                       dtype=torch.float64), 3)


def test_reset_and_set_sample_rate_keep_targets_and_flags(eng, monkeypatch):
    import openwurli_tpu_torch.engine as pe

    monkeypatch.setattr(pe, "WARM_UP_S", 0.0005)  # a 22-sample warm-up
    eng.set_volume(0.8)
    eng.set_mlp_enabled(False)
    eng.set_rail_sag(False)
    eng.note_on(60, 0.8)
    eng.render(8)
    eng.reset()
    assert eng.active_voice_count() == 0 and eng.mlp_enabled is False
    a, _ = pe.ek.CHAIN_OFF["sm_volume"]
    assert eng.chain[a:a + 4].tolist() == [0.8, 0.8, 0.0, 0.0]
    eng.set_speaker_character(0.5)
    eng.set_sample_rate(48000.0)
    assert eng.sample_rate == 48000.0 and eng.rail_sag is False
    assert eng.fade_samples == 240 and eng.ramp_samples == 240
    a, _ = pe.ek.CHAIN_OFF["sm_char"]
    assert eng.chain[a + pe.ek.SM_TARGET].item() == 0.5
    out = eng.render(16)
    assert torch.isfinite(out).all()
