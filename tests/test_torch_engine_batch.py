"""The f64 engine batched over B engines (`engine.render_states`, the
counterpart of `jax.vmap(lambda s: engine._render(eng, s, n))`), on the
CPU through the kernels' plain versions.

  (a) Against the JAX package: three engines with different chords and
      velocities, one with rail sag off, one with a NaN voice slot, one
      with a live steal fade, carried over by
      `convert.engine_states_from_numpy` and rendered for 256 samples on
      both sides. Each engine's output within -120 dB RMS of the
      reference's (the target of tests/test_torch_engine.py: the
      reference's own vmap lanes are not bit-identical, identical states
      differing by ~5e-10); slot states, steal fades and NaN-guard fires
      equal.
  (b) For each of the four model instantiations, four engines (a NaN slot,
      a steal fade, rail sag off, a NaN speaker state for guard #2, noise
      on at gain 5 on the melange preamp): each engine's row of the
      batched plain call equals its own one-engine call bit for bit,
      output and state.
  (c) The wrappers reject bad shapes, dtypes, non-tensor flags, mixed and
      unsupported devices; B = 0 renders nothing and returns (0, n).
  (d) `Engine.render` is the B = 1 call of `render_states` on views of the
      engine's own tensors; `Engine.state` round-trips; a broadcast state
      renders B copies of one engine.
"""

import jax
import numpy as np
import pytest
import torch

from openwurli_tpu import engine as jengine
from openwurli_tpu_torch import convert
from openwurli_tpu_torch import engine as pe
from openwurli_tpu_torch.engine import (MAX_VOICES, Engine, EngineState,
                                        broadcast_state, render_states,
                                        stack_states)
from openwurli_tpu_torch.kernels import engine as ek

torch.set_num_threads(1)

SR = 44100.0
N_REF = 256
MODELS = [("dk", "circuit"), ("dk", "behavioral"), ("melange", "circuit"),
          ("melange", "behavioral")]


def _bits(x):
    return x.contiguous().view(torch.int64 if x.element_size() == 8
                               else torch.int32)


# ── (a) against jax.vmap of the reference's _render ──

REF_CHORDS = (
    ((48, 0.95), (55, 0.9), (60, 0.85), (63, 0.8), (67, 0.75), (70, 0.7)),
    ((41, 0.6), (53, 0.7), (65, 0.8)),
    ((36, 0.5), (72, 0.9)),
)


@pytest.fixture(scope="module")
def reference():
    """Three reference engine states, stacked, and their vmapped render."""
    jeng = jengine.Engine(SR)
    states = []
    for k, chord in enumerate(REF_CHORDS):
        jeng.state = jeng.initial_state()
        for note, vel in chord:
            jeng.note_on(note, vel)
        if k == 1:
            jeng.set_rail_sag(False)
        if k == 2:
            for note in range(37, 37 + MAX_VOICES - 1):
                jeng.note_on(note, 0.4)       # fills the bank: one steal
        states.append(jax.tree.map(np.asarray, jeng.state))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *states)
    # a NaN in one sounding slot of engine 1: guard #1
    s = np.array(stacked.vstate.reed.s)
    s[1, 1, 0] = np.nan
    stacked = stacked._replace(vstate=stacked.vstate._replace(
        reed=stacked.vstate.reed._replace(s=s)))
    vrender = jax.jit(jax.vmap(lambda st: jengine._render(jeng, st, N_REF)))
    end, out = vrender(jax.tree.map(jax.numpy.asarray, stacked))
    return stacked, jax.tree.map(np.asarray, end), np.asarray(out)


def test_render_states_matches_reference_vmap(reference):
    start, end, ref = reference
    states = convert.engine_states_from_numpy(SR, start, device="cpu")
    assert states.batch == 3
    assert states.rail_sag.tolist() == [True, False, True]
    assert (states.eng_i[2, MAX_VOICES:2 * MAX_VOICES] > 0).sum() == 1
    eng = Engine(SR, device="cpu")
    states, out = render_states(eng, states, N_REF)
    assert out.shape == ref.shape == (3, N_REF)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    for b in range(3):
        r = ref[b].astype(np.float64)
        err = np.sqrt(np.mean((out[b].numpy().astype(np.float64) - r) ** 2))
        db = 20 * np.log10(max(err, 1e-300) / np.sqrt(np.mean(r ** 2)))
        print(f"engine {b}: {db:.1f} dB against the reference's vmap")
        assert db < -120.0, (b, db)
    eng_i = states.eng_i.numpy()
    assert np.array_equal(eng_i[:, :MAX_VOICES], end.slot_state)
    assert np.array_equal(eng_i[:, MAX_VOICES:2 * MAX_VOICES],
                          end.steal_fade)
    assert np.array_equal(eng_i[:, ek.EI_FIRES], end.nan_guard_fires)
    assert eng_i[:, ek.EI_FIRES].tolist() == [0, 1, 0]


# ── (b) each batched row against its one-engine call ──


def _engine(pre, pa, k):
    """Four distinct engines: chords and velocities differ; 1 has rail sag
    off and a NaN main slot; 2 a live steal fade and a NaN steal slot; 3
    noise on (gain 5) and a NaN speaker state (guard #2)."""
    e = Engine(SR, device="cpu", preamp_model=pre, pa_model=pa)
    chords = ((48, 55, 60), (41, 57, 64, 69), (36, 72), (60, 63, 67, 70, 75))
    for i, note in enumerate(chords[k]):
        e.note_on(note, 0.3 + 0.15 * i + 0.05 * k)
    if k == 1:
        e.set_rail_sag(False)
        e.vst[ek.S_S, 1] = float("nan")
    if k == 2:
        for note in range(33, 33 + MAX_VOICES):
            e.note_on(note, 0.6)
        e.vst[ek.S_C, MAX_VOICES + 1] = float("nan")
    if k == 3:
        e.set_noise_enabled(True)
        e.set_noise_gain(5.0)
        e.chain[ek.CHAIN_OFF["spk"][0]] = float("nan")
    return e


@pytest.mark.parametrize("models", MODELS, ids=lambda m: "-".join(m))
def test_batched_rows_equal_one_engine_calls(models):
    engines = [_engine(*models, k) for k in range(4)]
    states = stack_states([e.state for e in engines])
    assert (states.eng_i[2, MAX_VOICES:2 * MAX_VOICES] > 0).any()
    _, out = render_states(engines[0], states, 32)
    for k, e in enumerate(engines):
        one = e.render(32)
        assert torch.equal(_bits(out[k]), _bits(one)), k
        for name in ("vst", "vsti", "eng_i", "chain"):
            assert torch.equal(_bits(getattr(states, name)[k]),
                               _bits(getattr(e, name))), (k, name)
    fires = states.eng_i[:, ek.EI_FIRES].tolist()
    assert fires[1] == 1 and fires[2] == 1
    assert float(out[3, 0]) == 0.0           # guard #2 silenced it
    assert torch.isfinite(states.chain[3]).all()


# ── (c) what the wrappers take ──


@pytest.fixture(scope="module")
def pair():
    e = Engine(SR, device="cpu")
    e.note_on(60, 0.8)
    return e, broadcast_state(e.state, 2)


def _voices(st, **kw):
    args = dict(vpar=st.vpar, vst=st.vst, vsti=st.vsti, eng_i=st.eng_i)
    args.update(kw)
    return ek.render_voices(*args.values(), 4, 220.0, SR)


def _chain(e, st, **kw):
    args = dict(mono=torch.zeros((st.batch, 4), dtype=torch.float64),
                chain=st.chain, rail_sag=st.rail_sag,
                noise_scale=st.noise_scale)
    args.update(kw)
    return ek.render_chain(e.params, *args.values())


BAD_INPUTS = {
    "vpar float32": (TypeError, lambda e, st: _voices(
        st, vpar=st.vpar.float())),
    "vst of another batch": (ValueError, lambda e, st: _voices(
        st, vst=st.vst[:1].contiguous())),
    "eng_i one engine": (ValueError, lambda e, st: _voices(
        st, eng_i=st.eng_i[0])),
    "vsti not contiguous": (ValueError, lambda e, st: _voices(
        st, vsti=st.vsti.transpose(0, 1).contiguous().transpose(0, 1))),
    "voices on two devices": (ValueError, lambda e, st: _voices(
        st, eng_i=st.eng_i.to("meta"))),
    "voices on an unsupported device": (ValueError, lambda e, st: _voices(
        st, **{k: getattr(st, k).to("meta")
               for k in ("vpar", "vst", "vsti", "eng_i")})),
    "rail_sag a Python bool": (TypeError, lambda e, st: _chain(
        e, st, rail_sag=True)),
    "rail_sag int64": (TypeError, lambda e, st: _chain(
        e, st, rail_sag=st.rail_sag.long())),
    "noise_scale float32": (TypeError, lambda e, st: _chain(
        e, st, noise_scale=st.noise_scale.float())),
    "noise_scale of another batch": (ValueError, lambda e, st: _chain(
        e, st, noise_scale=st.noise_scale[:1].contiguous())),
    "chain one row short": (ValueError, lambda e, st: _chain(
        e, st, chain=st.chain[:, :-1].contiguous())),
    "mono 3-D": (ValueError, lambda e, st: _chain(
        e, st, mono=torch.zeros((2, 4, 1), dtype=torch.float64))),
    "chain on two devices": (ValueError, lambda e, st: _chain(
        e, st, rail_sag=st.rail_sag.to("meta"))),
    "chain on an unsupported device": (ValueError, lambda e, st: _chain(
        e, st, mono=torch.zeros((2, 4), dtype=torch.float64, device="meta"),
        **{k: getattr(st, k).to("meta")
           for k in ("chain", "rail_sag", "noise_scale")})),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_wrappers_reject_bad_batches(pair, case):
    e, st = pair
    err, call = BAD_INPUTS[case]
    with pytest.raises(err):
        call(e, st)


def test_zero_engines_render_nothing(pair):
    e, st = pair
    empty = EngineState(*[x[:0] for x in st])
    calls = (ek.VOICES_PLAIN_CALLS, ek.CHAIN_PLAIN_CALLS)
    got, out = render_states(e, empty, 16)
    assert out.shape == (0, 16) and out.dtype == torch.float32
    assert got.batch == 0
    assert (ek.VOICES_PLAIN_CALLS, ek.CHAIN_PLAIN_CALLS) == calls


# ── (d) the engine's own path ──


def test_engine_render_is_the_one_engine_batch(monkeypatch):
    e = Engine(SR, device="cpu")
    e.note_on(64, 0.7)
    seen = []
    real = pe.render_states

    def spy(eng, states, n):
        seen.append((states.batch, n, states.vst.data_ptr(),
                     states.chain.data_ptr()))
        return real(eng, states, n)

    monkeypatch.setattr(pe, "render_states", spy)
    calls = (ek.VOICES_PLAIN_CALLS, ek.CHAIN_PLAIN_CALLS)
    out = e.render(256 + 7)
    assert out.shape == (263,)
    assert [(b, n) for b, n, _, _ in seen] == [(1, 256), (1, 7)]
    # the batch is made of views of the engine's own tensors
    assert all(v == e.vst.data_ptr() and c == e.chain.data_ptr()
               for _, _, v, c in seen)
    assert (ek.VOICES_PLAIN_CALLS - calls[0],
            ek.CHAIN_PLAIN_CALLS - calls[1]) == (2, 2)


def test_state_round_trip_and_broadcast():
    a = Engine(SR, device="cpu")
    for note in (48, 60, 67):
        a.note_on(note, 0.8)
    a.set_rail_sag(False)
    st = a.state
    assert st.batch == 1 and st.rail_sag.tolist() == [False]
    b = Engine(SR, device="cpu")
    b.state = st
    assert b.rail_sag is False and b.active_voice_count() == 3
    wide = broadcast_state(a.state, 3)
    _, out = render_states(a, wide, 24)
    one = a.render(24)
    for k in range(3):
        assert torch.equal(_bits(out[k]), _bits(one))
        assert torch.equal(_bits(wide.chain[k]), _bits(a.chain))
    assert torch.equal(_bits(b.render(24)), _bits(one))
    with pytest.raises(ValueError):
        broadcast_state(wide, 2)
    with pytest.raises(ValueError):
        b.state = wide
    noisy = st._replace(noise_scale=torch.tensor([2.5], dtype=torch.float64))
    b.state = noisy
    assert b.noise_enabled and b.noise_gain == 2.5


def test_engine_flags_follow_the_setters_without_new_tensors():
    """The B = 1 render takes the flags as one-element device tensors that
    are made anew only when a flag changes, however it was changed."""
    e = Engine(SR, device="cpu")
    first = e._state_views()
    again = e._state_views()
    assert again.rail_sag is first.rail_sag
    assert again.noise_scale is first.noise_scale
    assert first.rail_sag.tolist() == [True]
    assert first.noise_scale.tolist() == [0.0]
    e.set_noise_gain(4.0)
    assert e._state_views().noise_scale.tolist() == [0.0]
    e.set_noise_enabled(True)
    assert e._state_views().noise_scale.tolist() == [4.0]
    e.set_rail_sag(False)
    views = e._state_views()
    assert views.rail_sag.tolist() == [False]
    assert views.rail_sag.dtype == torch.bool
    assert views.noise_scale.dtype == torch.float64
    e.rail_sag = True                  # as convert.engine_from_numpy sets it
    assert e._state_views().rail_sag.tolist() == [True]
    # the copy that Engine.state hands out does not alias the cached flags
    st = e.state
    st.noise_scale[0] = 9.0
    assert e._state_views().noise_scale.tolist() == [4.0]
