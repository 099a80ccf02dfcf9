"""The PyTorch port's interactive engine (`fast_engine.FastEngine`) on the
CPU, at a small size: 44.1 kHz, blocks of 32 samples (`BLOCK` patched),
a warm-up of one block (`WARM_UP_S` patched), t_tile=32. The plain chain
costs about 20 ms per sample here, so every test counts its blocks.

The counterparts of the ten non-slow tests of tests/test_fast_engine.py:

  * the three bit-exact ones hold a live session, bit for bit, to a block
    loop written here from the port's own `vb.render_voice_bank` and
    `mc.render` with the engine's two pins (`steady=None`,
    `min_release=0.0`) and the whole schedule known from t=0: lane
    re-initialisation at note-on equals scheduling from the start;
  * one level test holds the engine to the port's `fast.render_events`,
    which passes the schedule's own `min_release` and `steady_limits`
    (the kernel's two stages round differently): chain input ≤ −80 dB
    relative RMS, output no worse than the chain's own worst response to
    a 1-ulp perturbation of that input + 3 dB (the twin gate of
    tests/test_torch_events_chain.py, with the twins run through the
    port's chain);
  * host bookkeeping is held exactly to the JAX `FastEngine` (constructed,
    never rendered): the same calls give equal `_midis`, `_vels`,
    `_onsets`, `_releases`, `_n_used`, `_ringing`, `_pending`, lane reuse
    past 128 lanes included. The port's engine for that is built by
    `convert.fast_engine_from_numpy` from the JAX engine's initial arrays.
"""

import numpy as np
import pytest
import torch

from openwurli_tpu.fast_engine import FastEngine as JaxFastEngine
from openwurli_tpu_torch import convert, fast, fast_engine
from openwurli_tpu_torch.fast_engine import FastEngine
from openwurli_tpu_torch.host import FastWurliPlugin, MidiEvent
from openwurli_tpu_torch.kernels import mono_chain as pmc
from openwurli_tpu_torch.kernels import voice_bank as pvb

torch.set_num_threads(1)

SR = 44100.0
BLK = 32
T_TILE = 32
# the module's constants as imported, before any test patches them
DEFAULTS = (fast_engine.LANES, fast_engine.BLOCK, fast_engine.WARM_UP_S)


@pytest.fixture(autouse=True)
def small_engine(monkeypatch):
    monkeypatch.setattr(fast_engine, "BLOCK", BLK)
    monkeypatch.setattr(fast_engine, "WARM_UP_S", BLK / SR)


def _mk(**kw):
    return FastEngine(SR, t_tile=T_TILE, device="cpu", **kw)


def bits(x):
    return x.contiguous().view(torch.int32)


def block_loop(midis, vels, onsets, releases, n_blocks, ctrl, chain_state):
    """The engine's block, n_blocks times, over a schedule known from t=0
    → (n_blocks·BLK,) float32 array."""
    params, _ = pvb.make_kernel_params(midis, vels, SR, onsets=onsets,
                                       releases=releases,
                                       lanes=fast_engine.LANES)
    vstate = pvb.init_bank_state(params)
    outs = []
    for b in range(n_blocks):
        voices, vstate = pvb.render_voice_bank(
            params, BLK, steady=None, state=vstate, n0=b * BLK,
            return_state=True, events=True, min_release=0.0)
        out, chain_state = pmc.render(SR, ctrl, chain_state,
                                      voices.sum(-1, keepdim=True))
        outs.append(out[:, 0])
    return torch.cat(outs).numpy()


def test_constants_and_small_sizes():
    assert DEFAULTS == (128, 1024, 0.6)
    eng = _mk()
    assert eng.block == BLK and eng.device.type == "cpu"
    with pytest.raises(ValueError):
        FastEngine(SR, t_tile=24, device="cpu")


def test_session_matches_block_loop_bit_exact():
    """Three notes started and stopped across blocks and a pedal hold,
    driven live, against the block loop with the equivalent schedule."""
    eng = _mk()
    eng.warm_up()
    warm_state = eng._chain_state.clone()
    blk = eng.block

    out = []
    eng.note_on(60, 0.9)
    out.append(eng.render(blk))           # block 0
    eng.note_on(64, 0.7)
    eng.set_sustain(True)
    out.append(eng.render(blk))           # block 1
    eng.note_off(60)                      # held by the pedal
    out.append(eng.render(blk))           # block 2
    eng.set_sustain(False)                # releases 60 at block 3 start
    eng.note_on(55, 0.8)
    out.append(eng.render(2 * blk))       # blocks 3-4
    eng.note_off(64)
    eng.note_off(55)
    out.append(eng.render(blk))           # block 5
    got = np.concatenate(out)

    want = block_loop([60.0, 64.0, 55.0], [0.9, 0.7, 0.8],
                      [0.0, 1.0 * blk, 3.0 * blk],
                      [3.0 * blk, 5.0 * blk, 5.0 * blk], 6, eng._controls(),
                      warm_state)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 1e-4


def test_midblock_event_offsets_bit_exact():
    """Events placed INSIDE a block through the offset argument match the
    block loop given the same absolute sample positions."""
    eng = _mk()
    eng.warm_up()
    warm_state = eng._chain_state.clone()
    blk = eng.block

    out = []
    eng.note_on(60, 0.9, offset=16)          # mid-block onset
    out.append(eng.render(blk))              # block 0
    eng.note_on(64, 0.7, offset=blk - 16)    # near block end
    out.append(eng.render(blk))              # block 1
    eng.note_off(60, offset=20)              # mid-block release
    eng.set_sustain(True)
    out.append(eng.render(blk))              # block 2
    eng.note_off(64)                         # pedal-held
    eng.set_sustain(False, offset=9)         # pedal lift mid-block 3
    out.append(eng.render(2 * blk))          # blocks 3-4
    got = np.concatenate(out)

    want = block_loop([60.0, 64.0], [0.9, 0.7],
                      [16.0, 1.0 * blk + (blk - 16)],
                      [2.0 * blk + 20, 3.0 * blk + 9], 5, eng._controls(),
                      warm_state)
    np.testing.assert_array_equal(got, want)


def test_lookahead_pipelining_bit_exact():
    """lookahead=k queues k extra blocks before the oldest one is copied.
    Events made before their blocks are queued give audio bit-identical
    to lookahead=0; an event made after its block went in flight lands
    k blocks later, never changing queued audio."""
    a = _mk(lookahead=0)
    b = _mk(lookahead=2)
    for e in (a, b):
        e.note_on(60, 0.9, offset=16)
    got_a = a.render(3 * a.block)
    got_b = b.render(3 * b.block)
    np.testing.assert_array_equal(got_a, got_b)
    assert (a._horizon, b._horizon) == (3 * BLK, 5 * BLK)

    # late event: with lookahead=2, blocks 3-4 are already in flight when
    # the note_off arrives, so it lands at block 5 (the horizon), two
    # blocks later than the lookahead=0 engine places it.
    a.note_off(60, offset=16)
    b.note_off(60, offset=16)
    assert b._releases[0] == a._releases[0] + 2 * b.block
    tail_a = a.render(3 * a.block)
    tail_b = b.render(3 * b.block)
    assert np.isfinite(tail_a).all() and np.isfinite(tail_b).all()
    # until a's release both engines render the same audio
    rel_a = int(a._releases[0]) - 3 * BLK
    np.testing.assert_array_equal(tail_a[:rel_a], tail_b[:rel_a])
    assert not np.array_equal(tail_a, tail_b)
    # the pipelined engine equals the block loop at its own release
    want = block_loop([60.0], [0.9], [16.0], [b._releases[0]], 6,
                      b._controls(), pmc.init_state(SR, 1))
    np.testing.assert_array_equal(np.concatenate([got_b, tail_b]), want)


def test_session_level_against_render_events(monkeypatch):
    """The engine against the port's batch renderer, at a level."""
    midis, vels = [60.0, 67.0], [0.9, 0.8]
    onsets, releases = [0.0, 1.0 * BLK], [2.0 * BLK + 16, np.inf]
    n_blocks = 8    # 256 samples: long enough for the chain to respond

    calls = []
    render = pmc.render

    def spy(base_sr, controls, state, x, noise=False):
        calls.append((state.clone(), x.clone()))
        return render(base_sr, controls, state, x, noise=noise)

    eng = _mk()
    eng.warm_up()
    with monkeypatch.context() as m:
        m.setattr(pmc, "render", spy)
        eng.note_on(60, 0.9)
        got = [eng.render(BLK)]
        eng.note_on(67, 0.8)
        got.append(eng.render(BLK))
        eng.note_off(60, offset=16)
        got.append(eng.render((n_blocks - 2) * BLK))
    got = np.concatenate(got)
    eng_audio = torch.cat([x for _st, x in calls]).numpy()[:, 0]

    del calls[:]
    with monkeypatch.context() as m:
        m.setattr(pmc, "render", spy)
        want = fast.render_events(
            midis, vels, onsets, releases, n_blocks * BLK / SR, SR,
            warm_seconds=BLK / SR, block_seconds=BLK / SR, t_tile=T_TILE,
            device="cpu").numpy()
    assert calls[0][1].shape == (BLK, 1) and not calls[0][1].any()
    warm_state = calls[1][0]
    re_audio = torch.cat([x for _st, x in calls[1:]]).numpy()[:, 0]

    def db(err, sig):
        return 20.0 * np.log10(max(np.sqrt(np.mean(err ** 2)), 1e-30)
                               / np.sqrt(np.mean(sig ** 2)))

    in_db = db(eng_audio - re_audio, re_audio)
    assert in_db <= -80.0, f"chain input {in_db:.1f} dB"

    # three 1-ulp twins of render_events' chain input through the port's
    # chain, beside the input itself
    rng = np.random.default_rng(7)
    cols = [re_audio] + [
        (re_audio * (1.0 + 2.0 ** -23 * rng.choice([-1.0, 1.0],
                                                    re_audio.shape))
         ).astype(np.float32) for _ in range(3)]
    ctrl4 = pmc.make_controls(SR, 4)
    y, _ = pmc.render(SR, ctrl4, warm_state.repeat(1, 4).contiguous(),
                      torch.from_numpy(np.stack(cols, axis=1)))
    y = y.numpy()
    sens = max(db(y[:, i] - y[:, 0], y[:, 0]) for i in (1, 2, 3))
    out_db = db(got - want, want)
    print(f"engine vs render_events: chain input {in_db:.1f} dB, output "
          f"{out_db:.1f} dB (twins {sens:.1f})")
    assert np.abs(want).max() > 1e-4
    assert out_db < sens + 3.0, \
        f"{out_db:.1f} dB (the chain's 1-ulp sensitivity {sens:.1f} dB)"


def test_event_offset_clipping():
    """Offsets clamp to the next un-rendered block: negative → 0, past the
    block → block − 1."""
    eng = _mk()
    eng.note_on(60, 0.9, offset=-100)
    assert eng._onsets[0] == 0.0
    eng.note_on(64, 0.9, offset=10 * eng.block)
    assert eng._onsets[1] == eng.block - 1
    out = eng.render(eng.block)
    assert out.shape == (BLK,) and np.isfinite(out).all()


def test_restrike_damps_old_instance():
    eng = _mk()
    eng.note_on(60, 0.9)
    eng.render(eng.block)
    eng.note_on(60, 0.5)
    assert np.isfinite(eng._releases[0])
    out = eng.render(eng.block)
    assert np.isfinite(out).all()
    assert eng.active_voice_count() >= 1


def test_arbitrary_render_granularity():
    """render(n) for n not a block multiple buffers a surplus and stitches
    exactly."""
    a = _mk()
    b = _mk()
    for e in (a, b):
        e.note_on(69, 0.8)
    whole = a.render(2 * a.block)
    pieces = np.concatenate([b.render(10), b.render(b.block - 5),
                             b.render(b.block - 5)])
    np.testing.assert_array_equal(whole, pieces)
    assert b.render(0).shape == (0,)


def test_silence_before_any_note():
    """Without notes the bank's zero-amplitude voices emit exact 0.0: the
    block is the chain's own render of silence from the warmed state (the
    settling tail of the tremolo pump after this file's one-block warm-up;
    the reference's 1e-3 bound needs its 0.6 s warm-up, which costs
    minutes on the plain chain)."""
    eng = _mk()
    eng.warm_up()
    want, _ = pmc.render(SR, eng._controls(), eng._chain_state,
                         torch.zeros((BLK, 1)))
    out = eng.render(eng.block)
    assert out.shape == (eng.block,)
    np.testing.assert_array_equal(out, want[:, 0].numpy())
    assert np.abs(out).max() < 0.05


def test_lane_reuse_past_capacity():
    eng = _mk()
    for k in range(fast_engine.LANES + 4):
        note = 40 + (k % 40)
        eng.note_on(note, 0.6)
        eng.note_off(note)
    assert eng._n_used == fast_engine.LANES
    out = eng.render(eng.block)
    assert np.isfinite(out).all()


def test_fast_plugin_adapter_block_semantics():
    plug = FastWurliPlugin(SR, t_tile=T_TILE, device="cpu")
    plug.params.volume = 0.6
    blk = plug.engine.block
    out0 = plug.process(blk, [MidiEvent(0, "note_on", 60, 0.9)])
    out1 = plug.process(blk, [MidiEvent(10, "cc", cc=64, value=127),
                              MidiEvent(20, "note_off", 60)])
    for out in (out0, out1):
        assert out.shape == (blk, 2) and out.dtype == np.float32
        assert np.isfinite(out).all()
        np.testing.assert_array_equal(out[:, 0], out[:, 1])
    assert np.abs(out1).max() > 1e-5        # the note sounded
    assert plug.engine.is_sustain_held()    # CC64 reached the engine
    # note_off under the pedal defers the release
    assert not np.isfinite(plug.engine._releases[0])
    assert plug.engine._volume == 0.6


def test_noise_switch_and_gain_are_controls(monkeypatch):
    """set_noise_enabled(True) on a noise=False engine only switches which
    chain variant later blocks run, after materialising blocks in flight;
    disabling zeroes the gain row; the gain is live."""
    seen = []

    def fake(base_sr, controls, state, x, noise=False):
        a, _b = pmc._CTRL_OFF["noise"]
        seen.append((bool(noise), float(controls[a, 0])))
        return torch.zeros_like(x), state

    monkeypatch.setattr(pmc, "render", fake)
    eng = _mk(lookahead=1, noise_level=2.0)
    eng.render(BLK)
    assert seen == [(False, 0.0), (False, 0.0)] and len(eng._inflight) == 1
    eng.set_noise_enabled(True)
    assert eng._inflight == [] and eng._surplus.size == BLK
    assert eng.render(BLK).shape == (BLK,) and len(seen) == 2
    eng.render(BLK)
    assert seen[2:] == [(True, 2.0), (True, 2.0)]
    eng.set_noise_gain(8.0)
    eng.set_noise_enabled(False)
    eng.render(2 * BLK)
    assert seen[-1] == (True, 0.0)
    ctrl = eng._controls()
    eng.set_volume(eng._volume)
    eng.set_noise_gain(8.0)
    assert eng._controls() is ctrl          # unchanged values: not dirty


def test_precompile_and_reset(monkeypatch):
    """precompile runs one throwaway block on its own states and settles
    the chain; reset returns to the state after a warm-up."""
    eng = _mk()
    eng.precompile()
    assert eng._horizon == 0 and eng._vstate is None
    ref = _mk()
    ref.warm_up()
    assert torch.equal(bits(eng._chain_state), bits(ref._chain_state))
    eng.note_on(60, 0.9)
    eng.set_sustain(True)
    first = eng.render(BLK)
    eng.reset()
    assert (eng._n_used, eng._horizon, eng._ringing, eng._pending) == \
        (0, 0, {}, set())
    assert torch.equal(bits(eng._chain_state), bits(ref._chain_state))
    eng.note_on(60, 0.9)
    np.testing.assert_array_equal(eng.render(BLK), first)


def _host_state(eng):
    return {k: getattr(eng, k) for k in (
        "_midis", "_vels", "_onsets", "_releases", "_n_used", "_ringing",
        "_pending", "_sustain", "_horizon")}


def _same_bookkeeping(jax_eng, eng, what):
    a, b = _host_state(jax_eng), _host_state(eng)
    for k in ("_midis", "_vels", "_onsets", "_releases"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what}: {k}")
    for k in ("_n_used", "_ringing", "_pending", "_sustain", "_horizon"):
        assert a[k] == b[k], (what, k, a[k], b[k])
    assert jax_eng.active_voice_count() == eng.active_voice_count(), what
    assert jax_eng.is_sustain_held() == eng.is_sustain_held()


def test_host_bookkeeping_equals_the_jax_engine(monkeypatch):
    from openwurli_tpu import fast_engine as jfe

    monkeypatch.setattr(jfe, "BLOCK", BLK)
    jeng = JaxFastEngine(SR, interpret=True, t_tile=T_TILE)
    eng = convert.fast_engine_from_numpy(
        SR, t_tile=T_TILE, device="cpu",
        **{k.lstrip("_"): v for k, v in _host_state(jeng).items()})
    assert jeng.block == eng.block == BLK
    rng = np.random.default_rng(5)
    both = (jeng, eng)

    def step(name, *args, **kw):
        for e in both:
            getattr(e, name)(*args, **kw)

    # a scripted opening: re-strike, pedal hold, release under the pedal,
    # pedal lift at an offset, offsets out of range
    step("note_on", 60, 0.9)
    step("note_on", 64, 0.7, offset=17)
    step("note_on", 60, 0.5, offset=-3)
    step("set_sustain", True)
    step("note_off", 64, offset=5)
    step("note_off", 61)
    _same_bookkeeping(jeng, eng, "opening, pedal down")
    step("set_sustain", False, offset=1000)
    step("note_off", 60, offset=7)
    _same_bookkeeping(jeng, eng, "opening")

    # then random traffic past the bank's capacity, the horizon moving
    for k in range(3 * fast_engine.LANES):
        kind = rng.integers(0, 10)
        note = int(rng.integers(36, 60))
        off = int(rng.integers(-4, BLK + 4))
        if kind < 5:
            step("note_on", note, float(rng.uniform(0.2, 1.0)), offset=off)
        elif kind < 8:
            step("note_off", note, offset=off)
        else:
            step("set_sustain", bool(rng.integers(0, 2)), offset=off)
        if k % 3 == 0:
            for e in both:          # what rendering one block does to it
                e._horizon += e.block
        if k % 16 == 0:
            _same_bookkeeping(jeng, eng, f"step {k}")
    _same_bookkeeping(jeng, eng, "end")
    assert eng._n_used == fast_engine.LANES
    assert sorted(set(eng._new_lanes)) == sorted(set(jeng._new_lanes))
