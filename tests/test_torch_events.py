"""Voice bank with events (K3) of the PyTorch port, without the chain: its
plain version against the JAX kernel in interpret mode on the same packed
params, against the f64 voice scan with a note-off, and the variant's own
invariants (frozen pre-onset lanes, trivial schedules, carried blocks, the
schedule facts the wrapper reads).

Gates: per voice −80 dB of its peak against the JAX kernel (the K1 gate);
LCG state rows bit-identical; float state rows within 5e-5 of each row's
peak (XLA fuses multiply-adds and has its own transcendentals, see
`test_torch_voice_bank.py`); −60 dB against the f64 scan (the project-wide
gate). Everything the port computes twice must agree bit for bit: it
contracts no multiply-adds, so the events code path on a trivial schedule
IS the plain path's arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwurli_tpu import voice
from openwurli_tpu.kernels import voice_bank as vb
from openwurli_tpu_torch import convert
from openwurli_tpu_torch.kernels import voice_bank as pvb

torch.set_num_threads(1)

SR = 44100.0
# The reference's own schedule (test_event_kernel_matches_scan_within_60db)
# with earlier releases, plus one voice below midi 48 (50 ms damper ramp)
# and one damped voice at or above 72 (8 ms): every register passes its
# release, and the 8 ms and 25 ms ones the end of their ramps, inside TOTAL.
NOTES = [50.0, 69.0, 95.0, 60.0, 40.0, 76.0]
VELS = [0.9, 0.8, 0.85, 0.7, 0.9, 0.75]
ONSETS = [0, 512, 1024, 2048, 256, 1536]
RELEASES = [2200, 2500, 2600, np.inf, 1000, 2400]
TOTAL = 4096


def _peak_db(got, ref):
    return 20 * np.log10(max(np.abs(got - ref).max(), 1e-300)
                         / np.abs(ref).max())


@pytest.fixture(scope="module")
def reference():
    params, n_active = vb.make_kernel_params(NOTES, VELS, SR, onsets=ONSETS,
                                             releases=RELEASES)
    out, st = vb.render_voice_bank(params, TOTAL, True, return_state=True)
    return np.asarray(params), n_active, np.asarray(out), np.asarray(st)


@pytest.fixture(scope="module")
def port(reference):
    p = convert.voice_params_from_numpy(reference[0])
    out, st = pvb.render_voice_bank(p, TOTAL, return_state=True)
    return out.numpy(), st.numpy()


def test_schedule_crosses_min_release(reference):
    params = reference[0]
    assert vb._min_release(params) == 1000.0
    ramps = params[vb.ROW_EVT, vb.EVT_RAMP, :len(NOTES)]
    ends = np.asarray(RELEASES) + ramps
    assert sorted(set(np.round(ramps / SR, 3))) == [0.008, 0.025, 0.05]
    assert (ends[[0, 1, 5]] < TOTAL).all()


def test_plain_matches_jax_kernel(reference, port):
    _p, n_active, ref_out, _st = reference
    out, _ = port
    for k in range(n_active):
        db = _peak_db(out[:, k], ref_out[:, k])
        assert db < -80.0, f"voice {k} (midi {NOTES[k]}): {db:.1f} dB"


def test_pre_onset_samples_are_exactly_zero(port):
    out, _ = port
    for k, on in enumerate(ONSETS):
        if on:
            assert np.abs(out[:on, k]).max() == 0.0, k
        assert np.abs(out[on:on + 256, k]).max() > 0.0, k
    assert np.abs(out[:, len(NOTES):]).max() == 0.0


def test_state_matches_jax_kernel(reference, port):
    ref_st = reference[3]
    _, st = port
    assert np.array_equal(ref_st[40:48].view(np.uint32),
                          st[40:48].view(np.uint32))
    scale = np.maximum(np.abs(ref_st[:40]).max(axis=1, keepdims=True),
                       1e-30)
    rel = np.abs(st[:40].astype(np.float64) - ref_st[:40]) / scale
    assert rel.max() < 5e-5, rel.max(axis=1)


def test_damper_damps_and_top_key_rings(port):
    out, _ = port
    # midi 76, released at 2400: far below its pre-release level by the end
    pre = np.abs(out[2400 - 256:2400, 5]).max()
    assert np.abs(out[-256:, 5]).max() < 0.1 * pre
    # midi 95 is undamped: its release at 2600 changes nothing (rendered
    # alone with the schedule's min_release, so that the same groups take
    # the legacy stage)
    p, _ = pvb.make_kernel_params([95.0], [0.85], SR, onsets=[1024],
                                  releases=[np.inf])
    free = pvb.render_voice_bank(p, TOTAL, events=True,
                                 min_release=1000.0).numpy()[:, 0]
    assert np.array_equal(out[:, 2], free)


def test_trivial_schedule_equals_plain_path_bit_for_bit():
    params, _ = pvb.make_kernel_params([60.0, 72.0], [0.8, 0.9], SR)
    steady = pvb.steady_limits(params)
    a, st_a = pvb.render_voice_bank(params, 2048, steady=steady,
                                    events=False, return_state=True)
    b, st_b = pvb.render_voice_bank(params, 2048, steady=steady,
                                    events=True, return_state=True)
    assert torch.equal(a, b), (a - b).abs().max()
    assert torch.equal(st_a.view(torch.int32), st_b.view(torch.int32))


def test_state_carry_blocks_are_bit_exact():
    params, _ = pvb.make_kernel_params(
        [55.0, 70.0], [0.85, 0.75], SR, onsets=[0, 1024],
        releases=[3000, np.inf])
    whole = pvb.render_voice_bank(params, 4096).numpy()
    a, st = pvb.render_voice_bank(params, 2048, return_state=True)
    b = pvb.render_voice_bank(params, 2048, state=st, n0=2048)
    stitched = np.concatenate([a.numpy(), b.numpy()])
    assert np.array_equal(whole, stitched), np.abs(whole - stitched).max()


def test_block_stream_exact_for_non_tile_multiple_blocks():
    params, _ = pvb.make_kernel_params(
        [60.0, 72.0], [0.8, 0.7], SR, onsets=np.zeros(2),
        releases=np.array([800.0, pvb.NEVER]))
    mr = pvb._min_release(params)
    whole = pvb.render_voice_bank(params, 1200, events=True,
                                  min_release=mr).numpy()
    state = pvb.init_bank_state(params)
    blocks = []
    for b in range(3):
        o, state = pvb.render_voice_bank(
            params, 400, events=True, min_release=mr, state=state,
            n0=b * 400, return_state=True)
        blocks.append(o.numpy())
    np.testing.assert_array_equal(whole, np.concatenate(blocks, axis=0))


def test_min_release_is_global_not_per_call_default():
    """The fast/legacy split follows the min_release handed in: the
    wrapper's default equals the schedule's earliest release, and another
    value moves the split (the two stages round differently), so a caller
    that splits a schedule must pass the whole schedule's value."""
    params, _ = pvb.make_kernel_params(
        [60.0, 64.0], [0.8, 0.7], SR, onsets=[0, 0], releases=[512, 1024])
    auto = pvb.render_voice_bank(params, 1536)
    same = pvb.render_voice_bank(params, 1536, events=True,
                                 min_release=512.0)
    early = pvb.render_voice_bank(params, 1536, events=True,
                                  min_release=256.0)
    assert torch.equal(auto, same)
    assert torch.equal(auto[:256], early[:256])
    assert not torch.equal(auto[256:512], early[256:512])
    db = _peak_db(early.numpy()[:, 0], auto.numpy()[:, 0])
    assert db < -100.0, db


# name → (midis, onsets, releases, has events)
SCHEDULES = {
    "trivial": ([60.0, 64.0], None, None, False),
    "onset_only": ([60.0, 64.0], [0, 160], None, True),
    "release_only": ([60.0, 64.0], None, [np.inf, 700.5], True),
    # midi 95 is undamped: its release is dropped at pack time
    "top_key_release": ([60.0, 95.0], None, [np.inf, 800.0], False),
    "both": ([60.0, 64.0], [32, 64], [5000, 900], True),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_facts_equal_reference(name):
    """_has_events / _min_release on the stored float32 sentinel
    (999999995904, not NEVER) and on real schedules."""
    midis, onsets, releases, has_events = SCHEDULES[name]
    kw = dict(onsets=onsets, releases=releases)
    ref, _ = vb.make_kernel_params(midis, [0.8, 0.7], SR, **kw)
    ref = np.asarray(ref)
    got, _ = pvb.make_kernel_params(midis, [0.8, 0.7], SR, **kw)
    assert pvb._has_events(got) == vb._has_events(ref)
    assert pvb._min_release(got) == vb._min_release(ref)
    assert pvb._has_events(got) == has_events
    # the same facts from the reference's array carried into the port
    carried = convert.voice_params_from_numpy(ref)
    assert pvb._has_events(carried) == vb._has_events(ref)
    assert pvb._min_release(carried) == vb._min_release(ref)


def _ref_voice(midi, vel, total, release):
    """f64 single-voice render with a note_off at `release`."""
    vp, det = voice.note_on_params(jnp.asarray([midi]), jnp.asarray([vel]),
                                   SR, mlp_enabled=False)
    st = voice.init_state(vp, det, jnp.asarray([vel]), SR,
                          voice.default_note_seed(jnp.asarray([midi])))
    st, head = voice.render(vp, st, release)
    st = voice.note_off(vp, st, SR)
    st, tail = voice.render(vp, st, total - release)
    return np.concatenate([np.asarray(head[:, 0]), np.asarray(tail[:, 0])])


@pytest.mark.parametrize("k", [4, 5])
def test_released_voice_against_f64_scan(port, k):
    """The 50 ms-ramp voice (midi 40) and the 8 ms one (midi 76) against
    voice.render + note_off, from the onset on."""
    out, _ = port
    on, rel = ONSETS[k], int(RELEASES[k])
    ref = _ref_voice(NOTES[k], VELS[k], TOTAL - on, rel - on)
    db = _peak_db(out[on:, k], ref)
    assert db < -60.0, f"voice {k} (midi {NOTES[k]}) vs f64 scan {db:.1f} dB"
