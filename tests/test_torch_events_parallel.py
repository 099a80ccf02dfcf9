"""The PyTorch port's time-parallel song path as a whole:
`fast.render_events_parallel` on the CPU against the JAX function, tiny
(44.1 kHz, t_tile=32: three segments of 64 samples behind a 32-sample
warm-up), and `fast.render_midi_file` end to end on a MIDI file written
here. Helpers, manner and gates as in `test_torch_events_chain.py`: the
JAX function runs with its own voice-bank and pre-roll kernels (interpret
mode), its one chain call is caught on its way in and run through
`render_cpu` together with three 1-ulp twins.

Checks for render_events_parallel:
  * the composition, exactly, from the port's own pieces: the chain call
    gets the port's controls, `init_state` with the port's own pre-roll
    captures injected by `preroll_rows`, and the segment windows of the
    port's own `_song_voices`; the output is that call's output behind the
    warm-up, segment after segment;
  * the injected tremolo rows against the reference's, within 5e-6
    absolute (the pre-roll's gate); every other state row bit for bit;
  * the segment windows entering the chain against the reference's,
    ≤ −80 dB relative RMS;
  * the output: no worse than the reference's worst 1-ulp twin + 3 dB.
"""

import numpy as np
import pytest
import torch

from openwurli_tpu import fast as jfast
from openwurli_tpu_torch import fast
from openwurli_tpu_torch.io import midi_file
from openwurli_tpu_torch.kernels import mono_chain as pmc
from openwurli_tpu_torch.kernels import voice_bank as pvb
from test_torch_events_chain import (MIDIS, ONSETS, RELEASES, SR, SUM_DB,
                                     T_TILE, VELS, bits, chain_with_twins,
                                     db, jax_chain_calls, spy_on_port_chain)
from test_torch_song import SONG, write_midi

torch.set_num_threads(1)

WARM, SEG_LEN, N_SEG, T_TOTAL = 32, 64, 3, 190


def test_render_events_parallel_matches_jax_composition(monkeypatch):
    kw = dict(seconds=T_TOTAL / SR, sample_rate=SR, volume=0.5, depth=0.5,
              character=0.0, segments=N_SEG, warm_seconds=WARM / SR,
              t_tile=T_TILE)
    (ref_ctrl, ref_state, ref_x), = jax_chain_calls(
        monkeypatch, jfast.render_events_parallel, MIDIS, VELS, ONSETS,
        RELEASES, interpret=True, **kw)
    assert ref_x.shape == (WARM + SEG_LEN, N_SEG)
    ref, twins = chain_with_twins(ref_ctrl, ref_state, ref_x)

    def song(y):  # drop the warm-up, lay the segments end to end
        return y[WARM:].T.reshape(-1)[:T_TOTAL]

    ref, twins = song(ref), [song(tw) for tw in twins]

    calls = spy_on_port_chain(monkeypatch)
    before = (pvb.PLAIN_CALLS, pmc.PLAIN_CALLS, pmc.PREROLL_PLAIN_CALLS,
              pvb.KERNEL_LAUNCHES + pmc.KERNEL_LAUNCHES
              + pmc.PREROLL_KERNEL_LAUNCHES)
    got = fast.render_events_parallel(MIDIS, VELS, ONSETS, RELEASES,
                                      device="cpu", **kw)
    assert got.shape == (T_TOTAL,) and got.dtype == torch.float32
    assert (pvb.PLAIN_CALLS, pmc.PLAIN_CALLS, pmc.PREROLL_PLAIN_CALLS) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    assert pvb.KERNEL_LAUNCHES + pmc.KERNEL_LAUNCHES \
        + pmc.PREROLL_KERNEL_LAUNCHES == before[3]

    # the composition, bit for bit, from the port's own pieces
    (ctrl, state, x, (y, _)), = calls
    assert torch.equal(ctrl, pmc.make_controls(SR, N_SEG, volume=0.5,
                                               depth=0.5, character=0.0))
    rows, caps = pmc.trem_preroll(
        SR, pmc.make_controls(SR, 1, volume=0.5, depth=0.5, character=0.0),
        N_SEG, SEG_LEN)
    want_state = pmc.init_state(SR, N_SEG)
    trem_rows = []
    for _name, a, b, ca, cb in rows:
        want_state[a:b] = caps[:, ca:cb].T
        trem_rows += range(a, b)
    assert torch.equal(bits(state), bits(want_state))
    rel_local = np.where(np.isfinite(RELEASES), RELEASES - ONSETS, pvb.NEVER)
    lens = fast._voice_lifetimes(MIDIS, ONSETS, np.where(
        np.isfinite(RELEASES), RELEASES, pvb.NEVER), SR, T_TOTAL)
    audio = fast._song_voices(MIDIS, VELS, ONSETS, rel_local, lens, T_TOTAL,
                              SR, T_TILE, device="cpu")
    assert torch.equal(x, fast._segment_windows(audio, N_SEG, SEG_LEN, WARM))
    assert torch.equal(got, y[WARM:].T.reshape(-1)[:T_TOTAL])

    # against the reference: state, chain input, output
    other = np.setdiff1d(np.arange(pmc.STATE_ROWS), trem_rows)
    assert np.array_equal(state.numpy()[other].view(np.uint32),
                          ref_state[other].view(np.uint32))
    np.testing.assert_allclose(state.numpy()[trem_rows],
                               ref_state[trem_rows], atol=5e-6)
    assert np.abs(np.diff(ref_state[trem_rows], axis=1)).max() > 1e-4
    x_db = db(x.numpy() - ref_x, ref_x)
    sens = max(db(tw - ref, ref) for tw in twins)
    out_db = db(got.numpy() - ref, ref)
    print(f"render_events_parallel: chain input {x_db:.1f} dB, output "
          f"{out_db:.1f} dB (twins {sens:.1f})")
    assert x_db <= SUM_DB, f"chain input {x_db:.1f} dB"
    assert np.abs(got.numpy()).max() > 1e-4
    assert out_db < sens + 3.0, \
        f"{out_db:.1f} dB (reference sensitivity {sens:.1f} dB)"


def test_render_events_parallel_geometry(monkeypatch):
    """Segment length rounds up to tiles; the warm-up rounds to the nearest
    sample, then up to tiles, and is at least one tile."""
    shapes, noise_flags = [], []

    def fake(base_sr, controls, state, x, noise=False):
        shapes.append(tuple(x.shape))
        noise_flags.append(noise)
        return torch.zeros_like(x), state

    monkeypatch.setattr(pmc, "render", fake)
    for warm_s, segments in ((0.0, 3), (33.4 / SR, 3), (64.6 / SR, 2)):
        out = fast.render_events_parallel(
            MIDIS, VELS, ONSETS, RELEASES, 200 / SR, SR, segments=segments,
            warm_seconds=warm_s, t_tile=T_TILE, device="cpu")
        assert out.shape == (200,)
    assert shapes == [(32 + 96, 3), (64 + 96, 3), (96 + 128, 2)]
    with pytest.raises(ValueError, match="at least one note"):
        fast.render_events_parallel([], [], [], [], 0.01, SR, device="cpu")
    # noise_level > 0 asks the chain for its thermal-noise variant, with
    # the level in the controls' noise row of every segment
    assert noise_flags == [False] * 3
    seen = []
    monkeypatch.setattr(pmc, "render", lambda sr, ctrl, st, x, noise=False: (
        seen.append((noise, ctrl[pmc._CTRL_OFF["noise"][0]].tolist())),
        (torch.zeros_like(x), st))[1])
    fast.render_events_parallel(MIDIS, VELS, ONSETS, RELEASES, 64 / SR, SR,
                                segments=2, warm_seconds=0.0, t_tile=T_TILE,
                                noise_level=1.5, device="cpu")
    assert seen == [(True, [1.5, 1.5])]


def test_render_midi_file_end_to_end(tmp_path):
    """A dozen events with a sustain pedal: file → load_events →
    schedule_events → render_events, equal to render_events on the
    schedule itself; an empty file gives an empty render."""
    path = str(tmp_path / "song.mid")
    # one tick at the default tempo (as the reference's reader, this one
    # lets the default override a tempo set at tick 0), then 1199 ticks
    # at 2 ms per quarter note: 6.04 ms in all
    write_midi(path, SONG, tempo_us=2000, tempo_tick=1)
    events, total_s = midi_file.load_events(path)
    assert len(events) == 11
    assert abs(total_s - (500000 + 1199 * 2000) / 1e6 / 480) < 1e-12
    midis, vels, onsets, releases = fast.schedule_events(events, SR)
    assert len(midis) == 4 and np.isfinite(releases).sum() == 4
    kw = dict(warm_seconds=0.0, block_seconds=128 / SR, t_tile=T_TILE,
              device="cpu")
    tail_s = 90 / SR
    got = fast.render_midi_file(path, SR, tail_seconds=tail_s,
                                parallel=False, **kw)
    t_total = int(round((total_s + tail_s) * SR))
    assert got.shape == (t_total,) and 256 < t_total <= 384
    assert torch.isfinite(got).all() and got.abs().max() > 1e-5
    want = fast.render_events(midis, vels, onsets, releases,
                              total_s + tail_s, SR, **kw)
    assert torch.equal(got, want)

    empty = str(tmp_path / "empty.mid")
    write_midi(empty, [(10, 0xB0, 64, 127)])
    out = fast.render_midi_file(empty, SR, device="cpu")
    assert out.shape == (0,) and out.dtype == torch.float32
