"""The song path's pieces of the PyTorch port, without the chain: the
tremolo pre-roll (K4, plain version) and the glue of
`render_events_parallel` / `render_midi_file`, each against its JAX
counterpart on the same NumPy inputs.

Gates: the pre-roll's captures within 5e-6 absolute of the JAX kernel in
interpret mode (the reference's own gate against its serial updates) and
exactly equal to the port's own serial `trem_update` loop; host-side
helpers (`schedule_events`, `_voice_lifetimes`, `preroll_rows`, MIDI and
WAV I/O) exactly equal; `_scatter_voices` exactly equal to a float32
NumPy shift-and-sum in voice order and to the reference's scan;
`_segment_windows` exactly equal; `_song_voices` within 2e-6 absolute of
the port's own kernel render shifted in NumPy (the reference's gate) and
within −80 dB of the reference's `_song_voices`.
"""

import filecmp
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openwurli_tpu
import openwurli_tpu_torch
from openwurli_tpu import fast as jfast
from openwurli_tpu.io import midi_file as jmidi
from openwurli_tpu.io import wav as jwav
from openwurli_tpu.kernels import mono_chain as mc
from openwurli_tpu.kernels import voice_bank as vb
from openwurli_tpu_torch import convert, fast
from openwurli_tpu_torch.io import midi_file, wav
from openwurli_tpu_torch.kernels import mono_chain as pmc
from openwurli_tpu_torch.kernels import voice_bank as pvb

torch.set_num_threads(1)

SR = 44100.0


# ── K4: the tremolo pre-roll ──


@pytest.fixture(scope="module")
def preroll():
    """3 captures at stride 64, depth 0.5: (reference caps, port caps)."""
    ctrl = mc.make_controls(SR, 1, volume=0.5, depth=0.5)
    rows, caps = mc.trem_preroll(SR, ctrl, n_captures=3, capture_stride=64,
                                 interpret=True)
    pctrl = pmc.make_controls(SR, 1, volume=0.5, depth=0.5)
    before = (pmc.PREROLL_PLAIN_CALLS, pmc.PREROLL_KERNEL_LAUNCHES)
    prows, pcaps = pmc.trem_preroll(SR, pctrl, 3, 64)
    assert (pmc.PREROLL_PLAIN_CALLS, pmc.PREROLL_KERNEL_LAUNCHES) == \
        (before[0] + 1, before[1])
    return rows, caps, prows, pcaps, pctrl


def test_preroll_rows_equal_reference(preroll):
    rows, _caps, prows, _pcaps, _ = preroll
    assert convert.check_preroll_rows(rows) == prows
    assert prows == pmc.preroll_rows() == [tuple(r) for r in
                                           mc.preroll_rows()]
    assert pmc.TREM_STATE == mc.TREM_STATE
    assert prows[-1][-1] == pmc.PREROLL_ROWS == 19
    with pytest.raises(ValueError):
        convert.check_preroll_rows(rows[:-1])


def test_preroll_matches_jax_kernel(preroll):
    _rows, caps, _prows, pcaps, _ = preroll
    assert pcaps.shape == (3, 19) and pcaps.dtype == torch.float32
    np.testing.assert_allclose(pcaps.numpy(), caps, atol=5e-6)
    carried = convert.preroll_captures_from_numpy(caps)
    assert carried.shape == (3, 19)
    with pytest.raises(ValueError):
        convert.preroll_captures_from_numpy(caps[:, :18])


def test_preroll_equals_serial_updates_exactly(preroll):
    """caps[k] is the state entering base sample k·stride, before that
    sample's update: the port's own trem_update applied serially."""
    _rows, _caps, _prows, pcaps, pctrl = preroll
    consts = pmc.pack_consts(SR)
    c = pmc.chain_tensors(consts, pctrl)
    sc = pmc.scalar_tensors(consts)
    full = pmc.unpack_state(pmc.init_state(SR, 1))
    st = {n: full[n] for n in pmc.TREM_STATE}
    for k in range(3):
        ref = torch.cat([st[n][:, 0] for n in pmc.TREM_STATE])
        assert torch.equal(pcaps[k], ref), k
        for _ in range(64 // pmc.SUB_BASE):
            st = pmc.trem_update(c, sc, st)


def test_preroll_takes_stream_zero_and_rejects_bad_strides():
    ctrl = pmc.make_controls(SR, 2, depth=np.array([0.5, 0.9]))
    _, a = pmc.trem_preroll(SR, ctrl, 2, 8)
    _, b = pmc.trem_preroll(SR, ctrl[:, :1].contiguous(), 2, 8)
    assert torch.equal(a, b)
    for stride in (0, 3, -2):
        with pytest.raises(ValueError):
            pmc.trem_preroll(SR, ctrl, 2, stride)
    with pytest.raises(ValueError):
        pmc.trem_preroll(SR, ctrl, 0, 8)
    with pytest.raises(TypeError):
        pmc.trem_preroll(SR, ctrl.double(), 2, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        pmc.trem_preroll(SR, ctrl.to("meta"), 2, 8,
                         state_flat=pmc.init_state(SR, 1).to("meta"))


# ── the scheduler ──


def test_schedule_events_sustain_semantics():
    ev = [
        midi_file.Event(0.00, "on", 60, 100),
        midi_file.Event(0.05, "sustain", 0, 127),   # pedal down
        midi_file.Event(0.10, "off", 60, 0),        # held by the pedal
        midi_file.Event(0.15, "on", 64, 90),
        midi_file.Event(0.20, "on", 60, 80),        # re-strike damps voice 0
        midi_file.Event(0.25, "off", 64, 0),        # held by the pedal
        midi_file.Event(0.30, "sustain", 0, 0),     # pedal up: releases 64
        midi_file.Event(0.50, "off", 60, 0),        # releases voice 2
    ]
    midis, vels, onsets, releases = fast.schedule_events(ev, 1000.0)
    assert midis.tolist() == [60.0, 64.0, 60.0]
    assert vels.tolist() == [100 / 127.0, 90 / 127.0, 80 / 127.0]
    assert onsets.tolist() == [0.0, 150.0, 200.0]
    assert releases.tolist() == [200.0, 300.0, 500.0]


def _random_events(rng, n):
    t = np.cumsum(rng.uniform(0.0, 0.1, n))
    kinds = rng.choice(["on", "off", "sustain"], n, p=[0.45, 0.4, 0.15])
    notes = rng.integers(58, 63, n)
    return [(float(ti), str(k), int(nt), int(rng.integers(0, 128)))
            for ti, k, nt in zip(t, kinds, notes)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_events_equals_reference(seed):
    raw = _random_events(np.random.default_rng(seed), 200)
    got = fast.schedule_events([midi_file.Event(*e) for e in raw], SR)
    want = jfast.schedule_events([jmidi.Event(*e) for e in raw], SR)
    assert len(got[0]) > 20
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ── lifetimes, scatter, segment windows ──


def test_voice_lifetimes_reference_semantics():
    t_total = int(60 * SR)
    never = pvb.NEVER
    midis = np.array([60.0, 60.0, 36.0, 95.0, 95.0])
    onsets = np.zeros(5)
    releases = np.array([11.0 * SR, never, never, 11.0 * SR, never])
    lens = fast._voice_lifetimes(midis, onsets, releases, SR, t_total)
    assert 11.0 * SR < lens[0] < 12.5 * SR   # the damper tail renders
    assert 10.0 * SR < lens[1] < 20.0 * SR   # natural decay, no 10 s cut
    assert 25.0 * SR < lens[2] < 28.0 * SR   # 3 dB/s floor
    assert lens[3] == lens[4]                # undamped top key
    assert (lens <= t_total).all()
    assert fast.VOICE_TIMEOUT_S == jfast.VOICE_TIMEOUT_S


def test_voice_lifetimes_equal_reference():
    rng = np.random.default_rng(3)
    n = 200
    t_total = int(40 * SR)
    midis = rng.integers(30, 100, n).astype(np.float64)
    onsets = np.round(rng.uniform(0, 38 * SR, n) / 16) * 16
    releases = onsets + rng.uniform(0.05, 15.0, n) * SR
    releases[rng.random(n) < 0.3] = pvb.NEVER
    got = fast._voice_lifetimes(midis, onsets, releases, SR, t_total)
    want = jfast._voice_lifetimes(midis, onsets, releases, SR, t_total)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_scatter_voices_in_bounds_and_in_voice_order():
    """Onsets on both sides of t_total − t_voice (early notes of a song
    longer than the voice window must sound), a voice cut by its length
    and one cut by the song's end."""
    rng = np.random.default_rng(0)
    t_total, t_voice, n = 4096, 512, 6
    voices = rng.standard_normal((t_voice, n)).astype(np.float32)
    onsets = np.array([0, 16, 1024, 3000, 3904, 16], dtype=np.int32)
    lens = np.array([512, 400, 512, 512, 512, 9999], dtype=np.int32)
    got = fast._scatter_voices(torch.from_numpy(voices), onsets, lens,
                               t_total, t_voice)
    assert got.shape == (t_total, 1) and got.dtype == torch.float32
    got = got.numpy()[:, 0]
    want = np.zeros(t_total, dtype=np.float32)
    for i in range(n):  # float32, voice after voice: the port's order
        ln = min(int(lens[i]), t_voice, t_total - int(onsets[i]))
        want[onsets[i]:onsets[i] + ln] += voices[:ln, i]
    assert np.array_equal(got, want)
    ref = np.asarray(jfast._scatter_voices(
        jnp.asarray(voices), jnp.asarray(onsets), jnp.asarray(lens),
        t_total, t_voice))[:, 0]
    assert np.array_equal(got, ref)
    assert np.abs(got[:512]).max() > 0.1
    assert not got[3904 + 192:].any() and got[3904 + 191] != 0.0
    with pytest.raises(ValueError):
        fast._scatter_voices(torch.from_numpy(voices), -onsets - 1, lens,
                             t_total, t_voice)


@pytest.mark.parametrize("t_len,n_seg,seg_len,warm", [
    (300, 3, 128, 64),     # the last segment runs past the song
    (384, 3, 128, 256),    # warm-up longer than a segment
    (512, 4, 128, 32),
])
def test_segment_windows_equal_reference(t_len, n_seg, seg_len, warm):
    audio = np.random.default_rng(1).standard_normal(
        (t_len, 1)).astype(np.float32)
    got = fast._segment_windows(torch.from_numpy(audio), n_seg, seg_len,
                                warm)
    want = np.asarray(jfast._segment_windows(jnp.asarray(audio), n_seg,
                                             seg_len, warm))
    assert got.shape == (warm + seg_len, n_seg) and got.is_contiguous()
    assert np.array_equal(got.numpy(), want)
    assert not got[:warm, 0].any()
    assert np.array_equal(got[warm:, 0].numpy(), audio[:seg_len, 0])


def test_song_voices_match_shifted_single_renders():
    """The voice + scatter stage at 44.1 kHz with a song longer than the
    voice window: against the port's own kernel render shifted and cut in
    NumPy, and against the reference's `_song_voices`."""
    t_total, t_tile = 3072, 32
    midis = np.array([60.0, 64.0])
    vels = np.array([0.9, 0.7])
    onsets = np.array([0.0, 2048.0])
    releases = np.array([600.0, 2600.0])
    rel_local = releases - onsets
    lens = np.minimum(fast._voice_lifetimes(midis, onsets, releases, SR,
                                            t_total), [1000, 800])
    before = pvb.PLAIN_CALLS
    audio = fast._song_voices(midis, vels, onsets, rel_local, lens, t_total,
                              SR, t_tile, device="cpu")
    assert pvb.PLAIN_CALLS == before + 1
    assert audio.shape == (t_total, 1)
    audio = audio.numpy()[:, 0]
    t_voice = -(-int(lens.max()) // t_tile) * t_tile
    assert t_voice == 1024 < t_total - 2048 + 1024
    params, _ = pvb.make_kernel_params(midis, vels, SR, onsets=np.zeros(2),
                                       releases=rel_local)
    v = pvb.render_voice_bank(params, t_voice, events=True).numpy()[:, :2]
    want = np.zeros(t_total, dtype=np.float64)
    for i in range(2):
        o = int(onsets[i])
        ln = min(int(lens[i]), t_total - o)
        want[o:o + ln] += v[:ln, i].astype(np.float64)
    np.testing.assert_allclose(audio, want.astype(np.float32), atol=2e-6)
    assert np.abs(audio[:600]).max() > 1e-4
    assert not audio[1000:2048].any()        # voice 0 cut at its length

    ref = np.asarray(jfast._song_voices(midis, vels, onsets, rel_local, lens,
                                        t_total, SR, True, t_tile))[:, 0]
    db = 20 * np.log10(np.sqrt(np.mean((audio - ref) ** 2))
                       / np.sqrt(np.mean(ref ** 2)))
    assert db < -80.0, f"song voices vs reference {db:.1f} dB"


# ── files ──


def _varlen(n):
    out = [n & 0x7F]
    n >>= 7
    while n:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    return bytes(reversed(out))


def write_midi(path, events, tempo_us=500000, tempo_tick=0, division=480):
    """A format-0 Standard MIDI File: events = [(tick, status, d1, d2)],
    with one tempo change at tempo_tick."""
    tempo = b"\xff\x51\x03" + struct.pack(">I", tempo_us)[1:]
    items = sorted([(tempo_tick, tempo)]
                   + [(tick, bytes([status, d1, d2]))
                      for tick, status, d1, d2 in events],
                   key=lambda item: item[0])
    track = b""
    last = 0
    for tick, body in items:
        track += _varlen(tick - last) + body
        last = tick
    track += _varlen(0) + b"\xff\x2f\x00"
    with open(path, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, division))
        f.write(b"MTrk" + struct.pack(">I", len(track)) + track)


SONG = [(0, 0x90, 60, 100), (120, 0xB0, 64, 127), (240, 0x80, 60, 0),
        (300, 0x90, 64, 90), (480, 0x90, 60, 80), (600, 0x80, 64, 0),
        (720, 0xB0, 64, 0), (900, 0x90, 67, 0), (960, 0x80, 60, 64),
        (1000, 0x90, 72, 110), (1100, 0xB0, 7, 100), (1200, 0x80, 72, 0)]


def test_midi_file_equals_reference(tmp_path):
    path = str(tmp_path / "song.mid")
    write_midi(path, SONG, tempo_us=400000, tempo_tick=300)
    events, total = midi_file.load_events(path)
    jevents, jtotal = jmidi.load_events(path)
    assert total == jtotal and len(events) == len(jevents) >= 10
    for e, j in zip(events, jevents):
        assert (e.time_s, e.kind, e.note, e.velocity) == \
            (j.time_s, j.kind, j.note, j.velocity)
    assert {e.kind for e in events} == {"on", "off", "sustain"}
    assert total == (300 * 500000 + 900 * 400000) / 1e6 / 480
    bad = str(tmp_path / "bad.mid")
    with open(bad, "wb") as f:
        f.write(b"RIFF0000")
    with pytest.raises(ValueError, match="not a MIDI file"):
        midi_file.load_events(bad)


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_wav_round_trip_equals_reference(tmp_path, bits):
    rng = np.random.default_rng(bits)
    x = np.clip(rng.standard_normal((500, 2)) * 0.3, -1, 1)
    mine, theirs = str(tmp_path / "a.wav"), str(tmp_path / "b.wav")
    wav.write_wav(mine, x, 44100, bits=bits)
    jwav.write_wav(theirs, x, 44100, bits=bits)
    assert filecmp.cmp(mine, theirs, shallow=False)
    got, sr = wav.read_wav(theirs)
    want, jsr = jwav.read_wav(theirs)
    assert sr == jsr == 44100 and np.array_equal(got, want)
    mono, _ = wav.read_wav_mono(theirs)
    assert np.array_equal(mono, want.mean(axis=1))
    with pytest.raises(ValueError):
        wav.write_wav(mine, x, 44100, bits=8)


def test_wav_rejects_other_files(tmp_path):
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"MThd" + bytes(40))
    with pytest.raises(ValueError, match="not a WAV file"):
        wav.read_wav(bad)


@pytest.mark.parametrize("name", ["mlp_weights.npz", "tremolo_settled.npz"])
def test_data_files_are_copies_of_the_reference(name):
    ref = os.path.join(os.path.dirname(openwurli_tpu.__file__), "data", name)
    mine = os.path.join(openwurli_tpu_torch.DATA_DIR, name)
    assert os.path.dirname(mine) == os.path.join(
        os.path.dirname(openwurli_tpu_torch.__file__), "data")
    assert filecmp.cmp(ref, mine, shallow=False)
