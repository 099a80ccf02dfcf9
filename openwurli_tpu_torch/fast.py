"""Fast renderers, the port of `openwurli_tpu/fast.py`:

  * `render_grid` / `render_chord`: sustained notes from t=0, S streams at
    once: voice bank (K1) → per-stream voice sum → mono chain (K2);
  * `render_events` / `render_midi_file`: one stream from a MIDI event
    schedule (`schedule_events` resolves the sustain pedal into release
    samples), block-streamed with carried state: voice bank with events
    (K3) → lane sum → mono chain (K2) at S=1, block after block;
  * `render_events_parallel`: the same song with its time axis turned into
    the chain's batch axis: every voice once in its own local time (K3),
    shifted and summed into the song, the tremolo's states at the segment
    starts from the pre-roll (K4), then all segments at once through the
    chain (K2), each behind a warm-up of its preceding audio;
  * `render_grid_sharded`: `render_grid`'s streams split over the ranks of
    a `parallel.mesh` (one device each), gathered on every rank.

Host packing runs in float64 on the CPU; the packed float32 arrays move to
`device`, where the kernels run: the CUDA kernels on a CUDA device, their
plain torch versions on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from openwurli_tpu_torch.io import midi_file
from openwurli_tpu_torch.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import voice_bank as vb


def render_grid(midis, velocities, seconds, sample_rate=44100.0,
                volume=0.5, depth=0.5, character=0.0, warm_seconds=0.0,
                t_tile=None, noise_level=0.0, device="cuda"):
    """Render S streams × V voices: midis/velocities (S, V) → (T, S)
    float32 tensor on `device`.

    Each stream sounds its V notes from t=0 through the full analog
    chain; volume/depth/character may be scalars or (S,). warm_seconds of
    silent chain settle are rendered (and discarded) first. Voice lanes
    are stream-major: lane s·V + j is voice j of stream s. t_tile (default
    the reference's chain tile, 1024) only rounds the warm-up and the
    render up to whole tiles, as the reference does; each kernel runs its
    whole span in one launch."""
    midis = np.atleast_2d(np.asarray(midis, dtype=np.float64))
    vels = np.broadcast_to(np.asarray(velocities, dtype=np.float64),
                           midis.shape)
    s, v = midis.shape
    sr = float(sample_rate)
    t_tile = t_tile or mc.T_TILE
    t_total = int(round(seconds * sr))
    t_pad = -(-t_total // t_tile) * t_tile

    lanes = max(vb.LANES, -(-s * v // vb.LANES) * vb.LANES)
    params, _ = vb.make_kernel_params(midis.reshape(-1), vels.reshape(-1),
                                      sr, lanes=lanes, device=device)
    ctrl = mc.make_controls(sr, s, volume=volume, depth=depth,
                            character=character, noise_level=noise_level,
                            device=device)
    state = mc.init_state(sr, s, device=device)
    noise = bool(np.any(np.asarray(noise_level) > 0.0))
    out = _grid_chain(sr, params, ctrl, state, (s, v), t_pad, t_tile,
                      warm_seconds, vb.steady_limits(params), noise)
    return out[:t_total]


def _grid_chain(sr, params, ctrl, state, shape, t_pad, t_tile,
                warm_seconds, steady, noise=False):
    """A packed grid of `shape` (S, V) streams × voices → (t_pad, S): the
    warm-up of silence (warm_seconds rounded up to whole tiles), K1 with
    `steady` gating, the stream-major lane sum, K2 (K5 with noise)."""
    s, v = shape
    if warm_seconds > 0.0:
        t_warm = -(-int(warm_seconds * sr) // t_tile) * t_tile
        silence = torch.zeros((t_warm, s), dtype=torch.float32,
                              device=params.device)
        _, state = mc.render(sr, ctrl, state, silence, noise=noise)

    voices = vb.render_voice_bank(params, t_pad, events=False, steady=steady)
    audio = voices[:, :s * v].reshape(t_pad, s, v).sum(-1)
    out, _ = mc.render(sr, ctrl, state, audio.contiguous(), noise=noise)
    return out


def render_chord(notes, velocity, seconds, sample_rate=44100.0, **kw):
    """Render one chord: notes (V,) → (T,) float32 mono."""
    out = render_grid(np.asarray(notes, dtype=np.float64)[None, :],
                      velocity, seconds, sample_rate, **kw)
    return out[:, 0]


def schedule_events(events, sample_rate):
    """Resolve a MIDI event stream into per-voice-instance schedules.

    events: iterable of io.midi_file.Event (kind "on" / "off" / "sustain",
    absolute time_s). A note-off while the pedal is held sustains the voice
    until the pedal comes up; re-striking a ringing note damps the old
    voice at the new note-on.

    Returns (midis, vels, onsets, releases) as float64 arrays; onset and
    release are sample indices (release = np.inf when never damped)."""
    sr = float(sample_rate)
    midis, vels, onsets, releases = [], [], [], []
    ringing = {}          # note → lane of the currently ringing instance
    pending = set()       # lanes held only by the sustain pedal
    sustain = False
    for ev in events:
        t = ev.time_s * sr
        if ev.kind == "on":
            old = ringing.get(ev.note)
            if old is not None and releases[old] == np.inf:
                releases[old] = t       # damp the re-struck voice
                pending.discard(old)
            lane = len(midis)
            midis.append(float(ev.note))
            vels.append(ev.velocity / 127.0)
            onsets.append(t)
            releases.append(np.inf)
            ringing[ev.note] = lane
        elif ev.kind == "off":
            lane = ringing.get(ev.note)
            if lane is not None and releases[lane] == np.inf:
                if sustain:
                    pending.add(lane)
                else:
                    releases[lane] = t
        elif ev.kind == "sustain":
            held = ev.velocity >= 64
            if sustain and not held:
                for lane in pending:
                    releases[lane] = t
                pending.clear()
            sustain = held
    return (np.asarray(midis), np.asarray(vels), np.asarray(onsets),
            np.asarray(releases))


def _chain_tile(t_tile):
    """The tile that block, segment and warm-up lengths are rounded to. A
    multiple of 16 keeps every carried voice-bank block on the jitter grid
    and every chain call even (the chain alternates its tremolo update on
    the call-local sample index)."""
    t_tile = int(t_tile or mc.T_TILE)
    if t_tile <= 0 or t_tile % vb.JITTER_SUBSAMPLE:
        raise ValueError(f"t_tile={t_tile} must be a positive multiple of "
                         f"{vb.JITTER_SUBSAMPLE}")
    return t_tile


def render_events(midis, velocities, onsets, releases, seconds,
                  sample_rate=44100.0, volume=0.5, depth=0.5,
                  character=0.0, warm_seconds=0.6, block_seconds=2.0,
                  t_tile=None, noise_level=0.0, device="cuda"):
    """Event-scheduled single-stream render → (T,) float32 on `device`.

    midis/velocities/onsets/releases: per-voice-instance schedules (from
    schedule_events, or hand-built); onset/release in samples. Renders in
    carried-state blocks of block_seconds (rounded down to whole tiles):
    memory stays O(block × lanes) whatever the song's length. The warm-up
    rounds UP to whole tiles."""
    sr = float(sample_rate)
    t_tile = _chain_tile(t_tile)
    t_total = int(round(seconds * sr))
    t_blk = max(t_tile, int(round(block_seconds * sr)) // t_tile * t_tile)
    n_blocks = -(-t_total // t_blk)

    params, _ = vb.make_kernel_params(
        np.asarray(midis, dtype=np.float64),
        np.asarray(velocities, dtype=np.float64), sr,
        onsets=onsets, releases=releases, device=device)
    ctrl = mc.make_controls(sr, 1, volume=volume, depth=depth,
                            character=character, noise_level=noise_level,
                            device=device)
    state = mc.init_state(sr, 1, device=device)
    vstate = vb.init_bank_state(params)
    noise = float(noise_level) > 0.0

    # The schedule's facts are read back once, not once per block.
    events = vb._has_events(params)
    min_rel = vb._min_release(params) if events else vb.NEVER
    steady = vb.steady_limits(params)

    if warm_seconds > 0.0:
        t_warm = -(-int(warm_seconds * sr) // t_tile) * t_tile
        silence = torch.zeros((t_warm, 1), dtype=torch.float32,
                              device=params.device)
        _, state = mc.render(sr, ctrl, state, silence, noise=noise)

    outs = []
    for b in range(n_blocks):
        voices, vstate = vb.render_voice_bank(
            params, t_blk, steady=steady, state=vstate, n0=b * t_blk,
            return_state=True, events=events, min_release=min_rel)
        audio = voices.sum(-1, keepdim=True)
        out, state = mc.render(sr, ctrl, state, audio, noise=noise)
        outs.append(out[:, 0])
    return torch.cat(outs)[:t_total]


VOICE_TIMEOUT_S = 10.0  # a damping voice retires 10 s after its RELEASE


def _voice_lifetimes(midis, onsets, releases, sr, t_total):
    """Per-voice audible lifetime in samples, instance-local.

    A voice ends at its envelope's −80 dB point: natural decay for voices
    that are never damped (0.005·f^1.22 dB/s, floored at 3), or the damper
    decay after release (slowest mode's rate plus the ramp), with the 10 s
    post-release timeout as a hard cap on the damper tail. Voices that are
    never released are not retired at 10 s: they ring to their natural
    decay floor (≤ 80/3 ≈ 27 s)."""
    m = np.asarray(midis, dtype=np.float64)
    f = 440.0 * 2.0 ** ((m - 69.0) / 12.0)
    decay_db_s = np.maximum(0.005 * f ** 1.22, 3.0)
    ring = (80.0 / decay_db_s + 0.1) * sr          # natural −80 dB point
    rel_local = np.asarray(releases, dtype=np.float64) - onsets
    # slowest damper mode: amplitude rate base_rate/s → −80 dB at
    # ln(10^4)/base_rate ≈ 9.22/base_rate, plus the felt ramp-in
    base_rate = np.maximum(55.0 * 2.0 ** ((m - 60.0) / 24.0), 0.5)
    ramp_s = np.select([m < 48.0, m < 72.0], [0.050, 0.025], 0.008)
    tail = np.minimum(ramp_s + 9.22 / base_rate, VOICE_TIMEOUT_S) * sr
    damped = np.logical_and(rel_local < ring, m < 92.0)  # top 5: no damper
    life = np.where(damped, np.minimum(rel_local + tail, ring), ring)
    return np.minimum(t_total - onsets, life).astype(np.int64)


def _song_voices(midis, velocities, onsets, rel_local, lens, t_total, sr,
                 t_tile, device="cuda"):
    """Voices in instance-local time → shift-and-sum → (T, 1) on `device`.

    Every note starts at its own t=0 (voices are independent of each
    other), so one wide voice-bank call of max(lens) samples covers the
    whole song; _scatter_voices then shifts each column to its onset and
    cuts it at its lifetime."""
    n = len(midis)
    t_voice = -(-int(lens.max()) // t_tile) * t_tile
    params, _ = vb.make_kernel_params(
        np.asarray(midis, dtype=np.float64),
        np.asarray(velocities, dtype=np.float64), sr,
        onsets=np.zeros(n), releases=rel_local, device=device)
    voices = vb.render_voice_bank(params, t_voice,
                                  steady=vb.steady_limits(params))
    return _scatter_voices(voices[:, :n], np.asarray(onsets, np.int64),
                           np.asarray(lens, np.int64), t_total, t_voice)


def render_events_parallel(midis, velocities, onsets, releases, seconds,
                           sample_rate=44100.0, volume=0.5, depth=0.5,
                           character=0.0, segments=128, warm_seconds=1.0,
                           t_tile=None, noise_level=0.0, device="cuda"):
    """Event-scheduled single-song render, time-parallel → (T,) float32 on
    `device`.

    render_events is bound by the chain's per-sample recurrence at one
    stream. This renderer turns the song's time axis into the chain's
    batch axis:

      1. voices render in instance-local time, one wide voice-bank call,
         then a shift-and-sum into the song;
      2. the tremolo, the one chain component with unbounded memory (an
         oscillator never forgets its phase), is advanced alone by
         mono_chain.trem_preroll and captured at the segment boundaries;
      3. the chain renders `segments` overlapping time segments as
         parallel streams: each gets warm_seconds of its preceding audio
         as warm-up (preamp bias, power-amp rails and speaker settle well
         inside 1 s) with the captured tremolo state injected, and the
         warm-up samples are discarded.

    Matches render_events(warm_seconds=same) within the chain's
    sensitivity to its own low-order bits; each voice is cut at its
    −80 dB point (_voice_lifetimes), which the serial path never does.
    The warm-up rounds to the nearest sample and then UP to whole tiles,
    at least one: both paths advance the tremolo by warm-up + t, so their
    rounded warm-ups must agree."""
    sr = float(sample_rate)
    t_tile = _chain_tile(t_tile)
    t_total = int(round(seconds * sr))
    n = len(midis)
    if n == 0:
        raise ValueError("render_events_parallel needs at least one note")

    per = -(-t_total // int(segments))
    seg_len = max(t_tile, -(-per // t_tile) * t_tile)
    n_seg = -(-t_total // seg_len)
    warm = -(-int(round(warm_seconds * sr)) // t_tile) * t_tile
    warm = max(t_tile, warm)

    onsets = np.asarray(onsets, dtype=np.float64)
    onsets = np.round(onsets / 16.0) * 16.0
    releases = np.asarray(releases, dtype=np.float64).copy()
    releases[~np.isfinite(releases)] = vb.NEVER

    # 1. voices in instance-local time, shifted and summed on the device
    rel_local = np.where(releases >= vb.NEVER, vb.NEVER, releases - onsets)
    lens = _voice_lifetimes(midis, onsets, releases, sr, t_total)
    ctrl1 = mc.make_controls(sr, 1, volume=volume, depth=depth,
                             character=character, device=device)
    ctrl = mc.make_controls(sr, n_seg, volume=volume, depth=depth,
                            character=character, noise_level=noise_level,
                            device=device)
    state = mc.init_state(sr, n_seg, device=device)
    audio = _song_voices(midis, velocities, onsets, rel_local, lens,
                         t_total, sr, t_tile, device=device)

    # 2. the tremolo's state entering each segment's first sample
    rows, caps = mc.trem_preroll(sr, ctrl1, n_seg, seg_len)
    for _name, a, b, ca, cb in rows:
        state[a:b, :] = caps[:, ca:cb].T

    # 3. all segments at once through the chain
    audio_seg = _segment_windows(audio, n_seg, seg_len, warm)
    out_seg, _ = mc.render(sr, ctrl, state, audio_seg,
                           noise=float(noise_level) > 0.0)
    return out_seg[warm:].T.reshape(-1)[:t_total]


def _scatter_voices(voices, onsets, lens, t_total, t_voice):
    """sum_i shift(voices[:, i], onset_i) → (t_total, 1) float32 on the
    voices' device; voice i contributes its first min(len_i, t_voice,
    t_total − onset_i) samples.

    The voices are added one after the other in index order, so the sum
    does not depend on the run (a scatter-add with atomics would, and the
    chain amplifies an ulp of its input)."""
    song = torch.zeros(t_total, dtype=torch.float32, device=voices.device)
    for i, (onset, ln) in enumerate(zip(onsets, lens)):
        onset = int(onset)
        ln = min(int(ln), t_voice, t_total - onset)
        if onset < 0:
            raise ValueError(f"voice {i}: onset {onset} before the song")
        if ln > 0:
            song[onset:onset + ln] += voices[:ln, i]
    return song.reshape(t_total, 1)


def _segment_windows(audio, n_seg, seg_len, warm):
    """(T, 1) song → (warm + seg_len, n_seg) overlapping segment columns:
    column k holds samples [k·seg_len − warm, (k+1)·seg_len), zeros
    outside the song."""
    flat = audio.reshape(-1)
    zeros = flat.new_zeros
    flat = torch.cat([zeros(warm), flat,
                      zeros(max(n_seg * seg_len - flat.shape[0], 0))])
    cols = flat.unfold(0, warm + seg_len, seg_len)[:n_seg]
    return cols.T.contiguous()


def render_midi_file(path, sample_rate=44100.0, tail_seconds=2.0,
                     parallel=True, **kw):
    """Render a Standard MIDI File → (T,) float32 on `device`.

    parallel=True takes render_events_parallel, False the serial
    block-streamed render_events; **kw goes to the renderer."""
    events, total_s = midi_file.load_events(path)
    midis, vels, onsets, releases = schedule_events(events, sample_rate)
    if midis.size == 0:
        return torch.zeros(0, dtype=torch.float32,
                           device=kw.get("device", "cuda"))
    render = render_events_parallel if parallel else render_events
    return render(midis, vels, onsets, releases, total_s + tail_seconds,
                  sample_rate, **kw)


def render_grid_sharded(mesh, midis, velocities, seconds,
                        sample_rate=44100.0, volume=0.5, depth=0.5,
                        character=0.0, warm_seconds=0.0, t_tile=None):
    """Multi-device batch render: the S streams of `render_grid` split
    over the ranks of `mesh` (`parallel.mesh.make_mesh`), S a multiple of
    the mesh's size. Returns (T, S) float32 on every rank.

    Each rank packs its own block of streams (lanes rounded up to 128 as
    a standalone render of that block rounds them) and takes its rows of
    the controls and the initial state packed for all S streams, since
    volume, depth and character may be (S,). Then the optional warm-up, K1,
    the lane sum and K2 on its device, and an `all_gather` of the blocks.
    The voice bank's steady gating uses the largest limits over all ranks
    (an `all_reduce` MAX), as the reference's shard_map body must; later
    gating leaves every voice's output bit for bit as it was."""
    from openwurli_tpu_torch.parallel import mesh as meshlib

    midis = np.atleast_2d(np.asarray(midis, dtype=np.float64))
    vels = np.broadcast_to(np.asarray(velocities, dtype=np.float64),
                           midis.shape)
    s, v = midis.shape
    rows = meshlib.block(mesh, s)
    s_loc = rows.stop - rows.start
    sr = float(sample_rate)
    t_tile = t_tile or mc.T_TILE
    t_total = int(round(seconds * sr))
    t_pad = -(-t_total // t_tile) * t_tile
    device = mesh.device

    lanes = max(vb.LANES, -(-s_loc * v // vb.LANES) * vb.LANES)
    params, _ = vb.make_kernel_params(
        midis[rows].reshape(-1), vels[rows].reshape(-1), sr, lanes=lanes,
        device=device)
    ctrl = mc.make_controls(sr, s, volume=volume, depth=depth,
                            character=character, device=device)
    ctrl = ctrl[:, rows].contiguous()
    state = mc.init_state(sr, s, device=device)[:, rows].contiguous()
    steady = meshlib.all_reduce_max(mesh, vb.steady_limits(params))
    out = _grid_chain(sr, params, ctrl, state, (s_loc, v), t_pad, t_tile,
                      warm_seconds, steady)
    return meshlib.all_gather(mesh, out[:t_total].contiguous(), dim=1)
