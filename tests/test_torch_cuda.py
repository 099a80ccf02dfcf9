"""The port's CUDA kernels against their plain torch versions on the card.

Marked `gpu`: each test skips (with its reason) where torch sees no CUDA
device, as in CPU-only test runs. On a machine with a card (without jax,
which tests/conftest.py imports, add --noconftest):
    python -m pytest tests/test_torch_cuda.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from openwurli_tpu_torch.kernels import mono_chain as mc
from openwurli_tpu_torch.kernels import probe
from openwurli_tpu_torch.kernels import voice_bank as vb

SR = 44100.0
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def test_voice_bank_kernel_matches_plain(cuda):
    notes = np.repeat(np.arange(36, 68), 4).astype(np.float64)
    vels = np.tile([0.3, 0.6, 0.8, 0.95], 32)
    params, n = vb.make_kernel_params(notes, vels, SR, lanes=256,
                                      device=cuda)
    steady = vb.steady_limits(params)
    out, st = vb.render_voice_bank(params, 1024, steady=steady,
                                   return_state=True)
    ref, ref_st = vb.render_voice_bank_plain(params, 1024, steady=steady,
                                             return_state=True)
    assert torch.equal(out, ref)
    assert torch.equal(st.view(torch.int32), ref_st.view(torch.int32))
    assert out[:, n:].abs().max().item() == 0.0


def test_mono_chain_kernel_matches_plain(cuda):
    s, t = 4, 256
    audio = torch.from_numpy(
        (0.05 * np.sin(np.arange(t) / 10.0)[:, None]
         * np.linspace(0.5, 1.5, s)[None]).astype(np.float32)).to(cuda)
    ctrl = mc.make_controls(SR, s, depth=np.linspace(0, 1, s),
                            character=np.array([0.0, 1.0, 0.0, 1.0]),
                            device=cuda)
    st0 = mc.init_state(SR, s, device=cuda)
    out, st = mc.render(SR, ctrl, st0, audio)
    ref, ref_st = mc.render_chain_plain(mc.pack_consts(SR), ctrl, st0,
                                        audio)
    assert torch.equal(out, ref)
    # bit patterns: the nz_lcg rows hold u32 words, some NaN as floats
    assert torch.equal(st.view(torch.int32), ref_st.view(torch.int32))


def test_voice_bank_events_kernel_matches_plain(cuda):
    """K3: onsets, releases in the three damper registers, an undamped top
    key and padding lanes; output and state bit for bit, across
    min_release, and again from the carried state."""
    notes = [40.0, 60.0, 80.0, 95.0, 50.0]
    vels = [0.9, 0.8, 0.7, 0.6, 0.85]
    params, n = vb.make_kernel_params(
        notes, vels, SR, onsets=[0, 256, 512, 64, 1024],
        releases=[1500, 2000, 1800, 1600, np.inf], device=cuda)
    steady = vb.steady_limits(params)
    out, st = vb.render_voice_bank(params, 2048, steady=steady,
                                   return_state=True)
    ref, ref_st = vb.render_voice_bank_plain(
        params, 2048, steady=steady, return_state=True, events=True)
    assert torch.equal(out, ref)
    assert torch.equal(st.view(torch.int32), ref_st.view(torch.int32))
    assert out[:256, 1].abs().max().item() == 0.0
    assert out[:, n:].abs().max().item() == 0.0
    out2, st2 = vb.render_voice_bank(params, 1024, steady=steady, state=st,
                                     n0=2048, return_state=True)
    ref2, ref_st2 = vb.render_voice_bank_plain(
        params, 1024, steady=steady, state=st, n0=2048, return_state=True,
        events=True)
    assert torch.equal(out2, ref2)
    assert torch.equal(st2.view(torch.int32), ref_st2.view(torch.int32))


def _ragged_params(lanes, events, device):
    rng = np.random.default_rng(lanes)
    notes = rng.integers(36, 100, lanes).astype(np.float64)
    vels = rng.uniform(0.3, 1.0, lanes)
    sched = {}
    if events:
        sched = {"onsets": 16 * rng.integers(0, 64, lanes),
                 "releases": rng.uniform(600.0, 1800.0, lanes)}
    params, _ = vb.make_kernel_params(notes, vels, SR, lanes=lanes,
                                      device=device, **sched)
    return params


@pytest.mark.parametrize("events", [False, True], ids=["K1", "K3"])
def test_voice_bank_ragged_lanes_match_plain(cuda, events):
    """133 lanes, a multiple of neither 4 (lanes per warp) nor 32: the
    last warp holds one lane and three past the end, which take part in
    every sync and store nothing. Output and state bit for bit, across
    min_release and a renorm, then from the carried state."""
    params = _ragged_params(133, events, cuda)
    steady = vb.steady_limits(params)
    state = None
    for n0 in (0, 2048):
        out, st = vb.render_voice_bank(params, 2048, steady=steady,
                                       state=state, n0=n0, return_state=True,
                                       events=events)
        ref, ref_st = vb.render_voice_bank_plain(
            params, 2048, steady=steady, state=state, n0=n0,
            return_state=True, events=events)
        assert torch.equal(out, ref), n0
        assert torch.equal(st.view(torch.int32), ref_st.view(torch.int32))
        state = st


@pytest.mark.parametrize("events", [False, True], ids=["K1", "K3"])
def test_voice_bank_saturated_pickup_matches_plain(cuda, events,
                                                  monkeypatch):
    """The displacement gain raised 60-fold drives the pickup past its knee
    (the soft saturation's tanhf) in the even lanes and not in the odd
    ones: output and state bit for bit."""
    params = _ragged_params(64, events, cuda)
    params[vb.ROW_SCAL, 6, ::2] *= 60.0
    steady = vb.steady_limits(params)
    out, st = vb.render_voice_bank(params, 2048, steady=steady,
                                   return_state=True, events=events)
    past_knee = []
    tanh = torch.tanh

    def recorded_tanh(x):  # the plain pickup's only tanh: (|y| − knee) / …
        past_knee.append((x > 0).any(0))
        return tanh(x)

    monkeypatch.setattr(torch, "tanh", recorded_tanh)
    ref, ref_st = vb.render_voice_bank_plain(
        params, 2048, steady=steady, return_state=True, events=events)
    monkeypatch.undo()
    assert torch.equal(out, ref)
    assert torch.equal(st.view(torch.int32), ref_st.view(torch.int32))
    lanes_past = torch.stack(past_knee).any(0)
    assert 0 < int(lanes_past.sum()) < 64


def test_voice_bank_events_nan_lane_matches_plain(cuda):
    """K3 with a NaN in lane 5's mode-0 tuning and an inf in lane 10's
    mode-3 amplitude: their warp-mates (lanes 4, 6, 7 and 8, 9, 11) and
    every other lane stay bit-identical to the plain version; the two
    lanes go non-finite where the plain version's do."""
    params = _ragged_params(64, True, cuda)
    params[vb.ROW_COSM1, 0, 5] = float("nan")
    params[vb.ROW_AMP, 3, 10] = float("inf")
    steady = vb.steady_limits(params)
    out, st = vb.render_voice_bank(params, 2048, steady=steady,
                                   return_state=True, events=True)
    ref, ref_st = vb.render_voice_bank_plain(
        params, 2048, steady=steady, return_state=True, events=True)
    keep = [v for v in range(64) if v not in (5, 10)]
    assert torch.equal(out[:, keep], ref[:, keep])
    assert torch.equal(st[:, keep].contiguous().view(torch.int32),
                       ref_st[:, keep].contiguous().view(torch.int32))
    for v in (5, 10):
        assert not torch.isfinite(ref[:, v]).all()
        assert torch.equal(torch.isnan(out[:, v]), torch.isnan(ref[:, v]))
        fin = torch.isfinite(ref[:, v])
        assert torch.equal(out[fin, v], ref[fin, v])


def test_trem_preroll_kernel_matches_plain_and_chain(cuda):
    """K4 against its plain version, and against the tremolo rows that K2
    carries after the same number of samples (all but trem_phase, which
    the chain leaves at 4.0 and the next update resets)."""
    ctrl = mc.make_controls(SR, 1, depth=0.7, device=cuda)
    rows, caps = mc.trem_preroll(SR, ctrl, 3, 32)
    ref = mc.trem_preroll_plain(mc.pack_consts(SR), ctrl,
                                mc.init_state(SR, 1, device=cuda), 3, 32)
    assert torch.equal(caps.view(torch.int32), ref.view(torch.int32))
    st = mc.init_state(SR, 1, device=cuda)
    for k in (1, 2):
        _, st = mc.render(SR, ctrl, st, torch.zeros((32, 1), device=cuda))
        for name, a, b, ca, cb in rows:
            if name != "trem_phase":
                assert torch.equal(st[a:b, 0], caps[k, ca:cb]), (k, name)


@pytest.mark.parametrize("n_captures", [1, 5])
@pytest.mark.parametrize("stride", [mc.SUB_BASE, 2 * mc.SUB_BASE, 64])
def test_trem_preroll_kernel_bits_at_strides_and_depths(cuda, stride,
                                                        n_captures):
    """The warp K4 against its plain version, bit for bit as int32: one
    and two updates per interval (the LDR tail runs in every update, and
    gldr_upd_prev comes from the previous interval with one), a longer
    interval (the tail skipped but for the last two), depths 0, 0.7 and
    1, character 0 and 1; from init_state, and from a state with the
    tremolo's node voltages at 0, whose first updates take pnjlim's
    limited branch on some rows."""
    consts = mc.pack_consts(SR)
    kicked = mc.init_state(SR, 1, device=cuda)
    a, b = mc._OFFSETS["trem_vnl"]
    kicked[a:b] = 0.0
    for st in (mc.init_state(SR, 1, device=cuda), kicked):
        for depth in (0.0, 0.7, 1.0):
            for char in (0.0, 1.0):
                ctrl = mc.make_controls(SR, 1, depth=depth, character=char,
                                        device=cuda)
                _rows, caps = mc.trem_preroll(SR, ctrl, n_captures, stride,
                                              state_flat=st)
                ref = mc.trem_preroll_plain(consts, ctrl, st, n_captures,
                                            stride)
                assert torch.equal(caps.view(torch.int32),
                                   ref.view(torch.int32)), (depth, char)


def test_mono_chain_kernel_partial_block_from_injected_state(cuda):
    """K2 as the time-parallel renderer calls it: 72 streams (18 blocks of
    4 warps), each stream starting from the pre-roll's captured tremolo
    rows; then once more from the carried state. Output and state bit for
    bit."""
    s, t = 72, 64
    rng = np.random.default_rng(3)
    audio = torch.from_numpy(
        (0.03 * rng.standard_normal((2 * t, s))).astype(np.float32)).to(cuda)
    ctrl = mc.make_controls(SR, s, depth=0.5, device=cuda)
    st0 = mc.init_state(SR, s, device=cuda)
    rows, caps = mc.trem_preroll(SR, ctrl, s, 32)
    for _name, a, b, ca, cb in rows:
        st0[a:b, :] = caps[:, ca:cb].T
    consts = mc.pack_consts(SR)
    for a_blk in (audio[:t].contiguous(), audio[t:].contiguous()):
        out, st = mc.render(SR, ctrl, st0, a_blk)
        ref, ref_st = mc.render_chain_plain(consts, ctrl, st0, a_blk)
        assert torch.equal(out, ref)
        assert torch.equal(st.view(torch.int32), ref_st.view(torch.int32))
        st0 = st


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_mono_chain_noise_kernel_matches_plain(cuda):
    """K5: per-stream gains 0-30 over a partial second block of threads,
    output and state (LCG words included) bit for bit, then once more from
    the carried state; the gain-0 stream equals K2 in its output and in
    every row but the nz_ ones."""
    s, t = 72, 64
    rng = np.random.default_rng(5)
    audio = torch.from_numpy(
        (0.03 * rng.standard_normal((2 * t, s))).astype(np.float32)).to(cuda)
    gains = np.linspace(0.0, 30.0, s)
    ctrl = mc.make_controls(SR, s, depth=0.5, noise_level=gains, device=cuda)
    st0 = mc.init_state(SR, s, device=cuda)
    consts = mc.pack_consts(SR)
    launches = mc.NOISE_KERNEL_LAUNCHES, mc.KERNEL_LAUNCHES
    quiet, quiet_st = mc.render(SR, ctrl, st0, audio[:t].contiguous())
    state = st0
    for k, a_blk in enumerate((audio[:t].contiguous(),
                               audio[t:].contiguous())):
        out, st = mc.render(SR, ctrl, state, a_blk, noise=True)
        ref, ref_st = mc.render_chain_plain(consts, ctrl, state, a_blk,
                                            noise=True)
        assert torch.equal(out, ref)
        assert torch.equal(_bits(st), _bits(ref_st))
        if k == 0:
            a, b = mc._OFFSETS["nz_w"][0], mc._OFFSETS["nz_lcg"][0]
            assert torch.equal(out[:, 0], quiet[:, 0])
            assert not torch.equal(out[:, 1:], quiet[:, 1:])
            assert torch.equal(_bits(st[:a, 0]), _bits(quiet_st[:a, 0]))
            assert not torch.equal(_bits(st[b:]), _bits(quiet_st[b:]))
            assert torch.equal(_bits(quiet_st[a:]), _bits(st0[a:]))
        state = st
    assert (mc.NOISE_KERNEL_LAUNCHES, mc.KERNEL_LAUNCHES) == \
        (launches[0] + 2, launches[1] + 1)


def _lanes_inputs(s, t, seed, cuda):
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy(
        (0.05 * rng.standard_normal((t, s))).astype(np.float32)).to(cuda)
    ctrl = mc.make_controls(SR, s, depth=np.linspace(0, 1, s),
                            character=np.tile([0.0, 1.0], s)[:s],
                            noise_level=np.linspace(0.0, 30.0, s),
                            device=cuda)
    return ctrl, mc.init_state(SR, s, device=cuda), audio


@pytest.mark.parametrize("noise", [False, True], ids=["K2", "K5"])
@pytest.mark.parametrize("s,t", [(1, 64), (33, 64), (1024, 16)])
def test_mono_chain_warp_geometry_matches_plain(cuda, noise, s, t):
    """One warp per stream: one stream, a ragged last block of warps, and
    1024 streams, output and state bit for bit."""
    ctrl, st0, audio = _lanes_inputs(s, t, s, cuda)
    out, st = mc.render(SR, ctrl, st0, audio, noise=noise)
    ref, ref_st = mc.render_chain_plain(mc.pack_consts(SR), ctrl, st0,
                                        audio, noise=noise)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(st), _bits(ref_st))


@pytest.mark.parametrize("noise", [False, True], ids=["K2", "K5"])
def test_mono_chain_guard_stream_matches_plain(cuda, noise):
    """Stream 2 of 8 fires the NaN guard (a NaN in its speaker state) and
    takes the power amp's reset path (an inf in its audio): bit for bit
    equal to the plain version, and the other streams equal their run
    without it."""
    ctrl, st0, audio = _lanes_inputs(8, 64, 8, cuda)
    st_g, a_g = st0.clone(), audio.clone()
    st_g[mc._OFFSETS["spk_lpf"][0], 2] = float("nan")
    a_g[32, 2] = float("inf")
    out, st = mc.render(SR, ctrl, st_g, a_g, noise=noise)
    ref, ref_st = mc.render_chain_plain(mc.pack_consts(SR), ctrl, st_g,
                                        a_g, noise=noise)
    assert torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(st), _bits(ref_st))
    assert st[mc._OFFSETS["guard_fires"][0]].tolist() == \
        [0.0, 0.0, 1.0] + [0.0] * 5
    base, base_st = mc.render(SR, ctrl, st0, audio, noise=noise)
    keep = [0, 1, 3, 4, 5, 6, 7]
    assert torch.equal(_bits(out[:, keep]), _bits(base[:, keep]))
    assert torch.equal(_bits(st[:, keep]), _bits(base_st[:, keep]))


@pytest.mark.parametrize("name", list(probe.PROBES))
def test_probe_kernel_matches_plain(cuda, name):
    """P1: every probe of the list at its own size, a few iterations, at
    128, 64 and 1 threads per block: the output row and aux bit for bit."""
    _label, body, sub, lan, depth, mat, _iters = probe.PROBES[name]
    ref, ref_aux = probe.probe_plain(body, 7, sub, lan, depth, x0=0.37,
                                     mat=mat, device=cuda)
    for threads in (128, 64, 1):
        out, aux = probe.run_probe(body, 7, sub, lan, depth, x0=0.37,
                                   mat=mat, threads=threads, device=cuda)
        assert torch.equal(_bits(out), _bits(ref)), threads
        assert (aux is None) == (ref_aux is None)
        if aux is not None:
            assert torch.equal(_bits(aux), _bits(ref_aux)), threads


# ── the f64 engine's kernels (E1, E2, E3) ──


def _same_bits(a, b):
    """Equal bit patterns (NaN equal to NaN)."""
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        view = torch.int64 if a.dtype == torch.float64 else torch.int32
        return torch.equal(na, nb) and torch.equal(
            a[~na].contiguous().view(view), b[~nb].contiguous().view(view))
    return torch.equal(a, b)


def _engine(cuda):
    from openwurli_tpu_torch.engine import Engine

    eng = Engine(SR, device=cuda)
    for k, note in enumerate((48, 55, 60, 64, 67, 72, 93)):
        eng.note_on(note, 0.4 + 0.08 * k)
    eng.note_off(60)
    return eng


def _force_chain_form(monkeypatch, ek, pre, pa, form):
    """render_chain runs E2<pre, pa> in `form` at every width."""
    monkeypatch.setitem(ek.CHAIN_WARP_MAX_ENGINES, (pre, pa),
                        None if form == "warp" else 0)
    monkeypatch.setitem(ek.CHAIN_HALF_MAX_ENGINES, (pre, pa),
                        None if form == "half" else 0)


@pytest.mark.parametrize("form", ["lanes", "thread"])
@pytest.mark.parametrize("engines", [1, 5, 128])
def test_engine_voices_kernel_matches_plain(cuda, engines, form,
                                            monkeypatch):
    """E1 in each form (a cluster of eight blocks per engine, eight
    threads per slot; a block per engine, a thread per slot) over 100
    samples of one engine (no engine axis) or of 5 and 128 distinct ones
    (the chord at its own sample offset in each, a steal slot fading from
    its own count, a NaN in its own live slot): mono and every state row
    bit for bit, one fire in each engine."""
    from openwurli_tpu_torch.kernels import engine as ek

    eng = _engine(cuda)
    for t in (eng.vpar, eng.vst, eng.vsti):
        t[:, ek.MAX_VOICES + 2] = t[:, 2]   # a steal slot, fading
    eng.eng_i[ek.MAX_VOICES + 2] = 150
    args = [eng.vpar, eng.vst, eng.vsti, eng.eng_i]
    if engines == 1:
        args[1][ek.S_S, 4] = float("nan")
    else:
        args = [x.expand(engines, *x.shape).clone() for x in args]
        e = torch.arange(engines, device=cuda)
        args[2][:, ek.I_N] += 37 * e[:, None]
        args[3][:, ek.MAX_VOICES + 2] = 150 - e
        args[1][e, ek.S_S, e % 7] = float("nan")
    a = [x.clone() for x in args]
    b = [x.clone() for x in args]
    monkeypatch.setattr(ek, "VOICES_LANES_MAX_ENGINES",
                        None if form == "lanes" else 0)
    mono = ek.render_voices(*a, 100, eng.fade_len, eng.sample_rate)
    assert ek.VOICES_LAUNCHES_BY_FORM[form] > 0
    ref = ek.voices_plain(*b, 100, eng.fade_len, eng.sample_rate)
    assert _same_bits(mono, ref)
    for x, y in zip(a, b):
        assert _same_bits(x, y)
    fires = a[3][..., ek.EI_FIRES] - args[3][..., ek.EI_FIRES]
    assert (fires == 1).all()
    assert torch.isfinite(mono).all() and (mono.abs().amax(-1) > 0).all()


@pytest.mark.parametrize("case", ["plain", "kick", "nan"])
def test_engine_chain_kernel_matches_plain(cuda, case):
    from openwurli_tpu_torch.kernels import engine as ek

    eng = _engine(cuda)
    mono = ek.render_voices(eng.vpar, eng.vst, eng.vsti, eng.eng_i, 48,
                            eng.fade_len, eng.sample_rate)
    state = eng.chain.clone()
    if case == "kick":
        state[ek.CHAIN_OFF["trem_v"][0]] += 70.0  # the tremolo's BE replay
        mono[7] = 30.0
    elif case == "nan":
        state[ek.CHAIN_OFF["spk"][0]] = float("nan")  # guard #2
    a, b = state.clone(), state.clone()
    out = ek.render_chain(eng.params, mono, a, True)
    ref = ek.chain_plain(eng.params, mono, b, True)
    assert _same_bits(out, ref) and _same_bits(a, b)


@pytest.mark.parametrize("models", [("dk", "circuit"), ("melange", "circuit"),
                                    ("dk", "behavioral"),
                                    ("melange", "behavioral")],
                         ids=lambda m: "-".join(m))
def test_engine_batch_kernels_match_plain_and_one_engine(cuda, models):
    """E1 (a cluster of blocks per engine) and E2 (a warp per engine) over
    3 distinct
    engines (rail sag off on one, noise on at gain 3 on another, a NaN
    speaker state on the third) against their batched plain versions,
    and each engine's row against its own one-engine launch."""
    from openwurli_tpu_torch import engine as pe
    from openwurli_tpu_torch.kernels import engine as ek

    engines = []
    for k in range(3):
        e = pe.Engine(SR, device=cuda, preamp_model=models[0],
                      pa_model=models[1])
        for i, note in enumerate((48 + 5 * k, 55 + 3 * k, 64 + k)):
            e.note_on(note, 0.4 + 0.15 * i)
        engines.append(e)
    engines[0].set_rail_sag(False)
    engines[1].set_noise_enabled(True)
    engines[1].set_noise_gain(3.0)
    engines[2].chain[ek.CHAIN_OFF["spk"][0]] = float("nan")
    st = pe.stack_states([e.state for e in engines])
    plain = pe.EngineState(*[x.clone() for x in st])
    _, out = pe.render_states(engines[0], st, 40)
    mono = ek.voices_plain(*plain[:4], 40, engines[0].fade_len, SR)
    ref = ek.chain_plain(engines[0].params, mono, plain.chain,
                         plain.rail_sag, plain.noise_scale)
    assert _same_bits(out, ref)
    for x, y in zip(st, plain):
        assert _same_bits(x, y)
    for k, e in enumerate(engines):
        assert _same_bits(out[k], e.render(40))
        assert _same_bits(st.chain[k], e.chain)
    assert float(out[2, 0]) == 0.0


@pytest.mark.parametrize("models", [("dk", "circuit"), ("melange", "circuit"),
                                    ("dk", "behavioral"),
                                    ("melange", "behavioral")],
                         ids=lambda m: "-".join(m))
@pytest.mark.parametrize("case", ["kick", "nan", "guard-midway"])
def test_engine_chain_forms_agree(cuda, models, case, monkeypatch):
    """E2's instantiations in their three forms: a warp, a thread and a
    half-warp per engine (each band of chain_form), on one engine and on 3 distinct ones
    (rail sag off, noise on at gain 3; the half form's last warp holds one
    engine): output and state bit for bit, and all equal to the plain
    version. "guard-midway": a NaN in mono at sample 4 (the preamp
    resets on each later step) and the volume smoother reaching a NaN
    target at sample 9, which fires guard #2 on every sample from there
    (for the behavioral power amp its rows, moved off rest first, go back
    to rest)."""
    from openwurli_tpu_torch import engine as pe
    from openwurli_tpu_torch.kernels import engine as ek

    pre, pa = models
    engines = []
    for k in range(3):
        e = pe.Engine(SR, device=cuda, preamp_model=pre, pa_model=pa)
        for i, note in enumerate((48 + 5 * k, 55 + 3 * k, 64 + k)):
            e.note_on(note, 0.4 + 0.15 * i)
        engines.append(e)
    engines[1].set_rail_sag(False)
    engines[2].set_noise_enabled(True)
    engines[2].set_noise_gain(3.0)
    st = pe.stack_states([e.state for e in engines])
    mono = ek.render_voices(*[x.clone() for x in st[:4]], 40,
                            engines[0].fade_len, SR)
    state = st.chain.clone()
    if case == "kick":
        state[:, ek.CHAIN_OFF["trem_v"][0]] += 70.0  # BE replays
        mono[:, 7] = 30.0                             # input spikes
    elif case == "nan":
        state[:, ek.CHAIN_OFF["spk"][0]] = float("nan")  # guard #2
    else:
        mono[:, 4] = float("nan")
        a = ek.CHAIN_OFF["sm_volume"][0]
        state[:, a + 1:a + 4] = torch.tensor([float("nan"), 0.0, 10.0],
                                             dtype=torch.float64,
                                             device=cuda)
        if pa == "behavioral":
            lo, hi = ek.CHAIN_OFF["pa_v"][0], ek.CHAIN_OFF["pa_last"][1]
            rest = state[:, lo:hi].clone()
            state[:, lo:hi] += 1.0
    for b in (1, 3):
        runs = []
        for form in ("warp", "thread", "half"):
            _force_chain_form(monkeypatch, ek, pre, pa, form)
            a = state[:b].clone()
            runs.append((ek.render_chain(engines[0].params, mono[:b], a,
                                         st.rail_sag[:b],
                                         st.noise_scale[:b]), a))
        (ow, sw), (ot, stt), (oh, sh) = runs
        assert _same_bits(ow, ot) and _same_bits(sw, stt)
        assert _same_bits(oh, ot) and _same_bits(sh, stt)
        p = state[:b].clone()
        ref = ek.chain_plain(engines[0].params, mono[:b], p,
                             st.rail_sag[:b], st.noise_scale[:b])
        assert _same_bits(ow, ref) and _same_bits(sw, p)
        if case == "guard-midway":
            assert (ow[:, 9:] == 0).all() and (ow[:, :9] != 0).any()
            if pa == "behavioral":
                assert _same_bits(sw[:, lo:hi], rest[:b])


@pytest.mark.parametrize("models", [("dk", "circuit"), ("melange", "circuit"),
                                    ("dk", "behavioral"),
                                    ("melange", "behavioral")],
                         ids=lambda m: "-".join(m))
def test_engine_chain_half_form_diverging_engines(cuda, models,
                                                  monkeypatch):
    """The half form's two engines of a warp diverge: over 7 engines
    (warps (0, 1), (2, 3), (4, 5), (6, -)) engine 1 is kicked (the
    tremolo's BE replay, an input spike that fails the power amp's Newton)
    beside a clean engine 0, engine 2 reaches guard #2 midway beside a
    clean engine 3, engine 5 gets a NaN input beside a kicked engine 4,
    and engine 6 runs alone in its warp. The half form equals the thread
    form and the warp form bit for bit, output and state, and the plain
    version."""
    from openwurli_tpu_torch import engine as pe
    from openwurli_tpu_torch.kernels import engine as ek

    pre, pa = models
    engines = []
    for k in range(7):
        e = pe.Engine(SR, device=cuda, preamp_model=pre, pa_model=pa)
        for i, note in enumerate((48 + 2 * k, 55 + k, 64 + k % 3)):
            e.note_on(note, 0.4 + 0.1 * i)
        engines.append(e)
    engines[3].set_rail_sag(False)
    engines[6].set_noise_enabled(True)
    engines[6].set_noise_gain(3.0)
    st = pe.stack_states([e.state for e in engines])
    mono = ek.render_voices(*[x.clone() for x in st[:4]], 32,
                            engines[0].fade_len, SR)
    state = st.chain.clone()
    for k in (1, 4):
        state[k, ek.CHAIN_OFF["trem_v"][0]] += 70.0
        mono[k, 7 + k] = 30.0
    a = ek.CHAIN_OFF["sm_volume"][0]
    state[2, a + 1:a + 4] = torch.tensor([float("nan"), 0.0, 10.0],
                                         dtype=torch.float64, device=cuda)
    mono[5, 11] = float("nan")
    runs = {}
    for form in ("warp", "thread", "half"):
        _force_chain_form(monkeypatch, ek, pre, pa, form)
        s_ = state.clone()
        runs[form] = (ek.render_chain(engines[0].params, mono, s_,
                                      st.rail_sag, st.noise_scale), s_)
    oh, sh = runs["half"]
    for form in ("warp", "thread"):
        assert _same_bits(oh, runs[form][0]), form
        assert _same_bits(sh, runs[form][1]), form
    p = state.clone()
    ref = ek.chain_plain(engines[0].params, mono, p, st.rail_sag,
                         st.noise_scale)
    assert _same_bits(oh, ref) and _same_bits(sh, p)
    assert (oh[2, 9:] == 0).all() and (oh[0] != 0).any()
    assert torch.isfinite(oh).all()


def test_engine_voices_thread_form_slots(cuda, monkeypatch):
    """E1's thread form (a thread per slot, its libm behind warp votes)
    on 64 engines whose slots mix onsets (fresh notes), damper ramps
    (released notes), steady and free slots and steal fades, a NaN slot
    and an inf slot off each warp's first slot: mono, every state row and
    the fire count bit for bit against the cluster form and voices_plain."""
    from openwurli_tpu_torch.kernels import engine as ek

    eng = _engine(cuda)
    eng.render(700)
    for k, note in enumerate((50, 57, 62, 69, 74)):
        eng.note_on(note, 0.3 + 0.1 * k)   # onsets
    for note in (48, 55, 64):
        eng.note_off(note)                  # damper ramps
    for t in (eng.vpar, eng.vst, eng.vsti):
        t[:, ek.MAX_VOICES + 5] = t[:, 3]   # a steal slot, fading
    eng.eng_i[ek.MAX_VOICES + 5] = 90
    b = 64
    args = [x.expand(b, *x.shape).clone()
            for x in (eng.vpar, eng.vst, eng.vsti, eng.eng_i)]
    e = torch.arange(b, device=cuda)
    args[2][:, ek.I_N] += 29 * e[:, None]
    args[3][:, ek.MAX_VOICES + 5] = 90 - e
    args[1][e, ek.S_S, 1 + e % 6] = float("nan")     # slot 1 + e % 6
    args[1][e, ek.S_C + 2, 33 + e % 5] = float("inf")  # slot 33 + e % 5
    runs = {}
    for form in ("lanes", "thread"):
        monkeypatch.setattr(ek, "VOICES_LANES_MAX_ENGINES",
                            None if form == "lanes" else 0)
        a = [x.clone() for x in args]
        runs[form] = (ek.render_voices(*a, 300, eng.fade_len,
                                       eng.sample_rate), a)
    b_ = [x.clone() for x in args]
    ref = ek.voices_plain(*b_, 300, eng.fade_len, eng.sample_rate)
    for form, (mono, a) in runs.items():
        assert _same_bits(mono, ref), form
        for x, y in zip(a, b_):
            assert _same_bits(x, y), form
    fires = runs["thread"][1][3][:, ek.EI_FIRES] - args[3][:, ek.EI_FIRES]
    assert (fires >= 1).all()
    assert torch.isfinite(ref).all()


def test_tremolo_settle_kernel_matches_plain(cuda):
    """E3 (one warp) from the settle's perturbed start at 64 kHz, and from
    that start with a NaN node (the reset to the DC point), bit for bit."""
    from openwurli_tpu_torch.circuits import tremolo
    from openwurli_tpu_torch.kernels import engine as ek

    sr = 64000.0
    st = ek.osc_flat(tremolo.perturbed_start(tremolo.make_params(sr), cuda))
    nan = st.clone()
    nan[2] = float("nan")
    for start in (st, nan):
        a = ek.settle(sr, start.clone(), 200)
        b = ek.settle_plain(sr, start.clone(), 200)
        assert _same_bits(a, b) and torch.isfinite(a).all()


# ── the render paths' kernels (E4, E5) and E2's other instantiations ──


def _ragged_voices(cuda, g=133):
    """g voices over the calibration grid's range, one with a NaN mode
    amplitude and one with an inf quadrature, in packed columns."""
    from openwurli_tpu_torch import voice
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    rng = np.random.default_rng(8)
    m = rng.integers(33, 97, g).astype(np.float64)
    v = rng.uniform(0.05, 1.0, g)
    vp, det = voice.note_on_params(m, v, SR, mlp_enabled=True)
    vs = voice.init_state(vp, det, v, SR, voice.default_note_seed(m))
    vpar, vst, vsti = kr.voice_columns(vp, vs, cuda)
    vpar[ek.P_AMP + 2, 7] = float("nan")
    vst[ek.S_C, 50] = float("inf")
    return vpar, vst, vsti


def test_voice_render_kernel_matches_plain(cuda):
    from openwurli_tpu_torch.kernels import render as kr

    cols = _ragged_voices(cuda)
    a = [c.clone() for c in cols]
    b = [c.clone() for c in cols]
    out = kr.voice_render(*a, 1100)       # past the renorm at n = 1024
    ref = kr.voice_render_plain(*b, 1100)
    assert out.shape == (1100, 133)
    assert not torch.isfinite(out[:, 7]).all()
    assert _same_bits(out, ref)
    for x, y in zip(a, b):
        assert _same_bits(x, y)


def _staggered(cols, g, seed=19):
    """Copies of the first g packed voice columns, each voice at its own
    sample count (every other one mid-onset, the rest up to past 1024),
    every third voice's damper mid-ramp."""
    from openwurli_tpu_torch import reed
    from openwurli_tpu_torch.kernels import engine as ek

    vpar, vst, vsti = (c[:, :g].clone() for c in cols)
    rng = np.random.default_rng(seed)
    nn = rng.integers(0, 1100, g)
    nn[::2] = rng.integers(0, 60, (g + 1) // 2)
    vsti[ek.I_N] = torch.as_tensor(nn, device=vsti.device)
    rate, mult, ramp, _ = reed.damper_constants(vpar[ek.P_MIDI], SR)
    d = slice(1, None, 3)
    vst[ek.S_DRATE:ek.S_DRATE + 7, d] = rate[d].T
    vst[ek.S_DMULT:ek.S_DMULT + 7, d] = mult[d].T
    vst[ek.S_DRAMP, d] = ramp[d]
    vst[ek.S_DCOUNT, d] = ramp[d] * 0.5
    vsti[ek.I_DACT, d] = 1
    return [vpar, vst, vsti]


@pytest.mark.parametrize("g", [1, 5, 33, 133])
def test_voice_render_kernel_ragged_widths(cuda, g):
    """E4, eight threads per voice and four voices per warp: one voice, a
    partial warp, partial blocks; voices at their own sample counts
    (mid-onset, mid-damper; the NaN and inf voices from 33 on): output
    and state bit for bit."""
    from openwurli_tpu_torch.kernels import render as kr

    cols = _staggered(_ragged_voices(cuda), g)
    a = [c.clone() for c in cols]
    b = [c.clone() for c in cols]
    out = kr.voice_render(*a, 300)
    ref = kr.voice_render_plain(*b, 300)
    assert _same_bits(out, ref)
    for x, y in zip(a, b):
        assert _same_bits(x, y)


@pytest.mark.parametrize("streams", [1, 3, 5, 33, 133])
def test_preamp_scan_dk_kernel_matches_plain(cuda, streams):
    """E5<dk>, a warp per stream, four to a block: one stream, fewer
    streams than a block's warps, partial last blocks; the ragged voices'
    first `streams` columns with an inf stream: output and state bit for
    bit."""
    from openwurli_tpu_torch.kernels import render as kr

    cols = _ragged_voices(cuda)
    x = kr.voice_render(*[c.clone() for c in cols], 600)
    x = x[:, :streams].contiguous()
    x[100:, 9 % streams] = float("inf")  # a stream that resets to DC
    os_sr = 2 * SR
    st = kr.init_dk_state(os_sr, streams, cuda)
    g = torch.full((streams,), 1e-6, dtype=torch.float64, device=cuda)
    g[::5] = 1.0 / 19_000.0
    a, b = st.clone(), st.clone()
    out = kr.preamp_scan("dk", os_sr, x, a, g)
    ref = kr.preamp_scan_plain("dk", os_sr, x, b, g)
    assert _same_bits(out, ref) and _same_bits(a, b)
    # the inf stream's preamp went back to its DC point (the oversampler's
    # branches carry the inf, as in the reference)
    assert torch.isfinite(a[kr.DK_ROWS - 29:]).all()
    assert torch.isfinite(out[:100]).all()


def test_preamp_scan_melange_kernel_matches_plain(cuda):
    from openwurli_tpu_torch.kernels import render as kr

    sr = 88200.0
    t = torch.arange(160, dtype=torch.float64, device=cuda)
    x = 0.002 * torch.sin(t[:, None] * torch.tensor(
        [0.01, 0.05, 0.03, 0.07, 0.02, 0.04], dtype=torch.float64,
        device=cuda))
    x[40, 5] = float("nan")                # the twin resets to DC
    st = kr.init_melange_state(sr, 6, cuda)
    g = torch.tensor([1e-6, 1e-5, 1.0 / 19e3, 1e-6, 1e-5, 1.0 / 19e3],
                     dtype=torch.float64, device=cuda)
    scale = torch.tensor([0.0, 1.0, 30.0, 30.0, 1.0, 0.0],
                         dtype=torch.float64, device=cuda)
    a, b = st.clone(), st.clone()
    out = kr.preamp_scan("melange", sr, x, a, g, scale)
    ref = kr.preamp_scan_plain("melange", sr, x, b, g, scale)
    assert _same_bits(out, ref) and _same_bits(a, b)
    assert float(out[40, 5]) == 0.0 and torch.isfinite(out).all()


@pytest.mark.parametrize("g", [1, 5, 33])
def test_preamp_scan_melange_warp_geometry_matches_plain(cuda, g):
    """E5<melange>, a warp per stream, four to a block: one stream, a
    partial block and a partial last block, seeded millivolt inputs, LDR
    conductances and noise scales 0, 1 and 30, a NaN input on the last
    stream: output and state bit for bit."""
    from openwurli_tpu_torch.kernels import render as kr

    sr = 88200.0
    rng = np.random.default_rng(g)
    x = torch.as_tensor(rng.uniform(-0.003, 0.003, (48, g)), device=cuda)
    x[20, g - 1] = float("nan")
    gl = torch.as_tensor(1.0 / rng.uniform(1e4, 1e6, g), device=cuda)
    scale = torch.as_tensor(rng.choice([0.0, 1.0, 30.0], g), device=cuda)
    st = kr.init_melange_state(sr, g, cuda)
    a, b = st.clone(), st.clone()
    out = kr.preamp_scan("melange", sr, x, a, gl, scale)
    ref = kr.preamp_scan_plain("melange", sr, x, b, gl, scale)
    assert _same_bits(out, ref) and _same_bits(a, b)
    assert float(out[20, g - 1]) == 0.0


def test_engine_chain_melange_warp_on_chord(cuda, monkeypatch):
    """E2<melange, circuit> on a sounding chord with the thermal noise on,
    as the melange plugin runs it: the warp form against the thread form
    and the plain version, output and state bit for bit."""
    from openwurli_tpu_torch.engine import Engine
    from openwurli_tpu_torch.kernels import engine as ek

    eng = Engine(SR, device=cuda, preamp_model="melange")
    eng.set_noise_enabled(True)
    for note in (48, 55, 60, 63, 67, 70):
        eng.note_on(note, 0.95)
    eng.render(300)
    mono = ek.render_voices(eng.vpar, eng.vst, eng.vsti, eng.eng_i, 64,
                            eng.fade_len, eng.sample_rate)
    runs = []
    for form in ("warp", "thread"):
        _force_chain_form(monkeypatch, ek, "melange", "circuit", form)
        a = eng.chain.clone()
        runs.append((ek.render_chain(eng.params, mono, a, True, 1.0), a))
    (ow, sw), (ot, st) = runs
    assert _same_bits(ow, ot) and _same_bits(sw, st)
    b = eng.chain.clone()
    ref = ek.chain_plain(eng.params, mono, b, True, 1.0)
    assert _same_bits(ow, ref) and _same_bits(sw, b)
    assert ow.abs().max() > 1e-3  # sounding


@pytest.mark.parametrize("models", [("melange", "circuit"),
                                    ("dk", "behavioral"),
                                    ("melange", "behavioral")])
@pytest.mark.parametrize("case", ["kick", "nan"])
def test_engine_chain_models_match_plain(cuda, models, case):
    from openwurli_tpu_torch.engine import Engine
    from openwurli_tpu_torch.kernels import engine as ek

    eng = Engine(SR, device=cuda, preamp_model=models[0],
                 pa_model=models[1])
    for k, note in enumerate((48, 55, 60, 64, 67, 72, 93)):
        eng.note_on(note, 0.4 + 0.08 * k)
    mono = ek.render_voices(eng.vpar, eng.vst, eng.vsti, eng.eng_i, 48,
                            eng.fade_len, eng.sample_rate)
    state = eng.chain.clone()
    if case == "kick":
        state[ek.CHAIN_OFF["trem_v"][0]] += 70.0  # the tremolo's BE replay
        mono[7] = 30.0                              # an input spike
    else:
        state[ek.CHAIN_OFF["spk"][0]] = float("nan")  # guard #2
    a, b = state.clone(), state.clone()
    out = ek.render_chain(eng.params, mono, a, True, 30.0)
    ref = ek.chain_plain(eng.params, mono, b, True, 30.0)
    assert _same_bits(out, ref) and _same_bits(a, b)
    if case == "nan":
        assert float(out[0]) == 0.0


# ── the calibration sweep's kernels (E4<tap>, E6) ──


def _calibrate_taps(cuda, notes=(33.0, 45.0, 60.0, 72.0, 84.0, 96.0),
                    vels=(1.0, 64.0, 127.0)):
    """run_calibrate's own host packing for a notes × velocities grid."""
    from openwurli_tpu_torch import tables
    from openwurli_tpu_torch.calib import calibrate

    g, v = (a.ravel() for a in np.meshgrid(
        np.asarray(notes), np.asarray(vels) / 127.0, indexing="ij"))
    return calibrate.pack_taps(g, v, tables.CalibrationConfig(), cuda)


def test_voice_tap_kernel_matches_plain(cuda):
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    cols = list(_calibrate_taps(cuda).cols)
    g = cols[0].shape[1]
    cols[0][ek.P_DS, 3] *= 40.0              # the pickup past its knee
    cols[0][ek.P_AMP + 1, 5] = float("nan")
    cols[1][ek.S_S + 2, 7] = float("inf")
    a = [c.clone() for c in cols]
    b = [c.clone() for c in cols]
    out, reed = kr.voice_tap(*a, 1100)       # past the renorm at n = 1024
    ref, ref_reed = kr.voice_tap_plain(*b, 1100)
    assert out.shape == reed.shape == (1100, g)
    assert not torch.isfinite(out[:, 5]).all()
    assert _same_bits(out, ref) and _same_bits(reed, ref_reed)
    for x, y in zip(a, b):
        assert _same_bits(x, y)
    # the noise rows are never read or written
    assert _same_bits(a[1][ek.S_NAMP:ek.S_Z2 + 1], cols[1][ek.S_NAMP:
                                                           ek.S_Z2 + 1])


@pytest.mark.parametrize("g", [1, 5, 33])
def test_voice_tap_kernel_ragged_widths(cuda, g):
    """E4<tap> as E4 in test_voice_render_kernel_ragged_widths, on
    run_calibrate's packing, the second voice's pickup past its knee."""
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    taps = _calibrate_taps(cuda, notes=tuple(range(33, 97, 2)))
    cols = _staggered(list(taps.cols), g)
    if g > 1:
        cols[0][ek.P_DS, 1] *= 40.0
    a = [c.clone() for c in cols]
    b = [c.clone() for c in cols]
    out, reed = kr.voice_tap(*a, 300)
    ref, ref_reed = kr.voice_tap_plain(*b, 300)
    assert _same_bits(out, ref) and _same_bits(reed, ref_reed)
    for x, y in zip(a, b):
        assert _same_bits(x, y)


def test_pa_speaker_scan_kernel_matches_plain(cuda):
    from openwurli_tpu_torch import di
    from openwurli_tpu_torch.kernels import render as kr

    taps = _calibrate_taps(cuda)
    t2, _ = kr.voice_tap(*taps.cols, 600)
    x = di.preamp_di(t2 * taps.out_scale, SR, device=cuda)[-96:]
    x = x.contiguous()
    x[10:, 4] = float("nan")                 # the power amp resets to DC
    x[20, 9] = float("inf")
    x[:, 11] *= 400.0                        # driven into its rails
    g = x.shape[1]
    for character in (1.0, 0.0):
        st = kr.init_pa_speaker_state(SR, g, cuda)
        a, b = st.clone(), st.clone()
        out = kr.pa_speaker_scan(SR, x, a, 0.4, character)
        ref = kr.pa_speaker_scan_plain(SR, x, b, 0.4, character)
        assert _same_bits(out, ref) and _same_bits(a, b)
        assert torch.isfinite(out).all()


def test_pa_speaker_scan_warp_step_matches_one_thread_step(cuda):
    """E6 (the warp step) and E9 (the one-thread power_amp_step) on the
    same input x · volume² from the same rows: the same power-amp rows, bit
    for bit, at a stream count that leaves a partial block (33)."""
    from openwurli_tpu_torch.kernels import engine as ek
    from openwurli_tpu_torch.kernels import render as kr

    rng = np.random.default_rng(15)
    n, g = 48, 33
    t = np.arange(n)[:, None]
    x = rng.uniform(0.02, 2.0, g) * np.sin(2 * np.pi * 440 * t / SR)
    x[n // 3, 1] = 200.0
    x[n // 4, 2] = np.nan
    x[n // 2:, 3] = np.inf
    x = torch.as_tensor(x, device=cuda)
    st = kr.init_pa_speaker_state(SR, g, cuda)
    a = st.clone()
    kr.pa_speaker_scan(SR, x, a, 0.7, 0.5)
    b = st[:ek.PA_ROWS].clone()
    ek.power_amp_scan(SR, x * 0.7 * 0.7, b)
    assert _same_bits(a[:ek.PA_ROWS], b)


def _dk_scan_inputs(cuda, n, g, seed):
    """Sines of a few millivolts on g ragged streams, each sample at its own
    LDR resistance (log-uniform 500 Ω..2 MΩ, some streams below the 1 kΩ
    clamp), with NaN and inf inputs and a NaN resistance."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    x = rng.uniform(1e-4, 5e-3, g) * np.sin(rng.uniform(0.001, 0.5, g) * t)
    r = np.exp(rng.uniform(np.log(500.0), np.log(2e6), (n, g)))
    x[n // 3, 5 % g] = np.nan
    x[n // 2:, 77 % g] = np.inf
    r[n // 4, 31 % g] = np.nan
    return (torch.as_tensor(x, device=cuda), torch.as_tensor(r, device=cuda))


@pytest.mark.parametrize("streams", [1, 3, 5, 33, 133])
@pytest.mark.parametrize("tap", ["diff", "shadow"])
def test_dk_scan_kernel_matches_plain(cuda, tap, streams):
    """E7, a warp per stream, four to a block, at one stream, fewer than a
    block's warps and partial last blocks: output and state bit for bit."""
    from openwurli_tpu_torch.kernels import render as kr

    sr = 88200.0
    x, r = _dk_scan_inputs(cuda, 700, streams, 7)
    st = kr.init_dk_scan_state(sr, streams, cuda)
    a, b = st.clone(), st.clone()
    out = kr.dk_scan(sr, x, r, a, tap)
    ref = kr.dk_scan_plain(sr, x, r, b, tap)
    assert _same_bits(out, ref) and _same_bits(a, b)
    assert torch.isfinite(a).all()      # every stream reset to its DC point


def test_dk_scan_kernel_from_carried_state(cuda):
    """Two launches carry the state: the same bits as one."""
    from openwurli_tpu_torch.kernels import render as kr

    sr = 44100.0
    x, r = _dk_scan_inputs(cuda, 400, 40, 8)
    one = kr.init_dk_scan_state(sr, 40, cuda)
    two = one.clone()
    whole = kr.dk_scan(sr, x, r, one, "diff")
    head = kr.dk_scan(sr, x[:150].contiguous(), r[:150].contiguous(), two,
                      "diff")
    tail = kr.dk_scan(sr, x[150:].contiguous(), r[150:].contiguous(), two,
                      "diff")
    assert _same_bits(whole, torch.cat([head, tail])) and _same_bits(one, two)


# ── the stage benchmark's kernels (E8, E9) ──


def _tremolo_case(cuda, g=33, seed=29):
    """g tremolo circuits at 88.2 kHz from distinct seeded starts (node
    voltages and LDR envelopes), depths 0, 0.5 and 1 in turn, one circuit
    kicked 70 V off its limit cycle (a Newton failure, the BE replay) and
    one holding a NaN."""
    from openwurli_tpu_torch.kernels import engine as ek

    rng = np.random.default_rng(seed)
    st = ek.init_tremolo_scan_state(88200.0, g, cuda)
    st[:ek.N_T] += torch.as_tensor(rng.uniform(-0.05, 0.05, (ek.N_T, g)),
                                   device=cuda)
    env = ek.CHAIN_OFF["trem_env"][0] - ek.CHAIN_OFF["trem_v"][0]
    st[env] = torch.as_tensor(rng.uniform(0.0, 0.8, g), device=cuda)
    st[0, 5] += 70.0
    st[2, g // 2] = float("nan")
    depth = torch.tensor([(0.0, 0.5, 1.0)[j % 3] for j in range(g)],
                         dtype=torch.float64, device=cuda)
    return st, depth


def _power_amp_case(cuda, n=32, g=33, seed=29):
    """g streams at 88.2 kHz: the stage bench's 0.05 V, 1 kHz sine at
    seeded levels up to 2 V, a 200 V spike, a NaN and an inf stream."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    x = rng.uniform(0.02, 2.0, g) * np.sin(2 * np.pi * 1000 * t / 88200.0)
    x[:, 0] = 0.05 * np.sin(2 * np.pi * 1000 * t[:, 0] / 88200.0)
    x[n // 3, 1] = 200.0
    x[n // 4, 2] = np.nan
    x[n // 2:, 3] = np.inf
    return torch.as_tensor(x, device=cuda)


def test_tremolo_scan_kernel_matches_plain(cuda):
    from openwurli_tpu_torch.kernels import engine as ek

    st, depth = _tremolo_case(cuda)
    a, b = st.clone(), st.clone()
    out = ek.tremolo_scan(88200.0, a, depth, 64)
    ref = ek.tremolo_scan_plain(88200.0, b, depth, 64)
    assert _same_bits(out, ref) and _same_bits(a, b)
    diag = ek.CHAIN_OFF["trem_diag"][0] - ek.CHAIN_OFF["trem_v"][0]
    assert a[diag + 2, 33 // 2] > 0     # the NaN circuit reset (nan_reset)
    assert a[diag + 4, 5] > 0           # the kicked one replayed in BE
    assert torch.isfinite(out).all()


def test_power_amp_scan_kernel_matches_plain(cuda):
    from openwurli_tpu_torch.kernels import engine as ek

    x = _power_amp_case(cuda)
    st = ek.init_power_amp_scan_state(88200.0, x.shape[1], cuda)
    a, b = st.clone(), st.clone()
    out = ek.power_amp_scan(88200.0, x, a)
    ref = ek.power_amp_scan_plain(88200.0, x, b)
    assert _same_bits(out, ref) and _same_bits(a, b)
    assert torch.isfinite(out).all() and float(out.abs().max()) <= 1.0


@pytest.mark.parametrize("g", [1, 3, 5])
def test_power_amp_scan_kernel_ragged_widths(cuda, g):
    """E9, a warp per stream, four to a block: one stream, fewer streams
    than a block's warps, a partial last block; output and state bit for
    bit."""
    from openwurli_tpu_torch.kernels import engine as ek

    x = _power_amp_case(cuda, g=5)[:, :g].contiguous()
    st = ek.init_power_amp_scan_state(88200.0, g, cuda)
    a, b = st.clone(), st.clone()
    out = ek.power_amp_scan(88200.0, x, a)
    ref = ek.power_amp_scan_plain(88200.0, x, b)
    assert _same_bits(out, ref) and _same_bits(a, b)


def test_stage_scans_from_carried_state(cuda):
    """Two launches carry the state: the same bits as one."""
    from openwurli_tpu_torch.kernels import engine as ek

    st, depth = _tremolo_case(cuda, g=40, seed=30)
    two = st.clone()
    whole = ek.tremolo_scan(88200.0, st, depth, 48)
    head = ek.tremolo_scan(88200.0, two, depth, 20)
    tail = ek.tremolo_scan(88200.0, two, depth, 28)
    assert _same_bits(whole, torch.cat([head, tail])) and _same_bits(st, two)
    x = _power_amp_case(cuda, n=40, g=40, seed=30)
    one = ek.init_power_amp_scan_state(88200.0, 40, cuda)
    two = one.clone()
    whole = ek.power_amp_scan(88200.0, x, one)
    head = ek.power_amp_scan(88200.0, x[:15].contiguous(), two)
    tail = ek.power_amp_scan(88200.0, x[15:].contiguous(), two)
    assert _same_bits(whole, torch.cat([head, tail])) and _same_bits(one, two)


@pytest.mark.parametrize("g", [1, 5, 33])
def test_tremolo_scan_kernel_warp_geometry(cuda, g):
    """E8, a warp per circuit, four to a block: one circuit, a partial
    block, eight blocks and a partial one; the kicked circuit (its BE
    replay) and the NaN one off the block's first circuit; output and
    state bit for bit."""
    from openwurli_tpu_torch.kernels import engine as ek

    st, depth = _tremolo_case(cuda, g=40)
    st, depth = st[:, :g].contiguous(), depth[:g].contiguous()
    st[0, 5 % g] += 70.0
    if g >= 5:
        st[2, g - 2] = float("nan")
    a, b = st.clone(), st.clone()
    out = ek.tremolo_scan(88200.0, a, depth, 64)
    ref = ek.tremolo_scan_plain(88200.0, b, depth, 64)
    assert _same_bits(out, ref) and _same_bits(a, b)
    assert torch.isfinite(out).all()


def _thread_form_batch(cuda, cp, kinds, n=12):
    """tests/test_torch_thread_forms.py's engines on the card: "clean" a
    440 Hz sine from rest, "kicked" the tremolo 70 V off and a 30 V spike
    at sample 5, "guard" a NaN in mono at 3 and a NaN volume target from
    6 (guard #2); the depth ramping on "clean", the character on "kicked";
    the power amp's rows off rest."""
    from openwurli_tpu_torch.kernels import engine as ek

    t = np.arange(n)
    sine = 0.3 * np.sin(2 * np.pi * 440 * t / SR)
    states, monos = [], []
    for kind in kinds:
        state = ek.init_chain(cp, volume=0.8, depth=0.7, character=0.3)
        mono = torch.from_numpy(sine.copy())
        name = {"clean": "sm_depth", "kicked": "sm_char"}.get(kind)
        if name:
            a, _ = ek.CHAIN_OFF[name]
            state[a + 1:a + 4] = torch.tensor([0.2, -0.05, 10.0],
                                              dtype=torch.float64)
        if kind == "kicked":
            state[ek.CHAIN_OFF["trem_v"][0]] += 70.0
            mono[5] = 30.0
        elif kind == "guard":
            mono[3] = float("nan")
            a, _ = ek.CHAIN_OFF["sm_volume"]
            state[a + 1:a + 4] = torch.tensor([float("nan"), 0.0, 6.0],
                                              dtype=torch.float64)
        states.append(state)
        monos.append(mono)
    state = torch.stack(states).to(cuda)
    lo, hi = ek.CHAIN_OFF["pa_v"][0], ek.CHAIN_OFF["pa_last"][1]
    state[:, lo:hi] += 1.0
    b = len(kinds)
    noise = 30.0 if cp.preamp_model == "melange" else 0.0
    return (state.contiguous(), torch.stack(monos).to(cuda).contiguous(),
            torch.tensor([k != 1 for k in range(b)], device=cuda),
            torch.full((b,), noise, dtype=torch.float64, device=cuda))


@pytest.mark.parametrize("b", [1, 2, 3, 4, 33, 8192])
@pytest.mark.parametrize("pre", ["dk", "melange"])
def test_engine_chain_behavioral_thread_form(cuda, pre, b, monkeypatch):
    """E2's behavioral thread form (each step's values in registers, the
    engine's rows in shared memory) against the plain version bit for bit,
    output and every chain row, on clean, kicked and guard #2 engines in
    turn: at 1-4 engines, at 33 (a partial second block) and at 8192 × 32
    (the first 128 engines replayed by the plain version)."""
    from openwurli_tpu_torch.kernels import engine as ek

    cp = ek.chain_params(SR, pre, "behavioral")
    kinds = [("clean", "kicked", "guard")[(k + 2) % 3] for k in range(b)]
    state, mono, sag, scale = _thread_form_batch(cuda, cp, kinds,
                                                 n=32 if b > 33 else 12)
    _force_chain_form(monkeypatch, ek, pre, "behavioral", "thread")
    s_ = state.clone()
    out = ek.render_chain(cp, mono, s_, sag, scale)
    m = min(b, 128)
    p = state[:m].clone()
    ref = ek.chain_plain(cp, mono[:m].contiguous(), p, sag[:m].contiguous(),
                         scale[:m].contiguous())
    assert _same_bits(out[:m], ref) and _same_bits(s_[:m], p)
    assert torch.isfinite(out).all()
    if b > m:   # the copies of each kind agree with their first
        for k in range(3):
            assert _same_bits(out[k::3], out[k:k + 1].expand_as(out[k::3]))
