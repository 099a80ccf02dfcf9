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


def test_engine_voices_kernel_matches_plain(cuda):
    from openwurli_tpu_torch.kernels import engine as ek

    eng = _engine(cuda)
    for t in (eng.vpar, eng.vst, eng.vsti):
        t[:, ek.MAX_VOICES + 2] = t[:, 2]   # a steal slot, fading
    eng.eng_i[ek.MAX_VOICES + 2] = 150
    eng.vst[ek.S_S, 4] = float("nan")
    args = (eng.vpar, eng.vst, eng.vsti, eng.eng_i)
    a = [x.clone() for x in args]
    b = [x.clone() for x in args]
    mono = ek.render_voices(*a, 100, eng.fade_len, eng.sample_rate)
    ref = ek.voices_plain(*b, 100, eng.fade_len, eng.sample_rate)
    assert _same_bits(mono, ref)
    for x, y in zip(a, b):
        assert _same_bits(x, y)
    assert int(a[3][ek.EI_FIRES]) == 1


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


def test_tremolo_settle_kernel_matches_plain(cuda):
    from openwurli_tpu_torch.circuits import tremolo
    from openwurli_tpu_torch.kernels import engine as ek

    sr = 64000.0
    st = ek.osc_flat(tremolo.perturbed_start(tremolo.make_params(sr), cuda))
    a = ek.settle(sr, st.clone(), 200)
    b = ek.settle_plain(sr, st.clone(), 200)
    assert _same_bits(a, b)


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


def test_preamp_scan_dk_kernel_matches_plain(cuda):
    from openwurli_tpu_torch.kernels import render as kr

    cols = _ragged_voices(cuda)
    x = kr.voice_render(*[c.clone() for c in cols], 600)
    x[100:, 9] = float("inf")            # a stream that resets to DC
    os_sr = 2 * SR
    st = kr.init_dk_state(os_sr, 133, cuda)
    g = torch.full((133,), 1e-6, dtype=torch.float64, device=cuda)
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
