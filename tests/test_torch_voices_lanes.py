"""E1 of `csrc/engine.cu` rehearsed on the CPU: its cluster form
(`engine_voices_kernel`: a cluster of eight blocks per engine, eight
threads per voice slot on E4's group body) and its thread form
(`engine_voices_thread_kernel`: a block per engine, a thread per slot,
`voice_sample_guarded` (the voice step with its cos, pow, exp, sqrt and
tanh behind warp votes), the gates sample by sample and the slot sum
through a shared tile), the source built with g++ against the host shim
of tests/cuda_host_shim.py (a fiber per CUDA thread, a barrier per warp,
per block and per cluster, each block's shared memory its own, the
cluster's blocks at once).

  (a) in one binary, the cluster form equals the thread form bit for
      bit: mono, vst, vsti and eng_i with its fire count, at 1, 2 and 3
      engines and chunk lengths that are no multiple of 8 or of the thread
      form's 32-sample tile;
  (b) the same runs against `voices_plain` within the host-libm
      tolerances below, the integer rows (the gates, the fires, the
      voices' counters) exactly;
  (c) in one binary, the thread form equals the thread form without its
      votes (tools/voice_breakdown.cu's `e1b_thread_kernel<1, false>`,
      `voice_sample` on every slot, as E1's thread form ran before) bit
      for bit, and matches `voices_plain` as in (b).

The binary is tools/voice_breakdown.cu, which includes the source.

Each engine's 128 slots hold seeded notes and velocities, main slots free
and live, steal slots at fades that end mid-group (and one at rest), a
main and a steal slot that turn NaN mid-group (a renorm of a zero mode), a
slot whose amplitude is NaN from the first sample, an inf slot, dampers
mid-ramp and long past, a live main slot that goes quiet and one that
goes silent (released more than 10 s ago) by the chunk's end. Both sides
of (a) use the host's libm, so any difference there would be a fault of
the lanes', the gates' or the cluster's logic.
"""

import ctypes
import os

import cuda_host_shim
import numpy as np
import pytest
import torch

from openwurli_tpu_torch import reed, voice
from openwurli_tpu_torch.kernels import engine as ek
from openwurli_tpu_torch.kernels import render as kr

torch.set_num_threads(1)

SR = 44100.0
FADE_LEN = float(int(SR * 0.005))  # the engine's steal fade, 220 samples
# (engines, samples): no chunk a multiple of 8 or of 32
CASES = ((1, 45), (2, 21), (3, 13))
# The host's cos / pow / exp / sqrt / tanh against torch's: mono within
# TOL_OUT (a sum of 128 slots, each within 1e-13 of its plain value as in
# tests/test_torch_voice_lanes.py), the float state rows within TOL_STATE;
# the integer rows exactly. (a) shows that the thread form, built with
# the same host libm, is the cluster form bit for bit, so it differs from
# the plain version just as much.
TOL_OUT = 1e-12
TOL_STATE = 1e-13


# the thread form without its votes: voice_sample on every slot
HARNESS = r"""
extern "C" int ow_test_voices_thread_unguarded(
    const double* vpar, double* vst, long long* vsti, long long* eng_i,
    double* mono, int n, int b, double fade_len, double sample_rate,
    cudaStream_t) {
  shim::launch(b, SLOTS, e1b_thread_kernel<1, false>, vpar, vst, vsti,
               eng_i, mono, n, fade_len, sample_rate);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not cuda_host_shim.have_gxx():
        pytest.skip("needs g++ to build the kernel against the host shim")
    dll = cuda_host_shim.build(
        os.path.join(os.path.dirname(ek.__file__), "..", "..", "tools",
                     "voice_breakdown.cu"),
        tmp_path_factory.mktemp("voices_lanes"), "voices_lanes",
        extra=HARNESS)
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (dll.ow_engine_voices, dll.ow_engine_voices_thread,
               dll.ow_test_voices_thread_unguarded):
        fn.argtypes = [p, p, p, p, p, i, i, d, d, p]
    return dll


def _bits(x):
    return x.contiguous().view(torch.int64)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _engine(e):
    """Engine e's slot columns (vpar (NPAR, SLOTS), vst, vsti) and eng_i
    (ENG_I,): see the docstring; e seeds its notes and gates."""
    rng = np.random.default_rng(100 + e)
    m = rng.integers(33, 97, ek.SLOTS).astype(np.float64)
    v = rng.uniform(0.1, 1.0, ek.SLOTS)
    vp, det = voice.note_on_params(m, v, SR, mlp_enabled=False)
    vs = voice.init_state(vp, det, v, SR, voice.default_note_seed(m))
    vpar, vst, vsti = kr.voice_columns(vp, vs)
    # each slot at its own sample count, some mid-onset
    vsti[ek.I_N] = torch.as_tensor(rng.integers(0, 3000, ek.SLOTS))
    rate, mult, ramp, _ = reed.damper_constants(torch.as_tensor(m), SR)

    def damper(c, count, done=False):
        vst[ek.S_DRATE:ek.S_DRATE + 7, c] = rate[c]
        vst[ek.S_DMULT:ek.S_DMULT + 7, c] = mult[c]
        vst[ek.S_DRAMP, c] = ramp[c]
        vst[ek.S_DCOUNT, c] = count
        vsti[ek.I_DACT, c] = 1
        vsti[ek.I_DDONE, c] = int(done)

    eng_i = torch.zeros(ek.ENG_I, dtype=torch.int64)
    mv = ek.MAX_VOICES
    eng_i[:mv] = torch.as_tensor(rng.choice(
        [ek.FREE, ek.HELD, ek.SUSTAINED, ek.RELEASING], mv,
        p=[0.25, 0.35, 0.2, 0.2]))
    # steal fades: at rest, ending mid-group, long
    eng_i[mv:ek.SLOTS] = torch.as_tensor(rng.choice(
        [0, 3, 5, 11, 13, 29, 220], mv))
    eng_i[ek.EI_FIRES] = 7 * e
    live = 1 + 2 * e          # a live main slot for each case below
    eng_i[[live, live + 1, live + 2, live + 3, live + 4, live + 5]] = \
        ek.HELD
    # a main slot that turns NaN mid-group: mode 2 at zero through a
    # renorm 4 + e samples in
    vst[ek.S_S + 2, live] = 0.0
    vst[ek.S_C + 2, live] = 0.0
    vsti[ek.I_N, live] = 1024 - 4 - e
    # NaN from the first sample, and an inf slot
    vpar[ek.P_AMP + 2, live + 1] = float("nan")
    vst[ek.S_C, live + 2] = float("inf")
    # dampers mid-ramp and long past
    damper(live + 3, float(ramp[live + 3]) * 0.5)
    damper(live + 4, float(ramp[live + 4]) + 900.0, done=True)
    # quiet (every mode's |amp·env| small) and silent (released > 10 s)
    vpar[ek.P_AMP:ek.P_AMP + 7, live + 5] *= 1e-7
    damper(live + 6, 10.0 * SR + 3.0, done=True)
    eng_i[live + 6] = ek.RELEASING
    # a steal slot at a live fade that turns NaN mid-group, one whose
    # fade ends in its second group, one that saturates its pickup
    st = mv + 3 + e
    eng_i[st:st + 3] = torch.tensor([40, 11, 60])
    vst[ek.S_S + 4, st] = 0.0
    vst[ek.S_C + 4, st] = 0.0
    vsti[ek.I_N, st] = 2048 - 6
    damper(st + 1, float(ramp[st + 1]) - 5.0)
    vpar[ek.P_DS, st + 2] *= 40.0
    return [vpar, vst, vsti, eng_i]


def _engines(b):
    cols = [_engine(e) for e in range(b)]
    return [torch.stack([c[i] for c in cols]).contiguous() for i in range(4)]


def _run(fn, cols, n):
    a = [c.clone() for c in cols]
    mono = torch.empty((a[0].shape[0], n), dtype=torch.float64)
    assert fn(*[x.data_ptr() for x in a], mono.data_ptr()) == 0
    return mono, a


def _lanes(lib, cols, n):
    b = cols[0].shape[0]
    return _run(lambda *p: lib.ow_engine_voices(*p, n, b, FADE_LEN, SR,
                                                None), cols, n)


def _thread(lib, cols, n):
    b = cols[0].shape[0]
    return _run(lambda *p: lib.ow_engine_voices_thread(*p, n, b, FADE_LEN,
                                                       SR, None), cols, n)


def _unguarded(lib, cols, n):
    b = cols[0].shape[0]
    return _run(lambda *p: lib.ow_test_voices_thread_unguarded(
        *p, n, b, FADE_LEN, SR, None), cols, n)


@pytest.mark.parametrize("b,n", CASES)
def test_lanes_equal_one_thread(lib, b, n):
    cols = _engines(b)
    mono_l, st_l = _lanes(lib, cols, n)
    mono_t, st_t = _thread(lib, cols, n)
    assert _same(mono_l, mono_t)
    for x, y in zip(st_l, st_t):
        assert _same(x, y)
    # the cases did what they are for: every engine fired guard #1 (the
    # NaN and inf slots), freed its quiet and silent slots, and ended
    # steal fades; its sum is finite
    mv = ek.MAX_VOICES
    for e in range(b):
        live = 1 + 2 * e
        eng0, eng1 = cols[3][e], st_l[3][e]
        assert eng1[ek.EI_FIRES] - eng0[ek.EI_FIRES] >= 3
        assert eng1[live] == eng1[live + 1] == eng1[live + 2] == ek.FREE
        assert eng1[live + 5] == eng1[live + 6] == ek.FREE
        assert eng1[live + 3] == ek.HELD
        assert eng1[mv + 3 + e] == 0 and eng1[mv + 4 + e] == 0
        assert torch.isfinite(mono_l[e]).all()
    assert not torch.equal(st_l[1], cols[1])


@pytest.mark.parametrize("b,n", CASES)
def test_lanes_match_plain(lib, b, n):
    cols = _engines(b)
    mono_l, st_l = _lanes(lib, cols, n)
    p = [c.clone() for c in cols]
    mono_p = ek.voices_plain(*p, n, FADE_LEN, SR)
    assert torch.isfinite(mono_p).all()
    err = (mono_l - mono_p).abs().max()
    assert err <= TOL_OUT, err
    fin = torch.isfinite(p[1])
    assert torch.equal(fin, torch.isfinite(st_l[1]))
    assert torch.equal(torch.isnan(p[1]), torch.isnan(st_l[1]))
    err = (st_l[1] - p[1])[fin].abs().max()
    assert err <= TOL_STATE, err
    assert torch.equal(st_l[2], p[2])
    assert torch.equal(st_l[3], p[3])


@pytest.mark.parametrize("b,n", CASES)
def test_thread_form_votes(lib, b, n):
    """(c): the votes skip only calls whose values no slot selects. The
    slots mix onsets, damper ramps, steady and free slots; the NaN and
    inf slots and the dampers sit off their warp's first slot."""
    cols = _engines(b)
    mono_t, st_t = _thread(lib, cols, n)
    mono_u, st_u = _unguarded(lib, cols, n)
    assert _same(mono_t, mono_u)
    for x, y in zip(st_t, st_u):
        assert _same(x, y)
    # the cases reach the votes' both sides: slots in their onset and
    # slots past it, dampers mid-ramp, a renorm
    nn, ramp_n = cols[2][:, ek.I_N], cols[0][:, ek.P_RAMP_N]
    onset = nn.double() < ramp_n
    assert onset.any() and (~onset).any()
    assert (cols[2][:, ek.I_DACT] != 0).any()
    p = [c.clone() for c in cols]
    mono_p = ek.voices_plain(*p, n, FADE_LEN, SR)
    err = (mono_t - mono_p).abs().max()
    assert err <= TOL_OUT, err
    fin = torch.isfinite(p[1])
    assert torch.equal(torch.isnan(p[1]), torch.isnan(st_t[1]))
    err = (st_t[1] - p[1])[fin].abs().max()
    assert err <= TOL_STATE, err
    assert torch.equal(st_t[2], p[2]) and torch.equal(st_t[3], p[3])
