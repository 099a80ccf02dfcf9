"""E4 and E4<tap> of `csrc/engine.cu` (`voice_lanes_kernel<TAP>`, eight
threads per voice, four voices per warp) rehearsed on the CPU:
tools/voice_breakdown.cu (which includes the source, and holds E4 before
its lane redesign and the lane kernel's variants) built with g++ against
the host shim of tests/cuda_host_shim.py (a std::thread per CUDA thread,
a std::barrier per warp for __shfl_sync, __any_sync and __syncwarp).

  (a) in one binary, the lane kernel equals the one-thread kernel
      (`voice_sample<TAP>` on a thread per voice, as E4 ran before) bit
      for bit: the output, the reed tap and every state row, over N
      samples at G = 1, 5 and 9 voices; and so does every other variant
      that tools/torch_voice_breakdown.py times (the one-thread kernel
      with its libm behind votes; the lanes at 32 threads per block, with
      staged stores, stamped) over N_VARIANT samples;
  (b) the same runs against the plain versions (`voice_render_plain`,
      `voice_tap_plain`) within the host-libm tolerances below.

The voices cover the onset's three branches mid-ramp (shape 1, 1.5 and
2), a damper mid-ramp, one crossing its ramp's end and two past it, the
attack noise through its fade and to the end of its burst, sample counts
that cross 1024 and 2048 (the renorm) and multiples of 16 (the jitter
tick) at different offsets within a group, a saturated pickup, a NaN
voice and an inf voice. Both sides of (a) use the host's libm, so any
difference there would be a fault of the lanes' logic.
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
N = 300
# the variants' runs: block barriers and the one-thread kernel's votes are
# slow under the shim (a partial last group included)
N_VARIANT = 45
# The host's cos / pow / exp / sqrt / tanh against torch's: the outputs
# and the reed tap within TOL_OUT of each other, the state rows within
# TOL_STATE (measured here: 1.7e-15 on a peak of 27.8, and 8.9e-16). (a)
# shows that the one-thread kernel, built with the same host libm, is the
# lane kernel bit for bit, so it differs from the plain version just as
# much.
TOL_OUT = 1e-13
TOL_STATE = 1e-13

# tools/voice_breakdown.cu's variants (e4b_launch's `which`; 3, the lanes
# at 128 threads per block, is the library's launch) and its parts
W_THREAD = 0
VARIANTS = {1: "guarded", 2: "lanes32", 4: "staged128", 5: "stamped32"}
N_PARTS = 4

NOTES = (60.0, 45.0, 72.0, 84.0, 38.0, 93.0, 67.0, 52.0, 79.0)
VELS = (1.0, 0.5, 0.0, 0.8, 0.3, 1.0, 0.6, 0.9, 0.5)
# the voices of each width (indices into NOTES): one voice alone, a
# partial warp, two warps and a voice
WIDTHS = {1: (1,), 5: (0, 1, 2, 3, 4), 9: tuple(range(9))}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not cuda_host_shim.have_gxx():
        pytest.skip("needs g++ to build the kernel against the host shim")
    dll = cuda_host_shim.build(
        os.path.join(os.path.dirname(ek.__file__), "..", "..", "tools",
                     "voice_breakdown.cu"),
        tmp_path_factory.mktemp("voice_lanes"), "voice_lanes")
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ow_voice_render.argtypes = [p, p, p, p, i, i, p]
    dll.ow_voice_render_tap.argtypes = [p, p, p, p, p, i, i, p]
    dll.e4b_launch.argtypes = [i, i, p, p, p, p, p, p, i, i, p]
    return dll


def _bits(x):
    return x.contiguous().view(torch.int64)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _voices(g):
    """The packed columns (vpar, vst, vsti) of width g's voices, each at
    its own sample count, damper and noise state (see the docstring)."""
    idx = list(WIDTHS[g])
    m = np.asarray([NOTES[i] for i in idx])
    v = np.asarray([VELS[i] for i in idx])
    vp, det = voice.note_on_params(m, v, SR, mlp_enabled=False)
    vs = voice.init_state(vp, det, v, SR, voice.default_note_seed(m))
    vpar, vst, vsti = kr.voice_columns(vp, vs)
    rate, mult, ramp, _ = reed.damper_constants(
        torch.as_tensor(m), SR)
    for c, i in enumerate(idx):
        def damper(count, done=False):
            vst[ek.S_DRATE:ek.S_DRATE + 7, c] = rate[c]
            vst[ek.S_DMULT:ek.S_DMULT + 7, c] = mult[c]
            vst[ek.S_DRAMP, c] = ramp[c]
            vst[ek.S_DCOUNT, c] = count
            vsti[ek.I_DACT, c] = 1
            vsti[ek.I_DDONE, c] = int(done)

        if i == 0:    # shape 1 mid-onset
            vsti[ek.I_N, c] = 37
        elif i == 1:  # shape 1.5 mid-onset, the damper crossing its end
            vsti[ek.I_N, c] = 5
            damper(float(ramp[c]) - 100.0)
        elif i == 2:  # shape 2 from note-on, the noise fading in, the
            vsti[ek.I_NREM, c] = 100        # damper mid-ramp
            damper(float(ramp[c]) * 0.5)
        elif i == 3:  # shape 2 set, crossing 1024, the damper long past
            vpar[ek.P_SHAPE, c] = 2.0
            vsti[ek.I_N, c] = 1024 - 150 + 3
            damper(float(ramp[c]) + 500.0, done=True)
        elif i == 4:  # crossing 2048, the pickup past its knee
            vsti[ek.I_N, c] = 2048 - 37
            vpar[ek.P_DS, c] *= 40.0
        elif i == 5:  # a top key, the damper's first sample past its ramp
            vsti[ek.I_N, c] = 16 * 7 + 9
            damper(float(ramp[c]) + 3.0)
        elif i == 6:  # mid-fade, the burst ending mid-run, crossing 1024
            vsti[ek.I_N, c] = 1024 - 290
            vsti[ek.I_NREM, c] = 123
            vsti[ek.I_NFADE, c] = 3
        elif i == 7:
            vpar[ek.P_AMP + 2, c] = float("nan")
        elif i == 8:
            vst[ek.S_C, c] = float("inf")
    return vpar, vst, vsti


def _run(fn, tap, cols, g, n=N):
    a = [c.clone() for c in cols]
    out = torch.empty((n, g), dtype=torch.float64)
    rd = torch.empty_like(out) if tap else None
    ptrs = [x.data_ptr() for x in a] + [out.data_ptr()]
    assert fn(ptrs, rd) == 0
    return out, rd, a


def _lanes(lib, tap, cols, g, n=N):
    def fn(ptrs, rd):
        if tap:
            return lib.ow_voice_render_tap(*ptrs, rd.data_ptr(), g, n, None)
        return lib.ow_voice_render(*ptrs, g, n, None)
    return _run(fn, tap, cols, g, n)


def _variant(lib, which, tap, cols, g, n=N):
    parts = torch.zeros((N_PARTS, g), dtype=torch.int64)
    return _run(lambda ptrs, rd: lib.e4b_launch(
        which, int(tap), *ptrs, rd.data_ptr() if tap else None,
        parts.data_ptr(), g, n, None), tap, cols, g, n)


@pytest.mark.parametrize("tap", [False, True], ids=["E4", "E4<tap>"])
@pytest.mark.parametrize("g", [1, 5, 9])
def test_lanes_equal_one_thread(lib, g, tap):
    cols = _voices(g)
    out_l, reed_l, st_l = _lanes(lib, tap, cols, g)
    out_t, reed_t, st_t = _variant(lib, W_THREAD, tap, cols, g)
    assert _same(out_l, out_t)
    if tap:
        assert _same(reed_l, reed_t)
    for x, y in zip(st_l, st_t):
        assert _same(x, y)
    # the runs move the state; the NaN and inf voices stay non-finite
    assert not torch.equal(st_l[2][ek.I_N], cols[2][ek.I_N])
    if g == 9:
        assert not torch.isfinite(out_l[:, 7]).all()
        assert not torch.isfinite(out_l[:, 8]).all()
        assert torch.isfinite(out_l[:, :7]).all()


@pytest.mark.parametrize("tap", [False, True], ids=["E4", "E4<tap>"])
@pytest.mark.parametrize("which", sorted(VARIANTS),
                         ids=[VARIANTS[w] for w in sorted(VARIANTS)])
def test_breakdown_variants_equal_the_kernel(lib, which, tap):
    g = 9
    cols = _voices(g)
    ref = _lanes(lib, tap, cols, g, N_VARIANT)
    got = _variant(lib, which, tap, cols, g, N_VARIANT)
    assert _same(got[0], ref[0])
    if tap:
        assert _same(got[1], ref[1])
    for x, y in zip(got[2], ref[2]):
        assert _same(x, y)


def _close(a, b, tol):
    """a and b within tol, NaN where b is NaN."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    err = (a - b).nan_to_num(posinf=0.0, neginf=0.0).abs().max()
    assert err <= tol, err


@pytest.mark.parametrize("tap", [False, True], ids=["E4", "E4<tap>"])
@pytest.mark.parametrize("g", [1, 5, 9])
def test_lanes_match_plain(lib, g, tap):
    cols = _voices(g)
    out_l, reed_l, st_l = _lanes(lib, tap, cols, g)
    b = [c.clone() for c in cols]
    if tap:
        out_p, reed_p = kr.voice_tap_plain(*b, N)
        _close(reed_l, reed_p, TOL_OUT)
    else:
        out_p = kr.voice_render_plain(*b, N)
    _close(out_l, out_p, TOL_OUT)
    _close(st_l[1], b[1], TOL_STATE)
    assert torch.equal(st_l[2], b[2])
