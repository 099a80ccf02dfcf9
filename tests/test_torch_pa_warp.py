"""The warp-cooperative power-amp step of `csrc/engine.cu` (E6 a warp per
stream, E2's circuit instantiations a warp per engine) rehearsed on the
CPU: the source built with g++ against the host shim of
tests/cuda_host_shim.py (a std::thread per CUDA thread, a std::barrier
per warp for __shfl_sync, __all_sync and __syncwarp).

  (a) in one binary, the warp step (`power_amp_step_warp`, driven by a
      one-warp-per-stream scan appended to the source) equals the
      one-thread `power_amp_step` (a thread-per-stream scan, E9 before its
      warp redesign, appended too) bit for bit, output and state, on 4
      streams × 32 samples: the bench's sine, a 200 V spike, a NaN stream
      and sagged rails; E6 at volume 1 leaves the same power-amp rows; and
      so do E9 itself and its output;
  (b) E6 (a warp per stream) against `pa_speaker_scan_plain`, and (c) one
      E2<dk, circuit> engine (a warp) against `chain_plain`, the outputs
      within 1e-11 and the states within 1e-9 V (the host's libm against
      torch's, carried through Newton's 1e-9 V stop); on a kicked chunk
      E2's two forms, a warp and a thread per engine, agree bit for bit in
      one binary;
  (d) the behavioral power amp's two instantiations, <dk, behavioral> and
      <melange, behavioral> (at noise scale 30): the warp form and the
      thread form bit for bit, output and every state row, on a kicked
      chunk, guard #2 midway and a NaN input, the outputs against
      `chain_plain`; guard #2 leaves the power-amp rows at rest in both.

Both sides of (a) and of (c)'s two forms use the host's libm, so any
difference there would be a fault of the warp's lane logic.
"""

import ctypes
import os

import cuda_host_shim
import numpy as np
import pytest
import torch

from openwurli_tpu_torch.kernels import engine as ek
from openwurli_tpu_torch.kernels import render as kr

torch.set_num_threads(1)

SR = 88200.0   # the power amp's rate in the oversampled chain
N, G = 32, 4
# The host's exp / log1p / pow against torch's: the outputs within
# TOL_OUT, the state rows within TOL_STATE, Newton's own stop (|f| < 1e-9
# V): the converged junction and node voltages carry the libm difference
# (up to 1.9e-11 V in E6's, 4.3e-10 V in the chain's measured here). (a)
# shows that the one-thread step, built with the same host libm, is the
# warp step bit for bit, so it differs from the plain version just as much.
TOL_OUT = 1e-11
TOL_STATE = 1e-9


def _close(a, b, tol):
    """a and b within tol, NaN where b is NaN."""
    nan = torch.isnan(b)
    assert torch.equal(nan, torch.isnan(a))
    err = (a.double() - b.double()).nan_to_num().abs().max()
    assert err <= tol, err


# The warp step over G streams, one warp each, with E9's state rows and
# arguments but two warps to a block; the one-thread step over G streams,
# a thread each, as E9 ran before its warp redesign.
HARNESS = r"""
namespace {
void pa_thread_scan_kernel(const double* c, const double* x, double* state,
                           double* out, int n, int g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double ch[CHAIN_ROWS];  // only the power amp's rows
  for (int k = 0; k < E9_ROWS; ++k)
    ch[CH_PA_V + k] = state[(size_t)k * g + j];
  for (int t = 0; t < n; ++t)
    out[(size_t)t * g + j] = power_amp_step(c, c + C_MISC, ch,
                                            x[(size_t)t * g + j], true);
  for (int k = 0; k < E9_ROWS; ++k)
    state[(size_t)k * g + j] = ch[CH_PA_V + k];
}
constexpr int T_WARPS = 2;
void pa_warp_scan_kernel(const double* c, const double* x, double* state,
                         double* out, int n, int g) {
  __shared__ double s_pa[PA_BLOCK];
  __shared__ WarpScratch scratch[T_WARPS];
  stage_block<21, 16, 8>(c + C_PA, s_pa);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;
  PaWarp pa;
  load_pa(pa, state + j, g, lane);
  for (int t = 0; t < n; ++t) {
    const double y = power_amp_step_warp(s_pa, c + C_MISC, pa,
                                         x[(size_t)t * g + j], true,
                                         &scratch[warp]);
    if (lane == 0) out[(size_t)t * g + j] = y;
  }
  store_pa(pa, state + j, g, lane);
}
}  // namespace
extern "C" int ow_test_pa_warp_scan(const double* consts, const double* x,
                                    double* state, double* out, int n,
                                    int g) {
  shim::launch((g + T_WARPS - 1) / T_WARPS, 32 * T_WARPS,
               pa_warp_scan_kernel, consts, x, state, out, n, g);
  return 0;
}
extern "C" int ow_test_pa_thread_scan(const double* consts, const double* x,
                                      double* state, double* out, int n,
                                      int g) {
  shim::launch((g + 31) / 32, 32, pa_thread_scan_kernel, consts, x, state,
               out, n, g);
  return 0;
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if not cuda_host_shim.have_gxx():
        pytest.skip("needs g++ to build the kernel against the host shim")
    dll = cuda_host_shim.build(
        os.path.join(os.path.dirname(ek.__file__), "..", "csrc",
                     "engine.cu"),
        tmp_path_factory.mktemp("pa_warp"), "pa_warp", extra=HARNESS)
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    dll.ow_power_amp_scan.argtypes = [p, i, p, p, p, i, i, p]
    dll.ow_pa_speaker_scan.argtypes = [p, i, p, p, p, i, i, d, d, p]
    dll.ow_engine_chain.argtypes = [p, i, p, p, p, i, i, p, i, i, p, i, p]
    dll.ow_test_pa_warp_scan.argtypes = [p, p, p, p, i, i]
    dll.ow_test_pa_thread_scan.argtypes = [p, p, p, p, i, i]
    return dll


def _bits(x):
    return x.contiguous().view(torch.int64 if x.element_size() == 8
                               else torch.int32)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _inputs(sr):
    """(N, G): the stage bench's 1 kHz sine at seeded levels; stream 1
    spikes to 200 V, stream 2 goes NaN, stream 3 is loud. → x and the rows
    (PA_ROWS, G) at the DC point, stream 3's rails sagged."""
    rng = np.random.default_rng(15)
    t = np.arange(N)[:, None]
    x = rng.uniform(0.02, 0.4, G) * np.sin(2 * np.pi * 1000 * t / sr)
    x[:, 3] *= 6.0
    x[N // 3, 1] = 200.0
    x[N // 4, 2] = np.nan
    st = ek.init_power_amp_scan_state(sr, G)
    r0 = ek.CHAIN_OFF["pa_rails"][0] - ek.CHAIN_OFF["pa_v"][0]
    st[r0:r0 + 4, 3] = torch.tensor([21.0, 21.8, 0.3, 0.1],
                                    dtype=torch.float64)
    return torch.from_numpy(x).contiguous(), st


def _e9(lib, consts, x, st):
    out = torch.empty_like(x)
    assert lib.ow_power_amp_scan(consts.data_ptr(), consts.numel(),
                                 x.data_ptr(), st.data_ptr(), out.data_ptr(),
                                 N, G, None) == 0
    return out


def _thread(lib, consts, x, st):
    out = torch.empty_like(x)
    assert lib.ow_test_pa_thread_scan(consts.data_ptr(), x.data_ptr(),
                                      st.data_ptr(), out.data_ptr(), N,
                                      G) == 0
    return out


def _e6(lib, sr, x, st, volume, character):
    consts = torch.from_numpy(kr.pa_speaker_consts(sr))
    out = torch.empty_like(x)
    assert lib.ow_pa_speaker_scan(consts.data_ptr(), consts.numel(),
                                  x.data_ptr(), st.data_ptr(),
                                  out.data_ptr(), x.shape[0], x.shape[1],
                                  volume, character, None) == 0
    return out


def test_warp_step_equals_one_thread_step(lib):
    x, st0 = _inputs(SR)
    consts = torch.from_numpy(ek.scan_consts(SR, "power_amp"))
    st_t, st_w = st0.clone(), st0.clone()
    out_t = _thread(lib, consts, x, st_t)
    out_w = torch.empty_like(x)
    assert lib.ow_test_pa_warp_scan(consts.data_ptr(), x.data_ptr(),
                                    st_w.data_ptr(), out_w.data_ptr(),
                                    N, G) == 0
    assert _same(out_w, out_t)
    assert _same(st_w, st_t)
    # the cases reach the guard, the NaN reset and the rails
    diag = st_t[ek.CHAIN_OFF["pa_diag"][0] - ek.CHAIN_OFF["pa_v"][0]:][:5]
    assert diag[1, 1] > 0 and diag[2, 2] > 0, diag
    r0 = ek.CHAIN_OFF["pa_rails"][0] - ek.CHAIN_OFF["pa_v"][0]
    assert not torch.equal(st_t[r0:r0 + 4, 3], st0[r0:r0 + 4, 3])
    assert torch.isfinite(out_t).all()
    # E6 at volume 1 runs the same step: the same power-amp rows
    spk = torch.zeros((kr.PA_SPEAKER_ROWS - ek.PA_ROWS, G),
                      dtype=torch.float64)
    st6 = torch.cat([st0, spk]).contiguous()
    _e6(lib, SR, x, st6, 1.0, 0.5)
    assert _same(st6[:ek.PA_ROWS], st_t)


def test_e9_equals_one_thread_step_and_e6(lib):
    """E9, a warp per stream since its redesign: the one-thread step's
    output and rows bit for bit, and E6's power-amp rows at volume 1."""
    x, st0 = _inputs(SR)
    consts = torch.from_numpy(ek.scan_consts(SR, "power_amp"))
    st_t, st_9 = st0.clone(), st0.clone()
    out_t = _thread(lib, consts, x, st_t)
    out_9 = _e9(lib, consts, x, st_9)
    assert _same(out_9, out_t) and _same(st_9, st_t)
    spk = torch.zeros((kr.PA_SPEAKER_ROWS - ek.PA_ROWS, G),
                      dtype=torch.float64)
    st6 = torch.cat([st0, spk]).contiguous()
    _e6(lib, SR, x, st6, 1.0, 0.5)
    assert _same(st6[:ek.PA_ROWS], st_9)
    # G = 1 and G = 5: one stream, a partial last block
    for g in (1, 5):
        cols = [j % G for j in range(g)]
        xg, sg = x[:, cols].contiguous(), st0[:, cols].contiguous()
        a, b = sg.clone(), sg.clone()
        oa, ob = torch.empty_like(xg), torch.empty_like(xg)
        assert lib.ow_power_amp_scan(consts.data_ptr(), consts.numel(),
                                     xg.data_ptr(), a.data_ptr(),
                                     oa.data_ptr(), N, g, None) == 0
        assert lib.ow_test_pa_thread_scan(consts.data_ptr(), xg.data_ptr(),
                                          b.data_ptr(), ob.data_ptr(), N,
                                          g) == 0
        assert _same(oa, ob) and _same(a, b)


def test_e6_warp_matches_plain(lib):
    sr = 44100.0  # run_calibrate's rate
    x, st_pa = _inputs(sr)
    st0 = kr.init_pa_speaker_state(sr, G)
    st0[:ek.PA_ROWS] = st_pa
    st_k, st_p = st0.clone(), st0.clone()
    out_k = _e6(lib, sr, x, st_k, 0.8, 0.4)
    out_p = kr.pa_speaker_scan_plain(sr, x, st_p, 0.8, 0.4)
    _close(out_k, out_p, TOL_OUT)
    _close(st_k, st_p, TOL_STATE)


def _chain_case(kicked):
    """One E2<dk, circuit> engine's chunk of 24 base samples of a 440 Hz
    sine from its initial state; kicked: the tremolo 70 V off (a BE
    replay) and a 30 V input spike (the power amp's Newton fails)."""
    cp = ek.chain_params(44100.0)
    state = ek.init_chain(cp, volume=0.8, depth=0.7, character=0.3)
    n = 24
    t = np.arange(n)
    mono = torch.from_numpy(0.3 * np.sin(2 * np.pi * 440 * t / 44100.0))
    if kicked:
        state[ek.CHAIN_OFF["trem_v"][0]] += 70.0
        mono[9] = 30.0
    return cp, state, mono


def _chain_kernel(lib, cp, state, mono, warp, noise_scale=0.0):
    """One engine through ow_engine_chain in cp's instantiation, a warp
    (warp=1) or a thread (warp=0) per engine."""
    n = mono.shape[0]
    consts = torch.from_numpy(cp.flat)
    sag = torch.ones(1, dtype=torch.bool)
    scale = torch.full((1,), noise_scale, dtype=torch.float64)
    st = state[None].clone()
    out = torch.empty((1, n), dtype=torch.float32)
    assert lib.ow_engine_chain(consts.data_ptr(), consts.numel(),
                               mono[None].contiguous().data_ptr(),
                               st.data_ptr(), out.data_ptr(), n, 1,
                               sag.data_ptr(),
                               ek.PREAMP_MODELS.index(cp.preamp_model),
                               ek.PA_MODELS.index(cp.pa_model),
                               scale.data_ptr(), warp, None) == 0
    return out[0], st[0]


def test_e2_warp_engine_matches_plain(lib):
    cp, state, mono = _chain_case(kicked=False)
    out_w, st_w = _chain_kernel(lib, cp, state, mono, 1)
    st_p = state.clone()
    out_p = ek.chain_plain(cp, mono, st_p, True)
    _close(out_w, out_p, TOL_OUT)
    _close(st_w, st_p, TOL_STATE)


def test_e2_forms_agree_kicked(lib):
    """Under the kick and the spike the host's libm moves the preamp's
    unconverged Newton by up to 3.9e-7 V from torch's, in code that both
    forms run on one thread: the two forms are held to each other bit for
    bit, the outputs to the plain version."""
    cp, state, mono = _chain_case(kicked=True)
    out_w, st_w = _chain_kernel(lib, cp, state, mono, 1)
    out_t, st_t = _chain_kernel(lib, cp, state, mono, 0)
    assert _same(out_w, out_t) and _same(st_w, st_t)
    st_p = state.clone()
    out_p = ek.chain_plain(cp, mono, st_p, True)
    _close(out_w, out_p, TOL_OUT)
    trem = ek.CHAIN_OFF["trem_diag"][0]
    assert st_p[trem + 4] > 0, "the kick reached the tremolo's BE replay"
    pa = ek.CHAIN_OFF["pa_diag"][0]
    assert st_p[pa + 1] > 0, "the spike failed the power amp's Newton"


def test_e2_forms_agree_guard(lib):
    """Guard #2 midway through a 16-sample chunk: a NaN in mono at sample 4
    resets the DK preamp to its DC point on each later step (the
    oversampler's up branches keep the NaN, and the preamp's own reset
    keeps the output finite), and the volume smoother reaching a NaN target
    at sample 9 fires guard #2 on every sample from there, which resets the
    preamp's, the oversampler's and the power amp's rows. The two forms
    agree bit for bit; the outputs match the plain version."""
    cp, state, _ = _chain_case(kicked=False)
    n = 16
    t = np.arange(n)
    mono = torch.from_numpy(0.3 * np.sin(2 * np.pi * 440 * t / 44100.0))
    mono[4] = float("nan")
    a, _ = ek.CHAIN_OFF["sm_volume"]
    state[a + 1:a + 4] = torch.tensor([float("nan"), 0.0, 10.0],
                                      dtype=torch.float64)
    out_w, st_w = _chain_kernel(lib, cp, state, mono, 1)
    out_t, st_t = _chain_kernel(lib, cp, state, mono, 0)
    assert _same(out_w, out_t) and _same(st_w, st_t)
    st_p = state.clone()
    out_p = ek.chain_plain(cp, mono, st_p, True)
    _close(out_w, out_p, TOL_OUT)
    assert torch.isfinite(out_w).all() and (out_w[9:] == 0).all()
    assert (out_w[:9] != 0).all()
    # guard #2 left the preamp, the oversampler and the power amp at rest
    rest = ek.init_chain(cp, volume=0.8, depth=0.7, character=0.3)
    for name in ("pre_v", "pre_i", "pre_vnl", "pre_jcin", "pre_cinprev",
                 "pre_gprev", "os_up_a", "os_delay", "pa_v", "pa_rails"):
        lo, hi = ek.CHAIN_OFF[name]
        assert _same(st_w[lo:hi], rest[lo:hi]), name


# (d): the behavioral power amp's instantiations, and the noise scale of
# each (it acts on the melange preamp only)
BEHAVIORAL = {"dk": 0.0, "melange": 30.0}
PA_ROW_NAMES = ("pa_v", "pa_i", "pa_vnl", "pa_resid", "pa_diag", "pa_rails",
                "pa_last")


def _behavioral_case(pre, case):
    """One <pre, behavioral> engine's chunk of a 440 Hz sine from its
    initial state with its power-amp rows moved off rest (the behavioral
    power amp never writes them; guard #2 resets them): "kicked" the
    tremolo 70 V off and a 30 V input spike, "guard" a NaN in mono at
    sample 4 and a NaN volume target reached at sample 9 (guard #2 from
    there on), "nan" a NaN in mono at sample 5 (the preamp's own reset)."""
    cp = ek.chain_params(44100.0, pre, "behavioral")
    state = ek.init_chain(cp, volume=0.8, depth=0.7, character=0.3)
    for k, name in enumerate(PA_ROW_NAMES):
        lo, hi = ek.CHAIN_OFF[name]
        state[lo:hi] += 1.0 + k  # whole: the diag rows are counters
    n = 16 if case == "guard" else 24
    t = np.arange(n)
    mono = torch.from_numpy(0.3 * np.sin(2 * np.pi * 440 * t / 44100.0))
    if case == "kicked":
        state[ek.CHAIN_OFF["trem_v"][0]] += 70.0
        mono[9] = 30.0
    elif case == "guard":
        mono[4] = float("nan")
        a, _ = ek.CHAIN_OFF["sm_volume"]
        state[a + 1:a + 4] = torch.tensor([float("nan"), 0.0, 10.0],
                                          dtype=torch.float64)
    else:
        mono[5] = float("nan")
    return cp, state, mono


@pytest.mark.parametrize("case", ["kicked", "guard", "nan"])
@pytest.mark.parametrize("pre", sorted(BEHAVIORAL))
def test_e2_behavioral_forms_agree(lib, pre, case):
    cp, state, mono = _behavioral_case(pre, case)
    scale = BEHAVIORAL[pre]
    out_w, st_w = _chain_kernel(lib, cp, state, mono, 1, scale)
    out_t, st_t = _chain_kernel(lib, cp, state, mono, 0, scale)
    assert _same(out_w, out_t) and _same(st_w, st_t)
    st_p = state.clone()
    out_p = ek.chain_plain(cp, mono, st_p, True, scale)
    _close(out_w, out_p, TOL_OUT)
    assert torch.isfinite(out_w).all()
    rest = ek.init_chain(cp, volume=0.8, depth=0.7, character=0.3)
    for name in PA_ROW_NAMES:
        lo, hi = ek.CHAIN_OFF[name]
        # guard #2 resets the power-amp rows; nothing else writes them
        assert _same(st_w[lo:hi], (rest if case == "guard" else state)[lo:hi]
                     ), name
        assert _same(st_p[lo:hi], st_w[lo:hi]), name
    if case == "guard":
        assert (out_w[9:] == 0).all() and (out_w[:9] != 0).any()
    if case == "kicked":
        trem = ek.CHAIN_OFF["trem_diag"][0]
        assert st_p[trem + 4] > 0, "the kick reached the tremolo's BE replay"
