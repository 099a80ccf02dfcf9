"""The warp-cooperative melange preamp step of `csrc/engine.cu`
(E5<melange> a warp per stream, E2<melange, circuit>'s warp form a warp
per engine) rehearsed on the CPU: the source built with g++ against the
host shim of tests/cuda_host_shim.py (a std::thread per CUDA thread, a
std::barrier per warp for __shfl_sync, __ballot_sync and __syncwarp).

  (a) in one binary, E5<melange> (`melange_step_warp`) equals the
      one-thread `melange_step` (driven by a thread-per-stream scan
      appended to the source, as E5 ran it before) bit for bit, output and
      all 59 state rows, on 4 streams × 32 steps: a 1 mV sine at 1 MΩ and
      at 12 kΩ, silence at noise scale 1 and at 30, with a NaN input
      midway in the last (the reset, the key's advance with the noise on)
      or in the 12 kΩ sine;
  (b) E5<melange> against `preamp_scan_plain`, and (c) one E2<melange,
      circuit> engine (a warp) against `chain_plain`, the outputs and the
      states within the host-libm tolerances below; on a kicked chunk E2's
      two forms, a warp and a thread per engine, agree bit for bit in one
      binary.

Both sides of (a) and of (c)'s two forms use the host's libm, so any
difference there would be a fault of the warp's lane logic. A reset at
12 kΩ lands far from the circuit's equilibrium (the next outputs reach
−15 V), where Newton stops unconverged after 12 iterations and the host's
libm moves the state from torch's by millivolts in both the one-thread and
the warp step: (b) holds the NaN stream at 1 MΩ, (a) holds both bit for
bit.
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

SR = 88200.0   # the melange step's rate in the oversampled chain
N, G = 32, 4
# The host's exp / log1p against torch's, carried through Newton's 1e-9 V
# stop: E2's outputs within TOL_OUT, the state rows within TOL_STATE (PR
# 15's bounds for the power amp). Measured here: E2's outputs 0 (float32),
# its states 5.4e-13 V; E5's states 9.8e-11 V and its outputs 9.6e-11 V.
# E5's output is main − shadow of the OUT node, two state rows, so it is
# held to TOL_STATE. (a) shows that the one-thread step, built with the
# same host libm, is the warp step bit for bit.
TOL_OUT = 1e-11
TOL_STATE = 1e-9


def _close(a, b, tol):
    """a and b within tol, NaN where b is NaN."""
    nan = torch.isnan(b)
    assert torch.equal(nan, torch.isnan(a))
    err = (a.double() - b.double()).nan_to_num().abs().max()
    assert err <= tol, err


# The one-thread step over G streams, a thread each, as E5<melange> ran it
# before its warp redesign: the same state rows and arguments.
HARNESS = r"""
namespace {
void mel_thread_scan_kernel(const double* c, const double* x, double* state,
                            const double* g_ldr, const double* scale,
                            double* out, int n, int g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double s[MS_ROWS];
  for (int k = 0; k < MS_ROWS; ++k) s[k] = state[(size_t)k * g + j];
  for (int t = 0; t < n; ++t)
    out[(size_t)t * g + j] =
        melange_step(c, s, g_ldr[j], x[(size_t)t * g + j], scale[j]);
  for (int k = 0; k < MS_ROWS; ++k) state[(size_t)k * g + j] = s[k];
}
}  // namespace
extern "C" int ow_test_mel_thread_scan(const double* consts, const double* x,
                                       double* state, const double* g_ldr,
                                       const double* scale, double* out,
                                       int n, int g) {
  shim::launch(1, g, mel_thread_scan_kernel, consts, x, state, g_ldr, scale,
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
        tmp_path_factory.mktemp("mel_warp"), "mel_warp", extra=HARNESS)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ow_preamp_scan.argtypes = [i, p, i, p, p, p, p, p, i, i, p]
    dll.ow_engine_chain.argtypes = [p, i, p, p, p, i, i, p, i, i, p, i, p]
    dll.ow_test_mel_thread_scan.argtypes = [p, p, p, p, p, p, i, i]
    return dll


def _bits(x):
    return x.contiguous().view(torch.int64 if x.element_size() == 8
                               else torch.int32)


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _inputs(nan_stream=3):
    """(N, G): a 1 mV 1 kHz sine at 1 MΩ and at 12 kΩ, silence at 100 kΩ
    with noise scale 1 and at 1 MΩ with 30, a NaN at step 12 of stream
    `nan_stream`. → x, g_ldr, noise scale, the rows (MEL_STATE_ROWS, G) at
    the DC point."""
    t = np.arange(N)[:, None]
    x = np.zeros((N, G))
    x[:, :2] = 0.001 * np.sin(2 * np.pi * 1000 * t / SR)
    x[12, nan_stream] = np.nan
    g = torch.tensor([1e-6, 1.0 / 12e3, 1e-5, 1e-6], dtype=torch.float64)
    scale = torch.tensor([0.0, 0.0, 1.0, 30.0], dtype=torch.float64)
    return (torch.from_numpy(x).contiguous(), g, scale,
            kr.init_melange_state(SR, G))


def _e5(lib, x, st, g, scale):
    consts = torch.from_numpy(kr.preamp_consts("melange", SR))
    out = torch.empty_like(x)
    assert lib.ow_preamp_scan(1, consts.data_ptr(), consts.numel(),
                              x.data_ptr(), st.data_ptr(), g.data_ptr(),
                              scale.data_ptr(), out.data_ptr(), x.shape[0],
                              x.shape[1], None) == 0
    return out


@pytest.mark.parametrize("nan_stream", [3, 1], ids=["noise30", "12k"])
def test_warp_step_equals_one_thread_step(lib, nan_stream):
    x, g, scale, st0 = _inputs(nan_stream)
    consts = torch.from_numpy(kr.preamp_consts("melange", SR))
    st_t, st_w = st0.clone(), st0.clone()
    out_t = torch.empty_like(x)
    assert lib.ow_test_mel_thread_scan(consts.data_ptr(), x.data_ptr(),
                                       st_t.data_ptr(), g.data_ptr(),
                                       scale.data_ptr(), out_t.data_ptr(),
                                       N, G) == 0
    out_w = _e5(lib, x, st_w, g, scale)
    assert _same(out_w, out_t)
    assert _same(st_w, st_t)
    # the cases reach the reset, the noise and the key's advance
    assert float(out_t[12, nan_stream]) == 0.0
    assert torch.isfinite(out_t).all()
    assert out_t[:, 3].abs().max() > 10 * out_t[:, 2].abs().max() > 0
    key = ek.CHAIN_OFF["mel_key"][0] - ek.CHAIN_OFF["mel_v"][0]
    assert not torch.equal(st_t[key:key + 2], st0[key:key + 2])


def test_e5_warp_matches_plain(lib):
    x, g, scale, st0 = _inputs()
    st_k, st_p = st0.clone(), st0.clone()
    out_k = _e5(lib, x, st_k, g, scale)
    out_p = kr.preamp_scan_plain("melange", SR, x, st_p, g, scale)
    _close(out_k, out_p, TOL_STATE)
    _close(st_k, st_p, TOL_STATE)


def _chain_case(kicked):
    """One E2<melange, circuit> engine's chunk of 8 base samples of a
    440 Hz sine from its initial state; kicked: the tremolo 70 V off (a
    BE replay) and a 30 V input spike."""
    cp = ek.chain_params(44100.0, "melange")
    state = ek.init_chain(cp, volume=0.8, depth=0.7, character=0.3)
    n = 8
    t = np.arange(n)
    mono = torch.from_numpy(0.3 * np.sin(2 * np.pi * 440 * t / 44100.0))
    if kicked:
        state[ek.CHAIN_OFF["trem_v"][0]] += 70.0
        mono[4] = 30.0
    return cp, state, mono


def _chain_kernel(lib, cp, state, mono, warp, noise):
    n = mono.shape[0]
    consts = torch.from_numpy(cp.flat)
    sag = torch.ones(1, dtype=torch.bool)
    scale = torch.full((1,), noise, dtype=torch.float64)
    st = state[None].clone()
    out = torch.empty((1, n), dtype=torch.float32)
    assert lib.ow_engine_chain(consts.data_ptr(), consts.numel(),
                               mono[None].contiguous().data_ptr(),
                               st.data_ptr(), out.data_ptr(), n, 1,
                               sag.data_ptr(), 1, 0, scale.data_ptr(),
                               warp, None) == 0
    return out[0], st[0]


def test_e2_warp_engine_matches_plain(lib):
    cp, state, mono = _chain_case(kicked=False)
    out_w, st_w = _chain_kernel(lib, cp, state, mono, 1, 3.0)
    st_p = state.clone()
    out_p = ek.chain_plain(cp, mono, st_p, True, 3.0)
    _close(out_w, out_p, TOL_OUT)
    _close(st_w, st_p, TOL_STATE)


def test_e2_forms_agree_kicked(lib):
    """Under the kick and the spike the two forms are held to each other
    bit for bit, and the outputs to the plain version."""
    cp, state, mono = _chain_case(kicked=True)
    out_w, st_w = _chain_kernel(lib, cp, state, mono, 1, 30.0)
    out_t, st_t = _chain_kernel(lib, cp, state, mono, 0, 30.0)
    assert _same(out_w, out_t) and _same(st_w, st_t)
    st_p = state.clone()
    out_p = ek.chain_plain(cp, mono, st_p, True, 30.0)
    _close(out_w, out_p, TOL_OUT)
    trem = ek.CHAIN_OFF["trem_diag"][0]
    assert st_p[trem + 4] > 0, "the kick reached the tremolo's BE replay"
