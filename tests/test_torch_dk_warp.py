"""The warp-cooperative DK preamp step of `csrc/engine.cu` (E5<dk> and E7,
a warp per stream, `dk_step_warp`) rehearsed on the CPU: the source built
with g++ against the host shim of tests/cuda_host_shim.py (a std::thread
per CUDA thread, a std::barrier per warp for __shfl_sync, __ballot_sync
and __syncwarp).

  (a) in one binary, E5<dk> and both taps of E7 equal the one-thread
      `preamp_step` (driven by thread-per-stream scans appended to the
      source, as E5<dk> and E7 ran it before) bit for bit, output and all
      42 (E5) or 29 (E7) state rows, on 4-5 streams × 32 steps: a 1 mV sine
      at 1 MΩ and at 1 kΩ, silence, a NaN input midway (the reset to the
      DC point) and, for E7, a NaN and an inf resistance;
  (b) both kernels against their plain versions (`preamp_scan_plain`,
      `dk_scan_plain`) within the host-libm tolerances below.

Both sides of (a) use the host's libm, so any difference there would be a
fault of the warp's lane logic.
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

SR = 88200.0   # the DK step's rate: E5's oversampled rate, the CLI's --sr
N = 32
# The host's exp against torch's, carried through Newton's 1e-9 V stop on
# the residual: outputs within TOL_OUT, state rows within TOL_STATE.
# Measured here: outputs 2.9e-11 V (E5) and 2.7e-10 V (E7); states 3.8e-11
# V at 1 MΩ and 1.0e-8 V at 1 kΩ (a junction voltage: there the LDR's
# feedback leaves the residual less sensitive to it, so the stop leaves it
# freer). (a) shows that the one-thread step, built with the same host
# libm, is the warp step bit for bit.
TOL_OUT = 1e-9
TOL_STATE = 1e-7


def _close(a, b, tol):
    """a and b within tol, NaN where b is NaN."""
    nan = torch.isnan(b)
    assert torch.equal(nan, torch.isnan(a))
    err = (a.double() - b.double()).nan_to_num().abs().max()
    assert err <= tol, err


# The one-thread step over G streams, a thread each, as E5<dk> and E7 ran
# it before their warp redesign: the same state rows and arguments.
HARNESS = r"""
namespace {
void pre_thread_scan_kernel(const double* c, const double* x, double* state,
                            const double* g_ldr, double* out, int n, int g) {
  constexpr int ROWS = OS_ROWS + PS_ROWS;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double s[ROWS];
  for (int k = 0; k < ROWS; ++k) s[k] = state[(size_t)k * g + j];
  const double gl = g_ldr[j];
  for (int t = 0; t < n; ++t) {
    const double xt = x[(size_t)t * g + j];
    const double e = branch_step(kBranchA, s + 0, xt);
    const double o = branch_step(kBranchB, s + 3, xt);
    const double y0 = preamp_step(c, s + OS_ROWS, gl, e);
    const double y1 = preamp_step(c, s + OS_ROWS, gl, o);
    const double a = branch_step(kBranchA, s + 6, y0);
    const double b = branch_step(kBranchB, s + 9, y1);
    out[(size_t)t * g + j] = (a + s[12]) * 0.5;
    s[12] = b;
  }
  for (int k = 0; k < ROWS; ++k) state[(size_t)k * g + j] = s[k];
}
void dk_thread_scan_kernel(const double* c, const double* x,
                           const double* r_ldr, double* state, double* out,
                           int n, int g, int tap) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double s[PS_ROWS];
  for (int k = 0; k < PS_ROWS; ++k) s[k] = state[(size_t)k * g + j];
  for (int t = 0; t < n; ++t) {
    const size_t at = (size_t)t * g + j;
    const double gl = 1.0 / jmax(r_ldr[at], 1000.0);
    const double y = preamp_step(c, s, gl, x[at]);
    out[at] = tap == DK_TAP_DIFF ? y : s[PS_V + 8 + OUTN];
  }
  for (int k = 0; k < PS_ROWS; ++k) state[(size_t)k * g + j] = s[k];
}
}  // namespace
extern "C" int ow_test_pre_thread_scan(const double* consts, const double* x,
                                       double* state, const double* g_ldr,
                                       double* out, int n, int g) {
  shim::launch(1, g, pre_thread_scan_kernel, consts, x, state, g_ldr, out, n,
               g);
  return 0;
}
extern "C" int ow_test_dk_thread_scan(const double* consts, const double* x,
                                      const double* r_ldr, double* state,
                                      double* out, int n, int g, int tap) {
  shim::launch(1, g, dk_thread_scan_kernel, consts, x, r_ldr, state, out, n,
               g, tap);
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
        tmp_path_factory.mktemp("dk_warp"), "dk_warp", extra=HARNESS)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ow_preamp_scan.argtypes = [i, p, i, p, p, p, p, p, i, i, p]
    dll.ow_dk_scan.argtypes = [i, p, i, p, p, p, p, i, i, p]
    dll.ow_test_pre_thread_scan.argtypes = [p, p, p, p, p, i, i]
    dll.ow_test_dk_thread_scan.argtypes = [p, p, p, p, p, i, i, i]
    return dll


def _same(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int64), b.contiguous().view(torch.int64))


def _consts():
    return torch.from_numpy(kr.preamp_consts("dk", SR))


def _inputs(g):
    """(N, g): a 1 mV 1 kHz sine at 1 MΩ and at 1 kΩ, silence, the sine
    with a NaN at step 12; for g = 5, a fifth sine whose resistance is NaN
    at step 10 and inf from step 20. → x, the resistances (N, g), the
    conductances (g,) of the first four."""
    t = np.arange(N)[:, None]
    x = np.zeros((N, g))
    x[:, [0, 1, 3]] = 0.001 * np.sin(2 * np.pi * 1000 * t / SR)
    x[12, 3] = np.nan
    r = np.tile(np.array([1e6, 1e3, 1e6, 1e6, 1e5][:g]), (N, 1))
    if g == 5:
        x[:, 4] = 0.003 * np.sin(2 * np.pi * 3000 * t[:, 0] / SR)
        r[10, 4] = np.nan
        r[20:, 4] = np.inf
    g_ldr = torch.from_numpy(1.0 / np.maximum(r[0, :4], 1000.0))
    return torch.from_numpy(x), torch.from_numpy(r), g_ldr


def _e5(lib, x, st, g_ldr):
    c = _consts()
    out = torch.empty_like(x)
    assert lib.ow_preamp_scan(0, c.data_ptr(), c.numel(), x.data_ptr(),
                              st.data_ptr(), g_ldr.data_ptr(), None,
                              out.data_ptr(), x.shape[0], x.shape[1],
                              None) == 0
    return out


def _e7(lib, x, r, st, tap):
    c = _consts()
    out = torch.empty_like(x)
    assert lib.ow_dk_scan(kr.DK_TAPS.index(tap), c.data_ptr(), c.numel(),
                          x.data_ptr(), r.data_ptr(), st.data_ptr(),
                          out.data_ptr(), x.shape[0], x.shape[1], None) == 0
    return out


@pytest.mark.parametrize("kernel", ["e5", "e7-diff", "e7-shadow"])
def test_warp_step_equals_one_thread_step(lib, kernel):
    c = _consts()
    if kernel == "e5":
        x, _, g_ldr = _inputs(4)
        st0 = kr.init_dk_state(SR, 4)
        st_t, st_w = st0.clone(), st0.clone()
        out_t = torch.empty_like(x)
        assert lib.ow_test_pre_thread_scan(
            c.data_ptr(), x.data_ptr(), st_t.data_ptr(), g_ldr.data_ptr(),
            out_t.data_ptr(), N, 4) == 0
        out_w = _e5(lib, x, st_w, g_ldr)
    else:
        tap = kernel.split("-")[1]
        x, r, _ = _inputs(5)
        st0 = kr.init_dk_scan_state(SR, 5)
        st_t, st_w = st0.clone(), st0.clone()
        out_t = torch.empty_like(x)
        assert lib.ow_test_dk_thread_scan(
            c.data_ptr(), x.data_ptr(), r.data_ptr(), st_t.data_ptr(),
            out_t.data_ptr(), N, 5, kr.DK_TAPS.index(tap)) == 0
        out_w = _e7(lib, x, r, st_w, tap)
    assert _same(out_w, out_t)
    assert _same(st_w, st_t)
    # the cases reach the reset and tell the 1 kΩ stream from the 1 MΩ one
    if kernel == "e5":
        # the oversampler's up branches carry the NaN, as in the
        # reference, so the preamp resets on every later step
        assert torch.isnan(st_t[:kr.OS_ROWS, 3]).any()
        assert _same(st_t[kr.OS_ROWS:, 3], st0[kr.OS_ROWS:, 3])
        assert torch.isfinite(out_t).all()
    else:
        assert torch.isfinite(st_t).all()
        if kernel == "e7-diff":
            assert float(out_t[12, 3]) == float(out_t[10, 4]) == 0.0
            assert float(out_t[13, 3]) != 0.0
    assert not torch.equal(out_t[:, 0], out_t[:, 1])
    if kernel != "e7-shadow":  # the shadow's OUT node sits at its DC bias
        assert float(out_t[:, 2].abs().max()) < float(
            out_t[:, 0].abs().max())


def test_e5_warp_matches_plain(lib):
    x, _, g_ldr = _inputs(4)
    st0 = kr.init_dk_state(SR, 4)
    st_k, st_p = st0.clone(), st0.clone()
    out_k = _e5(lib, x, st_k, g_ldr)
    out_p = kr.preamp_scan_plain("dk", SR, x, st_p, g_ldr)
    _close(out_k, out_p, TOL_OUT)
    _close(st_k, st_p, TOL_STATE)


@pytest.mark.parametrize("tap", ["diff", "shadow"])
def test_e7_warp_matches_plain(lib, tap):
    x, r, _ = _inputs(5)
    st0 = kr.init_dk_scan_state(SR, 5)
    st_k, st_p = st0.clone(), st0.clone()
    out_k = _e7(lib, x, r, st_k, tap)
    out_p = kr.dk_scan_plain(SR, x, r, st_p, tap)
    _close(out_k, out_p, TOL_OUT)
    _close(st_k, st_p, TOL_STATE)
