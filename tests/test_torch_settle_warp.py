"""The tremolo settle E3 of `csrc/engine.cu` (`tremolo_settle_kernel`, one
warp over `mna_step_warp<7, 4, 2, 4>`) rehearsed on the CPU: the source
built with g++ against the host shim of tests/cuda_host_shim.py (a
std::thread per CUDA thread, a std::barrier per warp for __shfl_sync,
__all_sync, __any_sync and __syncwarp).

  (a) in one binary, E3 equals the one-thread settle (the oscillator's rows
      stepped by `mna_step<7, 4, 2, 4>` on one thread, as E3 ran before its
      warp redesign, appended to the source) bit for bit, all 21 rows, over
      128 steps at 88.2 kHz: from the tremolo's perturbed start, and from
      that start with a NaN node voltage, which resets to the DC point;
  (b) E3 against its plain version (`kernels.engine.settle_plain`) within
      the host-libm tolerances below.

Both sides of (a) use the host's libm, so any difference there would be a
fault of the warp's lane logic.
"""

import ctypes
import os

import cuda_host_shim
import pytest
import torch

from openwurli_tpu_torch.circuits import tremolo
from openwurli_tpu_torch.kernels import engine as ek

torch.set_num_threads(1)

SR = 88200.0   # a rate the package data holds, E3's full settle on the card
N = 128
# The host's exp / log1p against torch's, carried through Newton's stop
# (|f| < 1e-9 V): every row within TOL, as the other warp steps' states
# (measured here: node and junction voltages 1.2e-12 V from the perturbed
# start, 2.1e-13 V after the reset; the counters exact). (a) shows that
# the one-thread step, built with the same host libm, is the warp step bit
# for bit.
TOL = 1e-9

# E3 before its warp redesign: one thread over the oscillator's rows.
HARNESS = r"""
namespace {
void settle_thread_kernel(const double* c, double* state, int n_steps) {
  double s[OSC_ROWS];
  for (int k = 0; k < OSC_ROWS; ++k) s[k] = state[k];
  SolverState st{s, s + 7, s + 11, s + 15, s + 16};
  const double w0[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int t = 0; t < n_steps; ++t) mna_step<7, 4, 2, 4>(c, st, w0);
  for (int k = 0; k < OSC_ROWS; ++k) state[k] = s[k];
}
}  // namespace
extern "C" int ow_test_settle_thread(const double* consts, double* state,
                                     int n_steps) {
  shim::launch(1, 1, settle_thread_kernel, consts, state, n_steps);
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
        tmp_path_factory.mktemp("settle_warp"), "settle_warp", extra=HARNESS)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ow_tremolo_settle.argtypes = [p, i, p, i, p]
    dll.ow_test_settle_thread.argtypes = [p, p, i]
    return dll


def _same(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int64), b.contiguous().view(torch.int64))


def _start(case):
    """The settle's perturbed start at SR; "nan": node 2 NaN."""
    st = ek.osc_flat(tremolo.perturbed_start(tremolo.make_params(SR)))
    if case == "nan":
        st[2] = float("nan")
    return st


def _block():
    return ek._trem_block_on(SR, "cpu")


def _e3(lib, st):
    c = _block()
    assert lib.ow_tremolo_settle(c.data_ptr(), c.numel(), st.data_ptr(), N,
                                 None) == 0
    return st


@pytest.mark.parametrize("case", ["perturbed", "nan"])
def test_warp_settle_equals_one_thread_settle(lib, case):
    st0 = _start(case)
    st_w, st_t = st0.clone(), st0.clone()
    _e3(lib, st_w)
    c = _block()
    assert lib.ow_test_settle_thread(c.data_ptr(), st_t.data_ptr(), N) == 0
    assert _same(st_w, st_t)
    assert torch.isfinite(st_t).all()
    diag = st_t[ek.OSC_ROWS - ek.N_DIAG:]
    # the NaN start resets once to the DC point; the perturbed one moves
    assert float(diag[2]) == (1.0 if case == "nan" else 0.0), diag
    assert not torch.equal(st_t[:ek.N_T], st0[:ek.N_T])


@pytest.mark.parametrize("case", ["perturbed", "nan"])
def test_warp_settle_matches_plain(lib, case):
    st0 = _start(case)
    st_k = _e3(lib, st0.clone())
    st_p = ek.settle_plain(SR, st0.clone(), N)
    err = float((st_k - st_p).abs().max())
    assert err <= TOL, err
