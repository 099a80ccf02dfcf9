"""Properties of the voice bank that the K1/K3 kernel's eight threads per
lane (`voice_bank_kernel` in `csrc/voice_bank.cu`: modes on threads for the
group's state, samples on threads for the pickup) relies on, checked on the
plain torch version, and the kernel's own source run on the CPU:

  (a) modes are independent: changing one mode's parameters leaves every
      other mode's s, c, env and drift rows bit-identical; only the jitter
      LCG word and the stage sum couple them;
  (b) the carried jitter word is mode 6's composed draw, which equals 7
      sequential LCG steps per tick (none before a lane's onset);
  (c) lanes are independent: NaN or inf in one lane's parameters leaves the
      other lanes' output and state bit-identical;
  (d) padding row 7 is renormed at tile ends and never advanced or drifted;
  (e) `csrc/voice_bank.cu` compiled with g++ against a host stand-in for
      the CUDA runtime (one std::thread per CUDA thread, a std::barrier per
      warp for __syncwarp and the shuffles) equals the plain version bit
      for bit where no libm call reaches the compared values, and within a
      stated tolerance where the host's libm and torch's differ.

Small shapes: seconds on one core.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from openwurli_tpu_torch.kernels import voice_bank as vb

torch.set_num_threads(1)

SR = 44100.0
ROWS = {"s": vb._S0, "c": vb._C0, "env": vb._E0, "drift": vb._D0}
MODE_ROWS = (vb.ROW_COSM1, vb.ROW_SIN, vb.ROW_PHASE, vb.ROW_AMP,
             vb.ROW_DECAYM1, vb.ROW_DRATE, vb.ROW_DM1, vb.ROW_DM8M1)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _params(lanes, seed, onsets=None, releases=None):
    rng = np.random.default_rng(seed)
    notes = rng.integers(36, 100, lanes).astype(np.float64)
    vels = rng.uniform(0.3, 1.0, lanes)
    params, _ = vb.make_kernel_params(notes, vels, SR, lanes=lanes,
                                      onsets=onsets, releases=releases)
    return params


def _k3_params(lanes=8, seed=1):
    """Staggered onsets and releases early enough that the legacy stage
    and the damper ramps run inside a few hundred samples."""
    return _params(lanes, seed, onsets=16 * np.arange(lanes),
                   releases=200.0 + 24.0 * np.arange(lanes))


def _plain(params, n, events, state=None, steady="real"):
    steady = vb.steady_limits(params) if steady == "real" else steady
    return vb.render_voice_bank_plain(params, n, steady=steady, state=state,
                                      return_state=True, events=events)


@pytest.mark.parametrize("mode", [0, 3, 6])
def test_modes_are_independent(mode):
    params = _k3_params()
    bumped = params.clone()
    for row in MODE_ROWS:
        bumped[row, mode] *= 1.001
    _, st = _plain(params, 512, True)
    _, st_b = _plain(bumped, 512, True)
    others = [m for m in range(vb.SUBLANES) if m != mode]
    for name, r0 in ROWS.items():
        rows = [r0 + m for m in others]
        assert torch.equal(_bits(st[rows]), _bits(st_b[rows])), name
        assert not torch.equal(st[r0 + mode], st_b[r0 + mode]) \
            or name == "drift", name
    assert torch.equal(_bits(st[vb._I0:]), _bits(st_b[vb._I0:]))


def _lcg_steps(x, k):
    for _ in range(k):
        x = (x * vb.LCG_A + vb.LCG_C) & 0xFFFFFFFF
    return x


def test_jitter_word_is_mode_six_draw():
    for k in range(1, vb.NUM_MODES + 1):
        for x in (0, 1, 12345, 0xFFFFFFFF):
            assert (vb.LCG_A_POW[k] * x + vb.LCG_C_ACC[k]) & 0xFFFFFFFF \
                == _lcg_steps(x, k)
    onsets = [0, 32, 64, 240]
    params = _params(4, 2, onsets=onsets)
    seeds = params[vb.ROW_RNG0, 0].contiguous().view(torch.int32)
    n = 256
    _, st = _plain(params, n, True)
    words = st[vb._I0].contiguous().view(torch.int32)
    for lane, on in enumerate(onsets):
        ticks = len(range(on, n, vb.JITTER_SUBSAMPLE))
        want = _lcg_steps(int(seeds[lane]) & 0xFFFFFFFF, vb.NUM_MODES * ticks)
        assert int(words[lane]) & 0xFFFFFFFF == want, lane


@pytest.mark.parametrize("events", [False, True], ids=["K1", "K3"])
def test_lanes_are_independent(events):
    params = _k3_params() if events else _params(8, 3)
    bad = params.clone()
    bad[vb.ROW_COSM1, 0, 2] = float("nan")
    bad[vb.ROW_AMP, 3, 5] = float("inf")
    bad[vb.ROW_SCAL, 6, 6] = float("nan")  # displacement scale
    out, st = _plain(params, 512, events)
    out_b, st_b = _plain(bad, 512, events)
    keep = [0, 1, 3, 4, 7]
    assert torch.equal(_bits(out[:, keep]), _bits(out_b[:, keep]))
    assert torch.equal(_bits(st[:, keep]), _bits(st_b[:, keep]))
    for lane in (2, 5, 6):
        assert not torch.isfinite(out_b[:, lane]).all(), lane


def test_padding_row_is_renormed_never_advanced():
    lanes = 8
    onsets = [0] * (lanes - 1) + [4096]  # the last lane starts after n
    params = _params(lanes, 4, onsets=onsets,
                     releases=[300.0 + 50 * k for k in range(lanes)])
    clean = vb.init_bank_state(params)
    state = clean.clone()
    pad = {"s": 0.3, "c": -0.4, "env": 0.7, "drift": 0.05}
    for name, val in pad.items():
        state[ROWS[name] + 7] = val
    n = 2048  # tiles of 512: renorms at 1024 and 2048
    assert vb.render_tile(lanes, n, True) == 512
    out, st = _plain(params, n, True, state=state)
    out_c, _ = _plain(params, n, True, state=clean)
    assert torch.equal(_bits(out), _bits(out_c))
    for name in ("env", "drift"):
        assert torch.equal(_bits(st[ROWS[name] + 7]),
                           _bits(state[ROWS[name] + 7])), name
    s, c = state[vb._S0 + 7].clone(), state[vb._C0 + 7].clone()
    s_want, c_want = s.clone(), c.clone()
    for n_end in (1024, 2048):
        act = torch.tensor([n_end - 1 >= on for on in onsets])
        r_inv = torch.rsqrt(torch.clamp(s_want * s_want + c_want * c_want,
                                        min=1e-30))
        s_want = torch.where(act, s_want * r_inv, s_want)
        c_want = torch.where(act, c_want * r_inv, c_want)
    assert torch.equal(_bits(st[vb._S0 + 7]), _bits(s_want))
    assert torch.equal(_bits(st[vb._C0 + 7]), _bits(c_want))
    assert not torch.equal(s_want[:-1], s[:-1])  # renormed once active
    assert torch.equal(s_want[-1:], s[-1:])


# ─────────────── (e) the kernel's source under a host shim ───────────────

SHIM_H = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __constant__ static const
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
typedef void* cudaStream_t;
struct alignas(16) float4 { float x, y, z, w; };
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx, blockIdx;
inline Dim3 blockDim, gridDim;
namespace shim {
struct Warp { std::barrier<> bar{32}; uint64_t slot[32]; };
inline thread_local Warp* warp;
inline thread_local std::barrier<>* block;
inline thread_local int lane;
// Blocks run one after another, so __shared__ arrays can be statics.
template <class K, class... A>
void launch(int blocks, int threads, K kernel, A... args) {
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    std::vector<std::unique_ptr<Warp>> warps;
    for (int w = 0; w < threads / 32; ++w) warps.emplace_back(new Warp);
    std::barrier<> bar(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        block = &bar;
        warp = warps[t / 32].get();
        lane = t % 32;
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
}  // namespace shim
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim::warp->bar.arrive_and_wait();
}
inline void __syncthreads() { shim::block->arrive_and_wait(); }
inline bool __any_sync(unsigned, bool p) {
  shim::warp->slot[shim::lane] = p;
  shim::warp->bar.arrive_and_wait();
  bool any = false;
  for (int i = 0; i < 32; ++i) any = any || shim::warp->slot[i];
  shim::warp->bar.arrive_and_wait();
  return any;
}
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  shim::warp->slot[shim::lane] = bits;
  shim::warp->bar.arrive_and_wait();
  bits = shim::warp->slot[(shim::lane & ~(width - 1)) + (src & (width - 1))];
  shim::warp->bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
"""


@pytest.fixture(scope="module")
def shim_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel against the host shim")
    d = tmp_path_factory.mktemp("vb_shim")
    (d / "cuda_runtime.h").write_text(SHIM_H)
    src = open(os.path.join(os.path.dirname(vb.__file__), "..", "csrc",
                            "voice_bank.cu")).read()
    src, n = re.subn(r"([\w:]+(?:<[^<>;]*>)?)<<<([^,]+),\s*([^,]+),[^>]*>>>\(",
                     r"shim::launch(\2, \3, \1, ", src)
    assert n == 1
    (d / "voice_bank.cpp").write_text(src)
    lib = d / "libvb_shim.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", f"-I{d}", "-o", str(lib),
                    str(d / "voice_bank.cpp")], check=True,
                   capture_output=True)
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.ow_voice_bank.argtypes = [p, p, p, p, i, i, i, i, f, f, p]
    dll.ow_voice_bank_events.argtypes = [p, p, p, p, i, i, i, i, f, f, f, p]
    return dll


def _shim_render(dll, params, n, steady, events):
    """The wrapper's CUDA branch with the shim library in its place."""
    lanes = params.shape[-1]
    state = vb.init_bank_state(params)
    t_tile = vb.render_tile(lanes, n, True)
    out = torch.empty((n, lanes))
    st = torch.empty_like(state)
    f = ctypes.c_float
    args = (params.data_ptr(), state.data_ptr(), out.data_ptr(),
            st.data_ptr(), lanes, n, t_tile, 0, f(steady[0]), f(steady[1]))
    if events:
        err = dll.ow_voice_bank_events(*args, f(vb._min_release(params)),
                                       None)
    else:
        err = dll.ow_voice_bank(*args, None)
    assert err == 0
    return out, st


# (lanes, events, schedule, steady, displacement gain): "quiet" = past
# steady from sample 0 (no cosf/powf), outputs far below the knee (no
# tanhf), no release (no expf) and no renorm inside 512 samples: only IEEE
# +, −, ×, ÷ reach the compared values, so the kernel must equal the plain
# version bit for bit. A displacement gain of 60 drives the pickup past
# its knee (tanhf).
SHIM_CASES = {
    "K1 32 lanes, quiet": (32, False, None, "quiet", 1.0),
    "K1 19 lanes (ragged warp), quiet": (19, False, None, "quiet", 1.0),
    "K3 24 lanes, onsets, quiet": (24, True, "onsets", "quiet", 1.0),
    "K1 16 lanes, onset and noise": (16, False, None, "real", 1.0),
    "K3 16 lanes across min_release": (16, True, "releases", "real", 1.0),
    "K3 12 lanes, saturated": (12, True, "releases", "real", 60.0),
}


@pytest.mark.parametrize("case", list(SHIM_CASES))
def test_kernel_source_under_host_shim(shim_lib, case, monkeypatch):
    lanes, events, schedule, steady, gain = SHIM_CASES[case]
    onsets = 16 * np.arange(lanes) if schedule else None
    releases = 200.0 + 24.0 * np.arange(lanes) \
        if schedule == "releases" else None
    params = _params(lanes, lanes, onsets=onsets, releases=releases)
    params[vb.ROW_SCAL, 6] *= gain
    steady = vb.steady_limits(params) if steady == "real" else (0, 0)
    n = 512
    out, st = _shim_render(shim_lib, params, n, steady, events)
    knee_args = []
    tanh = torch.tanh

    def recorded_tanh(x):  # the plain pickup's only tanh: (|y| − knee) / …
        knee_args.append(float(x.max()))
        return tanh(x)

    monkeypatch.setattr(torch, "tanh", recorded_tanh)
    ref, ref_st = _plain(params, n, events, steady=steady)
    monkeypatch.undo()
    assert vb._min_release(params) < n or schedule != "releases"
    assert torch.equal(_bits(st[vb._I0:]), _bits(ref_st[vb._I0:]))
    assert (max(knee_args) > 0.0) == (gain > 1.0)
    if case.endswith("quiet"):
        assert len(knee_args) == n // 8 and max(knee_args) < 0.0
        assert torch.equal(_bits(out), _bits(ref))
        assert torch.equal(_bits(st), _bits(ref_st))
    else:
        # host libm against torch's cos/pow/exp/tanh: measured up to
        # 2.4e-6 of the peak on the output and 1.3e-6 of each state row's
        # peak
        peak = ref.abs().max()
        assert (out - ref).abs().max() <= 1e-5 * peak
        rows = ref_st[:vb._I0]
        scale = rows.abs().amax(1, keepdim=True).clamp(min=1e-30)
        assert ((st[:vb._I0] - rows).abs() <= 1e-5 * scale).all()
