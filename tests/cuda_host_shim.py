"""A host stand-in for the CUDA runtime, so that a kernel source of
`openwurli_tpu_torch/csrc/` builds with g++ and runs on the CPU.

One std::thread per CUDA thread and a std::barrier per warp (for
__syncwarp, the shuffles and the votes, the ballot among them) and per block (__syncthreads);
__shared__ arrays are statics, which is right because the blocks of a
launch run one after another. `build` writes the header as
cuda_runtime.h beside the source, rewrites each `kernel<<<blocks,
threads, ...>>>(` as `shim::launch(blocks, threads, kernel, `, appends
`extra` (C++ that may call the source's own device functions) and
compiles a shared library with FMA contraction off, as nvcc's -fmad=false.
The host's libm stands in for CUDA's, so a kernel built here equals
another built here bit for bit where both run the same arithmetic.
"""

import ctypes
import os
import re
import shutil
import subprocess

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
#define __noinline__ __attribute__((noinline))
#define __forceinline__ inline
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
// The shuffles and votes exchange through two banks of slots in turn, so
// that each needs one barrier: a bank is written again only two exchanges
// later, after every lane has passed the exchange between, and so has read
// it.
struct Warp {
  explicit Warp(int n) : bar(n) {}
  std::barrier<> bar;
  uint64_t slot[2][32];
};
inline thread_local Warp* warp;
inline thread_local std::barrier<>* block;
inline thread_local int lane;
inline thread_local int bank;
inline uint64_t* exchange(uint64_t bits) {
  uint64_t* s = warp->slot[bank];
  bank ^= 1;
  s[lane] = bits;
  warp->bar.arrive_and_wait();
  return s;
}
// Blocks run one after another, so __shared__ arrays can be statics. A
// launch of fewer than 32 threads is one partial warp.
template <class K, class... A>
void launch(int blocks, int threads, K kernel, A... args) {
  blockDim.x = threads;
  gridDim.x = blocks;
  for (int b = 0; b < blocks; ++b) {
    std::vector<std::unique_ptr<Warp>> warps;
    for (int w = 0; w * 32 < threads; ++w)
      warps.emplace_back(new Warp(threads - 32 * w < 32 ? threads - 32 * w
                                                        : 32));
    std::barrier<> bar(threads);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        block = &bar;
        warp = warps[t / 32].get();
        lane = t % 32;
        bank = 0;
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
  const uint64_t* s = shim::exchange(p);
  bool any = false;
  for (int i = 0; i < (int)blockDim.x - (int)(threadIdx.x & ~31u) && i < 32;
       ++i)
    any = any || s[i];
  return any;
}
inline bool __all_sync(unsigned m, bool p) { return !__any_sync(m, !p); }
inline unsigned __ballot_sync(unsigned, bool p) {
  const uint64_t* s = shim::exchange(p);
  unsigned bits = 0;
  for (int i = 0; i < (int)blockDim.x - (int)(threadIdx.x & ~31u) && i < 32;
       ++i)
    bits |= s[i] ? 1u << i : 0u;
  return bits;
}
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  bits = shim::exchange(bits)[(shim::lane & ~(width - 1)) +
                              (src & (width - 1))];
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
inline long long __double_as_longlong(double d) {
  long long u;
  std::memcpy(&u, &d, 8);
  return u;
}
inline double __longlong_as_double(long long u) {
  double d;
  std::memcpy(&d, &u, 8);
  return d;
}
inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, 5); }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, 5);
}
inline int min(int a, int b) { return a < b ? a : b; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline long long clock64() { return 0; }
"""

_LAUNCH = re.compile(
    r"([\w:]+(?:<[^<>;]*>)?)\s*<<<([^,]+),\s*([^,]+),[^>]*>>>\(")
_INCLUDE_CU = re.compile(r'^#include "([^"]+\.cu)"$', re.M)


def have_gxx():
    return shutil.which("g++") is not None


def build(src_path, out_dir, name, extra="", launches=None):
    """Build `src_path` (a .cu) against the shim into out_dir/lib<name>.so
    and load it; `launches`, when given, is the number of kernel launches
    the source must hold. A `#include "x.cu"` (a path from the source's
    folder) is expanded in place, so that its launches are rewritten too."""
    (out_dir / "cuda_runtime.h").write_text(SHIM_H)
    with open(src_path) as f:
        src = f.read()
    here = os.path.dirname(os.path.abspath(src_path))
    src = _INCLUDE_CU.sub(
        lambda m: open(os.path.join(here, m.group(1))).read(), src)
    src, n = _LAUNCH.subn(r"shim::launch(\2, \3, \1, ", src)
    assert launches is None or n == launches, (src_path, n)
    cpp = out_dir / f"{name}.cpp"
    cpp.write_text(src + extra)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", f"-I{out_dir}", "-o", str(lib), str(cpp)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(lib))
