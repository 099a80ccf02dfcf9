"""A host stand-in for the CUDA runtime, so that a kernel source of
`openwurli_tpu_torch/csrc/` builds with g++ and runs on the CPU.

Every CUDA thread of a launch is a fiber on the calling thread, with a
stack of its own, switched by hand (a few instructions: the callee-saved
registers and the stack pointer); a barrier per warp (for __syncwarp, the
shuffles and the votes, the ballot among them), per block (__syncthreads)
and per cluster parks each arriving fiber and runs the others in turn
until the last one arrives. The blocks of a launch run one after another,
except that the blocks of a thread-block cluster (a kernel declared with
__cluster_dims__) run at once. Each block has its own shared memory:
`build` rewrites every `__shared__` declaration into a reference to the
block's arena (shim::shared), so that cluster.map_shared_rank reaches
another block's copy at the same offset. `build` writes the header as
cuda_runtime.h (and a cooperative_groups.h) beside the source, rewrites
each `kernel<<<blocks, threads, ...>>>(` as `shim::launch(blocks, threads,
kernel, ` (`shim::launch_cluster(size, ...` for a cluster kernel), appends
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
#include <sys/mman.h>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#define __cluster_dims__(...)
#define __global__
#define __device__
#define __constant__ static const
#define __noinline__ __attribute__((noinline))
#define __forceinline__ inline
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
typedef void* cudaStream_t;
struct alignas(16) float4 { float x, y, z, w; };
struct uint2 { uint32_t x, y; };
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local Dim3 threadIdx, blockIdx;
inline Dim3 blockDim, gridDim;
// shim_switch(&from_sp, to_sp): saves the callee-saved registers, the SSE
// and x87 control words and the stack pointer of the running fiber, and
// resumes the fiber whose stack pointer is to_sp
extern "C" void shim_switch(void** from_sp, void* to_sp);
asm(R"(
.text
.p2align 4
.weak shim_switch
.type shim_switch, @function
shim_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  subq $8, %rsp
  stmxcsr (%rsp)
  fnstcw 4(%rsp)
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  ldmxcsr (%rsp)
  fldcw 4(%rsp)
  addq $8, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
.size shim_switch, .-shim_switch
)");
namespace shim {
struct Barrier {
  explicit Barrier(int n) : n(n) {}
  void arrive_and_wait();
  int n, count = 0;
  unsigned gen = 0;
};
// The shuffles and votes exchange through two banks of slots in turn, so
// that each needs one barrier: a bank is written again only two exchanges
// later, after every lane has passed the exchange between, and so has read
// it.
struct Warp {
  explicit Warp(int n) : bar(n) {}
  Barrier bar;
  uint64_t slot[2][32];
};
inline thread_local Warp* warp;
inline thread_local Barrier* block;
inline thread_local int lane;
inline thread_local int bank;
// Shared memory: an arena per running block; each __shared__ declaration
// (build's rewrite) takes its offset, the same in every arena, on first
// use.
constexpr size_t kArena = size_t(4) << 20;
inline thread_local unsigned char* arena;          // this block's
inline thread_local unsigned char* const* cluster_arenas;
inline thread_local int cluster_rank;
inline thread_local Barrier* cluster_bar;
// A CUDA thread: its stack, its saved stack pointer, and the values of the
// thread-locals above that are its own
struct Fiber {
  void* sp = nullptr;
  Dim3 tid, bid;
  Warp* warp = nullptr;
  Barrier* block = nullptr;
  int lane = 0, bank = 0, rank = 0;
  unsigned char* arena = nullptr;
  bool done = false;
};
constexpr size_t kStack = size_t(512) << 10;
inline thread_local std::vector<Fiber>* fibers;
inline thread_local int cur;
inline thread_local int alive;
inline thread_local void* main_sp;
inline thread_local std::function<void()>* body;
inline void resume(const Fiber& f) {
  threadIdx = f.tid;
  blockIdx = f.bid;
  warp = f.warp;
  block = f.block;
  lane = f.lane;
  bank = f.bank;
  arena = f.arena;
  cluster_rank = f.rank;
}
// the next fiber after the running one that has not ended
inline int next_alive() {
  const int n = (int)fibers->size();
  int k = cur;
  do k = (k + 1) % n; while ((*fibers)[k].done && k != cur);
  return k;
}
// park the running fiber and run the next one
inline void yield() {
  Fiber& me = (*fibers)[cur];
  me.bank = bank;
  const int k = next_alive();
  if (k == cur) {
    std::fprintf(stderr, "shim: every other thread has ended; a barrier "
                 "can never complete\n");
    std::abort();
  }
  cur = k;
  resume((*fibers)[k]);
  shim_switch(&me.sp, (*fibers)[k].sp);
}
inline void Barrier::arrive_and_wait() {
  const unsigned g = gen;
  if (++count == n) {
    count = 0;
    ++gen;
    return;
  }
  while (gen == g) yield();
}
inline uint64_t* exchange(uint64_t bits) {
  uint64_t* s = warp->slot[bank];
  bank ^= 1;
  s[lane] = bits;
  warp->bar.arrive_and_wait();
  return s;
}
// a fiber's first frame: it runs the kernel, then hands over to the next
// fiber, or back to the launch after the last
extern "C" inline void shim_fiber_main() {
  (*body)();
  Fiber& me = (*fibers)[cur];
  me.done = true;
  void* dead;
  if (--alive == 0) shim_switch(&dead, main_sp);
  cur = next_alive();
  resume((*fibers)[cur]);
  shim_switch(&dead, (*fibers)[cur].sp);
}
inline char* stack_at(size_t i) {
  static std::vector<char*> pool;
  while (pool.size() <= i) {
    void* p = mmap(nullptr, kStack, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) std::abort();
    pool.push_back(static_cast<char*>(p));
  }
  return pool[i];
}
// a new fiber's stack: shim_switch's frame, its return into
// shim_fiber_main, aligned as a call would leave it
inline void* first_sp(char* stack) {
  auto* top = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(stack + kStack) & ~uintptr_t(15)));
  uint64_t* sp = top - 2;
  sp[0] = reinterpret_cast<uint64_t>(&shim_fiber_main);
  sp[1] = 0;
  sp -= 6;  // rbp rbx r12 r13 r14 r15
  for (int i = 0; i < 6; ++i) sp[i] = 0;
  sp -= 1;
  uint32_t cw[2] = {0x1F80u, 0x037Fu};  // mxcsr, x87 control word
  std::memcpy(sp, cw, sizeof(cw));
  return sp;
}
inline size_t arena_top = 0;
template <class T, int ID>
T& shared() {
  static const size_t off = [] {
    const size_t a = arena_top;
    arena_top += (sizeof(T) + 63) & ~size_t(63);
    if (a + sizeof(T) > kArena) std::abort();
    return a;
  }();
  return *reinterpret_cast<T*>(arena + off);
}
inline unsigned char* arena_at(int i) {
  static std::vector<unsigned char*> pool;
  while ((int)pool.size() <= i) {
    auto* a = static_cast<unsigned char*>(std::aligned_alloc(64, kArena));
    std::memset(a, 0, kArena);
    pool.push_back(a);
  }
  return pool[i];
}
// The blocks of a cluster of `cluster` blocks run at once, the clusters
// one after another (a plain launch: clusters of one block). A launch of
// fewer than 32 threads is one partial warp.
template <class K, class... A>
void launch_cluster(int cluster, int blocks, int threads, K kernel,
                    A... args) {
  blockDim.x = threads;
  gridDim.x = blocks;
  std::function<void()> run = [&] { kernel(args...); };
  for (int b0 = 0; b0 < blocks; b0 += cluster) {
    const int nb = blocks - b0 < cluster ? blocks - b0 : cluster;
    std::vector<unsigned char*> arenas;
    std::vector<std::unique_ptr<Barrier>> bars;
    std::vector<std::vector<std::unique_ptr<Warp>>> warps(nb);
    for (int r = 0; r < nb; ++r) {
      arenas.push_back(arena_at(r));
      bars.emplace_back(new Barrier(threads));
      for (int w = 0; w * 32 < threads; ++w)
        warps[r].emplace_back(new Warp(threads - 32 * w < 32
                                           ? threads - 32 * w : 32));
    }
    Barrier cbar(nb * threads);
    std::vector<Fiber> fs(nb * threads);
    for (int r = 0; r < nb; ++r)
      for (int t = 0; t < threads; ++t) {
        Fiber& f = fs[r * threads + t];
        f.tid.x = t;
        f.bid.x = b0 + r;
        f.block = bars[r].get();
        f.warp = warps[r][t / 32].get();
        f.lane = t % 32;
        f.rank = r;
        f.arena = arenas[r];
        f.sp = first_sp(stack_at(r * threads + t));
      }
    cluster_arenas = arenas.data();
    cluster_bar = &cbar;
    fibers = &fs;
    body = &run;
    cur = 0;
    alive = nb * threads;
    resume(fs[0]);
    shim_switch(&main_sp, fs[0].sp);
  }
}
template <class K, class... A>
void launch(int blocks, int threads, K kernel, A... args) {
  launch_cluster(1, blocks, threads, kernel, args...);
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
inline int __ffs(int x) { return __builtin_ffs(x); }
"""

COOPERATIVE_GROUPS_H = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  static unsigned block_rank() { return shim::cluster_rank; }
  static void sync() { shim::cluster_bar->arrive_and_wait(); }
  template <class T>
  static T* map_shared_rank(T* addr, int rank) {
    const auto* p = reinterpret_cast<const unsigned char*>(addr);
    return reinterpret_cast<T*>(shim::cluster_arenas[rank] +
                                (p - shim::arena));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""

_LAUNCH = re.compile(
    r"([\w:]+(?:<[^<>;]*>)?)\s*<<<([^,]+),\s*([^,]+),[^>]*>>>\(")
_INCLUDE_CU = re.compile(r'^#include "([^"]+\.cu)"$', re.M)
_CLUSTER = re.compile(r"__cluster_dims__\(([^,()]+),[^()]*\)\s*"
                      r"(?:__launch_bounds__\([^()]*\)\s*)?(\w+)\s*\(")
_SHARED = re.compile(r"^([ \t]*)__shared__\s+(?:__align__\(\d+\)\s+)?"
                     r"([^;{}]+);", re.M)


def _split_top(text):
    """text split at the commas outside brackets and parentheses."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "[(" and 1 or (ch in "])" and -1 or 0)
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def _per_block_shared(src):
    """Each `__shared__ T a[..], b[..];` as references into the running
    block's arena: `auto& a = shim::shared<T[..], id>(); ...`."""
    count = [0]

    def one(m):
        indent, decls = m.group(1), _split_top(m.group(2))
        head = decls[0]
        cut = head.find("[")
        base = head if cut < 0 else head[:cut]
        typ = re.match(r"(.*?)(\w+)\s*$", base, re.S).group(1)
        decls[0] = head[len(typ):]
        typ = " ".join(typ.split())
        out = []
        for d in decls:
            d = " ".join(d.split())
            nm = re.match(r"(\w+)", d).group(1)
            count[0] += 1
            out.append(f"auto& {nm} = shim::shared<{typ}{d[len(nm):]}, "
                       f"{count[0]}>();")
        return indent + " ".join(out)

    return _SHARED.sub(one, src)


def have_gxx():
    return shutil.which("g++") is not None


def build(src_path, out_dir, name, extra="", launches=None):
    """Build `src_path` (a .cu) against the shim into out_dir/lib<name>.so
    and load it; `launches`, when given, is the number of kernel launches
    the source must hold. A `#include "x.cu"` (a path from the source's
    folder) is expanded in place, so that its launches are rewritten too."""
    (out_dir / "cuda_runtime.h").write_text(SHIM_H)
    (out_dir / "cooperative_groups.h").write_text(COOPERATIVE_GROUPS_H)
    with open(src_path) as f:
        src = f.read()
    here = os.path.dirname(os.path.abspath(src_path))
    src = _INCLUDE_CU.sub(
        lambda m: open(os.path.join(here, m.group(1))).read(), src)
    clusters = {m.group(2): m.group(1) for m in _CLUSTER.finditer(src)}

    def launch(m):
        kernel, blocks, threads = m.groups()
        size = clusters.get(kernel.split("<")[0])
        if size is None:
            return f"shim::launch({blocks}, {threads}, {kernel}, "
        return (f"shim::launch_cluster(({size}), {blocks}, {threads}, "
                f"{kernel}, ")

    src, n = _LAUNCH.subn(launch, src)
    assert launches is None or n == launches, (src_path, n)
    cpp = out_dir / f"{name}.cpp"
    cpp.write_text(_per_block_shared(src + extra))
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", f"-I{out_dir}", "-o", str(lib), str(cpp)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(lib))
