// Probe kernel (P1) for Hopper: a timed loop of `iters` iterations over one
// small body, one thread per lane, the lane's state resident on chip for
// the whole launch.
//
// Replaces: tools/tpu_probe.py, `probe_loop_body` (`build` / `kernel`), the
// skeleton every probe of that tool runs through.
//
// What bounds it on this card: nothing but the body itself. No input is
// read but one float and, for the matvec body, an (M, M) matrix; 128 floats
// are written at the end. Time is iterations × the latency of the body's
// dependent operations in one thread, which is what the probes are there to
// read: they are the primitive patterns of the mono chain (dependent
// multiply-adds, an exp chain, a small matvec, a per-stream elimination),
// and their per-iteration times say what a redesign of that kernel can
// expect from one thread, one warp or a full block.
//
// What the design does about it: one `template <int BODY>` kernel. A lane's
// SUB state rows live in a per-thread array (registers where the indexing is
// static, local memory otherwise), the matvec's matrix in shared memory. The
// state is filled from x[0] inside the kernel and row 0 of state 0 is
// written out for the first 128 lanes, as the reference skeleton does.
// Bodies that leave no trace in that row keep their work alive through
// `aux`: the empty loop's carry, the dynamic store's buffer; the eliminations
// write their whole final state there, so that a comparison covers it. Built with
// -fmad=false like the rest of the library, so `v·a + b` is a multiply and
// an add, and every body equals its plain torch version bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Body { EMPTY, CHAIN, EXPCHAIN, DOTCHAIN, GE16, GE16_FLAT, DYNSTORE,
            N_BODIES };

constexpr int MAX_SUB = 128;  // state rows per lane (chain, exp, dynstore)
constexpr int MAX_M = 32;     // matvec size: 8 or 32
constexpr int GE_N = 16, GE_W = 17;  // augmented 16×17 system per lane
constexpr int OUT_LANES = 128;

// The chain bodies walk the lane's rows eight at a time, so that eight
// independent dependency chains are in flight, as the rows of a block are
// on the reference's vector unit.
constexpr int GROUP = 8;

// v ← mat · v, `depth` times per iteration, each row summed in index order.
// M is static, so the vector sits in registers and the products are
// unrolled, as the chain's own small matvecs are. A compiler barrier before
// each product makes it load its M² entries from shared memory again, as a
// chain does whose loop body is far too large to keep them in registers.
// Without it the compiler hoists all the loads out of the loop and, at
// M = 32, spills 3 KB of them (620 µs per iteration).
template <int M>
__device__ float dot_chain(const float* s_mat, float x0, int iters,
                           int depth) {
  float v[M], nv[M];
#pragma unroll
  for (int r = 0; r < M; ++r) v[r] = x0;
  for (int it = 0; it < iters; ++it) {
    for (int d = 0; d < depth; ++d) {
      asm volatile("" ::: "memory");
#pragma unroll
      for (int r = 0; r < M; ++r) {
        float acc = s_mat[r * M] * v[0];
#pragma unroll
        for (int k = 1; k < M; ++k) acc = acc + s_mat[r * M + k] * v[k];
        nv[r] = acc;
      }
#pragma unroll
      for (int r = 0; r < M; ++r) v[r] = nv[r];
    }
  }
  return v[0];
}

template <int BODY>
__global__ void probe_kernel(const float* __restrict__ x,
                             const float* __restrict__ mat, int iters,
                             int depth, int sub, int lanes,
                             float* __restrict__ out,
                             float* __restrict__ aux) {
  __shared__ float s_mat[MAX_M * MAX_M];
  if constexpr (BODY == DOTCHAIN) {
    for (int i = threadIdx.x; i < sub * sub; i += blockDim.x)
      s_mat[i] = mat[i];
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const float x0 = x[0];
  float row0 = x0;

  if constexpr (BODY == EMPTY) {
    float c = 0.0f;
    for (int it = 0; it < iters; ++it) c = c + 1.0f;
    aux[lane] = c;
  } else if constexpr (BODY == CHAIN || BODY == EXPCHAIN) {
    float s[MAX_SUB];
    for (int r = 0; r < sub; ++r) s[r] = x0;
    for (int it = 0; it < iters; ++it) {
      for (int r0 = 0; r0 < sub; r0 += GROUP) {
        float v[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) v[j] = s[r0 + j];
        for (int d = 0; d < depth; ++d) {
#pragma unroll
          for (int j = 0; j < GROUP; ++j)
            v[j] = BODY == CHAIN ? v[j] * 1.0000001f + 0.0000001f
                                 : expf(v[j] * 1e-6f);
        }
#pragma unroll
        for (int j = 0; j < GROUP; ++j) s[r0 + j] = v[j];
      }
    }
    row0 = s[0];
  } else if constexpr (BODY == DOTCHAIN) {
    row0 = sub == 8 ? dot_chain<8>(s_mat, x0, iters, depth)
                    : dot_chain<MAX_M>(s_mat, x0, iters, depth);
  } else if constexpr (BODY == GE16) {
    // Row form: normalise row k by 1/(pivot + 1), store it, eliminate the
    // rows below with their column-k entry as the factor.
    float a[GE_N][GE_W];
#pragma unroll
    for (int i = 0; i < GE_N; ++i)
#pragma unroll
      for (int j = 0; j < GE_W; ++j) a[i][j] = x0;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < GE_N; ++i)
#pragma unroll
        for (int j = 0; j < GE_W; ++j) a[i][j] = a[i][j] + 0.0f;
#pragma unroll
      for (int k = 0; k < GE_N; ++k) {
        const float inv = 1.0f / (a[k][k] + 1.0f);
#pragma unroll
        for (int j = 0; j < GE_W; ++j) a[k][j] = a[k][j] * inv;
#pragma unroll
        for (int r = k + 1; r < GE_N; ++r) {
          const float f = a[r][k];
#pragma unroll
          for (int j = 0; j < GE_W; ++j) a[r][j] = a[r][j] - f * a[k][j];
        }
      }
    }
    // the whole final state, (16·17, lanes): row 17·i + j is a[i][j]
#pragma unroll
    for (int i = 0; i < GE_N; ++i)
#pragma unroll
      for (int j = 0; j < GE_W; ++j)
        aux[(size_t)(i * GE_W + j) * lanes + lane] = a[i][j];
    row0 = a[0][0];
  } else if constexpr (BODY == GE16_FLAT) {
    // Flat form: every step updates the whole block, the rows at and above
    // the pivot through a 0.0 mask; row k itself is not normalised.
    float a[GE_N][GE_W];
#pragma unroll
    for (int i = 0; i < GE_N; ++i)
#pragma unroll
      for (int j = 0; j < GE_W; ++j) a[i][j] = x0;
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < GE_N; ++i)
#pragma unroll
        for (int j = 0; j < GE_W; ++j) a[i][j] = a[i][j] + 0.0f;
#pragma unroll
      for (int k = 0; k < GE_N; ++k) {
        const float inv = 1.0f / (a[k][k] + 1.0f);
        float rk[GE_W], f[GE_N];
#pragma unroll
        for (int j = 0; j < GE_W; ++j) rk[j] = a[k][j] * inv;
#pragma unroll
        for (int i = 0; i < GE_N; ++i) f[i] = (i > k ? 1.0f : 0.0f) * a[i][k];
#pragma unroll
        for (int i = 0; i < GE_N; ++i)
#pragma unroll
          for (int j = 0; j < GE_W; ++j) a[i][j] = a[i][j] - f[i] * rk[j];
      }
    }
    // the whole final state, (16, 17·lanes): a[i][j] at [i][j·lanes + lane]
#pragma unroll
    for (int i = 0; i < GE_N; ++i)
#pragma unroll
      for (int j = 0; j < GE_W; ++j)
        aux[((size_t)i * GE_W + j) * lanes + lane] = a[i][j];
    row0 = a[0][0];
  } else if constexpr (BODY == DYNSTORE) {
    // One row of a second state written at a row index that moves with the
    // iteration.
    float s[MAX_SUB], buf[MAX_SUB];
    for (int r = 0; r < sub; ++r) s[r] = buf[r] = x0;
    for (int it = 0; it < iters; ++it) {
      for (int r = 0; r < sub; ++r) s[r] = s[r] * 1.0000001f;
      buf[it % sub] = s[0];
    }
    for (int r = 0; r < sub; ++r) aux[(size_t)r * lanes + lane] = buf[r];
    row0 = s[0];
  }
  if (lane < OUT_LANES) out[lane] = row0;
}

template <int BODY>
int launch(const float* x, const float* mat, int iters, int depth, int sub,
           int lanes, int threads, float* out, float* aux,
           cudaStream_t stream) {
  const int blocks = (lanes + threads - 1) / threads;
  probe_kernel<BODY><<<blocks, threads, 0, stream>>>(x, mat, iters, depth,
                                                     sub, lanes, out, aux);
  return (int)cudaGetLastError();
}

}  // namespace

// body: index into kernels/probe.py BODIES. sub: state rows per lane (the
// matvec's M for DOTCHAIN; 16·17 for GE16, 16 for GE16_FLAT). lanes: threads
// in all, in blocks of `threads`. out: 128 floats. aux: (1, lanes) for EMPTY,
// (sub, lanes) for DYNSTORE, the final state for GE16 (16·17, lanes) and
// GE16_FLAT (16, 17·lanes), unused otherwise.
extern "C" int ow_probe(int body, const float* x, const float* mat, int iters,
                        int depth, int sub, int lanes, int threads, float* out,
                        float* aux, cudaStream_t stream) {
  if (body < 0 || body >= N_BODIES || iters < 0 || depth < 0 ||
      lanes < OUT_LANES || threads < 1 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  bool ok = true;
  switch (body) {
    case CHAIN: case EXPCHAIN:
      ok = sub > 0 && sub <= MAX_SUB && sub % GROUP == 0; break;
    case DOTCHAIN: ok = (sub == 8 || sub == MAX_M) && mat != nullptr; break;
    case GE16: ok = sub == GE_N * GE_W; break;
    case GE16_FLAT: ok = sub == GE_N; break;
    case DYNSTORE: ok = sub > 0 && sub <= MAX_SUB; break;
    default: break;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  switch (body) {
    case EMPTY:
      return launch<EMPTY>(x, mat, iters, depth, sub, lanes, threads, out,
                           aux, stream);
    case CHAIN:
      return launch<CHAIN>(x, mat, iters, depth, sub, lanes, threads, out,
                           aux, stream);
    case EXPCHAIN:
      return launch<EXPCHAIN>(x, mat, iters, depth, sub, lanes, threads, out,
                              aux, stream);
    case DOTCHAIN:
      return launch<DOTCHAIN>(x, mat, iters, depth, sub, lanes, threads, out,
                              aux, stream);
    case GE16:
      return launch<GE16>(x, mat, iters, depth, sub, lanes, threads, out,
                          aux, stream);
    case GE16_FLAT:
      return launch<GE16_FLAT>(x, mat, iters, depth, sub, lanes, threads,
                               out, aux, stream);
    default:
      return launch<DYNSTORE>(x, mat, iters, depth, sub, lanes, threads, out,
                              aux, stream);
  }
}
