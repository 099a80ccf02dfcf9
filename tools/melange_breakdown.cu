// Where one melange preamp step's time goes on the card: the step as one
// thread walks it (melange_step, E2<melange>'s thread form) and as a warp
// runs it (melange_step_warp, E5<melange> and E2<melange, circuit>'s warp
// form), built and run by tools/torch_melange_breakdown.py.
//
// Each family has the kernel's own step and a stamped copy of it that
// reads the SM's cycle counter (clock64) between the step's parts and adds
// each part's cycles to a per-stream total:
//   draws      the key's two hashes, the ten normals, the noise injection
//   predictor  the history, sources and input, S, the LDR correction, p
//   newton     the Newton loop (its residual passes counted too)
//   corrector  the final currents, S_NI, the node update, the reset, the
//              state's writes
// The stamped copies run the same arithmetic in the same order, so they
// too equal the kernel bit for bit, which the tool checks; a stamp waits
// for nothing in flight, so a part is the cycles between the warp reaching
// one stamp and the next.

#include "../openwurli_tpu_torch/csrc/engine.cu"

namespace {

enum Part { PT_DRAWS, PT_PREDICT, PT_NEWTON, PT_CORRECT, PT_PASSES, N_PARTS };

__device__ __forceinline__ void stamp(long long* acc, int part,
                                      long long& t) {
  const long long now = clock64();
  acc[part] += now - t;
  t = now;
}

// melange_step with stamps
__device__ __noinline__ double melange_step_stamped(const double* mc,
                                                    double* ms, double g,
                                                    double x, double scale,
                                                    long long* acc) {
  long long t = clock64();
  constexpr int N = 13, M = 5, NR = 10;
  const int fb = (int)mc[ML_IDX], outn = (int)mc[ML_IDX + 1];
  const int row_in = (int)mc[ML_IDX + 2];
  const uint32_t k1 = (uint32_t)ms[MS_KEY], k2 = (uint32_t)ms[MS_KEY + 1];
  uint32_t n1, n2, s1, s2;
  threefry(k1, k2, 0u, 0u, &n1, &n2);
  threefry(k1, k2, 0u, 1u, &s1, &s2);
  double w_new[NR], i_r[NR], i_noise[N];
#pragma unroll 1
  for (int r = 0; r < NR; ++r) {
    w_new[r] = normal_draw(s1, s2, (uint32_t)r) * mc[ML_SIGMA + r] * scale;
    i_r[r] = w_new[r] + ms[MS_WPREV + r];
  }
  matvec(mc + ML_INJECT, i_r, i_noise, N, NR);
  stamp(acc, PT_DRAWS, t);
  const double gprev = ms[MS_GPREV];
  const double sm_k = g / (1.0 + mc[ML_S_FB_FB] * g);
  double v_pred[2][N], p[2][M];
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const double* v = ms + MS_V + N * r;
    double rhs[N], tt[N], vpb[N];
    matvec(mc + ML_A_HIST, v, rhs, N, N);
    rhs[fb] = rhs[fb] + (-gprev) * v[fb];
#pragma unroll 1
    for (int n = 0; n < N; ++n) rhs[n] = rhs[n] + mc[ML_WS_W + n];
    rhs[row_in] = rhs[row_in] + (r == 0 ? x : 0.0);
    matvec(mc + ML_N_I, ms + MS_I + M * r, tt, N, M);
#pragma unroll 1
    for (int n = 0; n < N; ++n) rhs[n] = rhs[n] + tt[n];
#pragma unroll 1
    for (int n = 0; n < N; ++n) rhs[n] = rhs[n] + (r == 0 ? i_noise[n] : 0.0);
    matvec(mc + ML_S, rhs, vpb, N, N);
#pragma unroll 1
    for (int n = 0; n < N; ++n)
      v_pred[r][n] = vpb[n] - (sm_k * vpb[fb]) * mc[ML_S_FB_COL + n];
    matvec(mc + ML_N_V, v_pred[r], p[r], M, N);
  }
  double kc[M * M];
#pragma unroll 1
  for (int k = 0; k < M * M; ++k)
    kc[k] = mc[ML_K + k] - sm_k * mc[ML_K_OUTER + k];
  double vnl[2][M], f[2][M];
  for (int r = 0; r < 2; ++r)
    for (int m = 0; m < M; ++m) vnl[r][m] = ms[MS_VNL + M * r + m];
  stamp(acc, PT_PREDICT, t);
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    acc[PT_PASSES] += 1;
    bool conv[2];
    for (int r = 0; r < 2; ++r) {
      double i[M], ki[M];
      mel_currents(mc, vnl[r], i);
      matvec(kc, i, ki, M, M);
      for (int m = 0; m < M; ++m) f[r][m] = vnl[r][m] - p[r][m] - ki[m];
      conv[r] = max_abs(f[r], M) < 1e-9;
    }
    if (conv[0] && conv[1]) break;
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {
      if (conv[r]) continue;
      double jac[M * M], dv[M];
      mel_jacobian(mc, kc, vnl[r], jac);
      ge_solve_f32<M>(jac, f[r], dv);
      for (int m = 0; m < M; ++m)
        vnl[r][m] = vnl[r][m] - jclip(dv[m], -0.5, 0.5);
    }
  }
  stamp(acc, PT_NEWTON, t);
  double v_new[2][N], i_new[2][M];
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    double s_ni[N], dot;
    mel_currents(mc, vnl[r], i_new[r]);
    matvec(mc + ML_S_NI, i_new[r], s_ni, N, M);
    matvec(mc + ML_SFB_NI, i_new[r], &dot, 1, M);
#pragma unroll 1
    for (int n = 0; n < N; ++n)
      v_new[r][n] =
          v_pred[r][n] + s_ni[n] - (sm_k * dot) * mc[ML_S_FB_COL + n];
  }
  const double out = v_new[0][outn] - v_new[1][outn];
  const bool bad = !finite(out);
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
#pragma unroll 1
    for (int n = 0; n < N; ++n)
      ms[MS_V + N * r + n] = bad ? mc[ML_V_DC + n] : v_new[r][n];
    for (int m = 0; m < M; ++m) {
      ms[MS_I + M * r + m] = bad ? mc[ML_I_DC + m] : i_new[r][m];
      ms[MS_VNL + M * r + m] = bad ? mc[ML_V_NL_DC + m] : vnl[r][m];
    }
  }
  ms[MS_GPREV] = g;
  ms[MS_KEY] = (double)n1;
  ms[MS_KEY + 1] = (double)n2;
  for (int r = 0; r < NR; ++r) ms[MS_WPREV + r] = w_new[r];
  stamp(acc, PT_CORRECT, t);
  return bad ? 0.0 : out;
}

// the one-thread scan: a thread per stream over melange_step (E5<melange>
// before its warp redesign), or over the stamped copy; x and out (n, G),
// the state (MS_ROWS, G), parts (N_PARTS, G)
constexpr int MB_BLOCK = 32;

template <bool STAMP>
__global__ void __launch_bounds__(MB_BLOCK)
mb_thread_kernel(const double* __restrict__ c, const double* __restrict__ x,
                 double* state, const double* __restrict__ g_ldr,
                 const double* __restrict__ noise_scale, double* out,
                 long long* parts, int n, int g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double s[MS_ROWS];
  for (int k = 0; k < MS_ROWS; ++k) s[k] = state[(size_t)k * g + j];
  const double gl = g_ldr[j], scale = noise_scale[j];
  long long acc[N_PARTS] = {0, 0, 0, 0, 0};
  for (int t = 0; t < n; ++t) {
    const double xt = x[(size_t)t * g + j];
    out[(size_t)t * g + j] =
        STAMP ? melange_step_stamped(c, s, gl, xt, scale, acc)
              : melange_step(c, s, gl, xt, scale);
  }
  for (int k = 0; k < MS_ROWS; ++k) state[(size_t)k * g + j] = s[k];
  if (STAMP)
    for (int k = 0; k < N_PARTS; ++k) parts[(size_t)k * g + j] = acc[k];
}

// melange_step_warp with stamps (every lane stamps its own totals); with
// SPEC, each Newton pass computes the derivatives beside the currents,
// before the convergence vote, so that their latencies overlap (the last
// pass's are not used)
template <bool SPEC>
__device__ __noinline__ double melange_step_warp_stamped(
    const double* s, MelWarp& st, double g, double x, double scale,
    WarpScratch* w, long long* acc) {
  long long t = clock64();
  constexpr int N = 13, M = 5, NR = 10;
  const int lane = threadIdx.x & 31, r = lane >> 4, q = lane & 15;
  const int rn = min(q, N - 1), rm = min(q, M - 1);
  const int fb = (int)s[ML_IDX], outn = (int)s[ML_IDX + 1];
  const int row_in = (int)s[ML_IDX + 2];
  const double* a = w->a + 16 * r;
  const double* b = w->b + 16 * r;
  uint32_t h1, h2;
  threefry((uint32_t)st.key[0], (uint32_t)st.key[1], 0u,
           q == NR ? 0u : 1u, &h1, &h2);
  const uint32_t n1 = __shfl_sync(FULL, h1, NR, 16);
  const uint32_t n2 = __shfl_sync(FULL, h2, NR, 16);
  const int d = min(q, NR - 1);
  const double w_new =
      normal_draw(h1, h2, (uint32_t)d) * s[ML_SIGMA + d] * scale;
  publish<16>(w->b, w_new + st.w_prev, lane, NR);
  const double i_noise = row_dot<N, NR>(s + ML_INJECT, b, rn);
  stamp(acc, PT_DRAWS, t);
  __syncwarp();
  if (q < N) w->a[lane] = st.v;
  if (q < M) w->b[lane] = st.i;
  __syncwarp();
  double rhs = row_dot<N, N>(s + ML_A_HIST, a, rn);
  rhs = q == fb ? rhs + (-st.g_prev) * st.v : rhs;
  rhs = rhs + s[ML_WS_W + rn];
  rhs = q == row_in ? rhs + (r == 0 ? x : 0.0) : rhs;
  rhs = rhs + row_dot<N, M>(s + ML_N_I, b, rn);
  rhs = rhs + (r == 0 ? i_noise : 0.0);
  publish<16>(w->a, rhs, lane, N);
  const double vpb = row_dot<N, N>(s + ML_S, a, rn);
  const double sm_k = g / (1.0 + s[ML_S_FB_FB] * g);
  const double vpb_fb = __shfl_sync(FULL, vpb, fb, 16);
  const double v_pred = vpb - (sm_k * vpb_fb) * s[ML_S_FB_COL + rn];
  publish<16>(w->a, v_pred, lane, N);
  const double p = row_dot<M, N>(s + ML_N_V, a, rm);
  double kc[M];
#pragma unroll
  for (int k = 0; k < M; ++k)
    kc[k] = s[ML_K + k * M + rm] - sm_k * s[ML_K_OUTER + k * M + rm];
  stamp(acc, PT_PREDICT, t);
  double v_nl = st.v_nl, i_nl = 0.0;
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    acc[PT_PASSES] += 1;
    double top, bot;
    if (SPEC) mel_derivs_lane(s, v_nl, q, &top, &bot);
    i_nl = mel_current_lane(s, v_nl, q);
    publish<16>(w->b, i_nl, lane, M);
    double ki = kc[0] * b[0];
#pragma unroll
    for (int k = 1; k < M; ++k) ki = ki + kc[k] * b[k];
    const double f = v_nl - p - ki;
    const unsigned ok = __ballot_sync(FULL, q >= M || fabs(f) < 1e-9);
    const bool conv0 = (ok & 0xffffu) == 0xffffu;
    const bool conv1 = (ok >> 16) == 0xffffu;
    if (conv0 && conv1) {
      done = true;
      break;
    }
    if (!SPEC) mel_derivs_lane(s, v_nl, q, &top, &bot);
    __syncwarp();
    if (q < M) {
      w->a[lane] = top;
      w->b[lane] = bot;
    }
    __syncwarp();
    float aug[M + 1];
#pragma unroll
    for (int k = 0; k < M - 1; ++k) {
      const int r0 = 2 * (k / 2);
      aug[k] = (float)((q == k ? 1.0 : 0.0) -
                       (kc[r0] * a[k] + kc[r0 + 1] * b[k]));
    }
    aug[M - 1] = (float)((q == M - 1 ? 1.0 : 0.0) - kc[M - 1] * a[M - 1]);
    aug[M] = (float)f;
    const double dv = (double)ge_solve_f32_warp<M, 16>(aug, q);
    const bool conv = r == 0 ? conv0 : conv1;
    v_nl = conv ? v_nl : v_nl - jclip(dv, -0.5, 0.5);
  }
  if (!done) i_nl = mel_current_lane(s, v_nl, q);
  stamp(acc, PT_NEWTON, t);
  publish<16>(w->b, i_nl, lane, M);
  const double s_ni = row_dot<N, M>(s + ML_S_NI, b, rn);
  const double dot = row_dot<1, M>(s + ML_SFB_NI, b, 0);
  const double v_new = v_pred + s_ni - (sm_k * dot) * s[ML_S_FB_COL + rn];
  const double out = __shfl_sync(FULL, v_new, outn) -
                     __shfl_sync(FULL, v_new, 16 + outn);
  const bool bad = !finite(out);
  st.v = bad ? s[ML_V_DC + rn] : v_new;
  st.i = bad ? s[ML_I_DC + rm] : i_nl;
  st.v_nl = bad ? s[ML_V_NL_DC + rm] : v_nl;
  st.w_prev = w_new;
  st.g_prev = g;
  st.key[0] = (double)n1;
  st.key[1] = (double)n2;
  stamp(acc, PT_CORRECT, t);
  return bad ? 0.0 : out;
}

// the stamped warp scan, laid out as E5<melange> (melange_scan_kernel)
template <bool SPEC>
__global__ void __launch_bounds__(E5_WARPS * 32)
mb_warp_stamped_kernel(const double* __restrict__ c,
                       const double* __restrict__ x, double* state,
                       const double* __restrict__ g_ldr,
                       const double* __restrict__ noise_scale, double* out,
                       long long* parts, int n, int g) {
  __shared__ double s_mel[ML_SIZE];
  __shared__ WarpScratch scratch[E5_WARPS];
  stage_melange(c, s_mel);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;
  MelWarp st;
  load_mel(st, state + j, g, lane);
  const double gl = g_ldr[j], scale = noise_scale[j];
  long long acc[N_PARTS] = {0, 0, 0, 0, 0};
  for (int t = 0; t < n; ++t) {
    const double y = melange_step_warp_stamped<SPEC>(
        s_mel, st, gl, x[(size_t)t * g + j], scale, &scratch[warp], acc);
    if (lane == 0) out[(size_t)t * g + j] = y;
  }
  store_mel(st, state + j, g, lane);
  if (lane == 0)
    for (int k = 0; k < N_PARTS; ++k) parts[(size_t)k * g + j] = acc[k];
}

constexpr int kVariants = 5;

}  // namespace

extern "C" int mb_count() { return kVariants; }

extern "C" int mb_launch(int which, const double* consts, int n_consts,
                         const double* x, double* state, const double* g_ldr,
                         const double* noise_scale, double* out,
                         long long* parts, int n, int g,
                         cudaStream_t stream) {
  if (n_consts != ML_SIZE || n < 0 || g <= 0 || which < 0 ||
      which >= kVariants)
    return (int)cudaErrorInvalidValue;
  const int tb = (g + MB_BLOCK - 1) / MB_BLOCK;
  const int wb = (g + E5_WARPS - 1) / E5_WARPS;
  const int wt = 32 * (g < E5_WARPS ? g : E5_WARPS);
  switch (which) {
    case 0:
      mb_thread_kernel<false><<<tb, MB_BLOCK, 0, stream>>>(
          consts, x, state, g_ldr, noise_scale, out, parts, n, g);
      break;
    case 1:
      mb_thread_kernel<true><<<tb, MB_BLOCK, 0, stream>>>(
          consts, x, state, g_ldr, noise_scale, out, parts, n, g);
      break;
    case 2:
      melange_scan_kernel<<<wb, wt, 0, stream>>>(consts, x, state, g_ldr,
                                                 noise_scale, out, n, g);
      break;
    case 3:
      mb_warp_stamped_kernel<false><<<wb, wt, 0, stream>>>(
          consts, x, state, g_ldr, noise_scale, out, parts, n, g);
      break;
    case 4:
      mb_warp_stamped_kernel<true><<<wb, wt, 0, stream>>>(
          consts, x, state, g_ldr, noise_scale, out, parts, n, g);
      break;
  }
  return (int)cudaGetLastError();
}
