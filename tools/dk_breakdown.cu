// Where one twin DK preamp step's time goes on the card: the step as one
// thread walks it (preamp_step: E2<dk>'s lane 0, and E5<dk> and E7 before
// their warp redesign) and as a warp runs it (dk_step_warp: E5<dk>, E7),
// built and run by tools/torch_dk_breakdown.py.
//
// Each family has the kernel's own step and a stamped copy of it that
// reads the SM's cycle counter (clock64) between the step's parts and adds
// each part's cycles to a per-stream total:
//   history    A_neg · v, fb's LDR term, the sources, the input, two_w
//   predictor  S_base, the Sherman-Morrison LDR correction, p, K_corr
//   newton     the Newton loop (its residual passes counted too)
//   final      the final junction currents, the node update, the input
//              capacitor's current, the output
//   commit     the commit or the reset to the DC point
// The stamped copies run the same arithmetic in the same order, so they
// too equal the kernel bit for bit, which the tool checks; a stamp waits
// for nothing in flight, so a part is the cycles between the warp reaching
// one stamp and the next.
//
// Every E7 variant scans like E7<diff> (x, r_ldr and out (n, G), the state
// (PS_ROWS, G)), one of them without E7's step-ahead loads of the input and
// the resistance; the E5 variants are E5<dk> before (a thread per stream)
// and E5<dk> itself.

#include "../openwurli_tpu_torch/csrc/engine.cu"

namespace {

enum Part { PT_HIST, PT_PRED, PT_NEWTON, PT_FINAL, PT_COMMIT, PT_PASSES,
            N_PARTS };

__device__ __forceinline__ void stamp(long long* acc, int part,
                                      long long& t) {
  const long long now = clock64();
  acc[part] += now - t;
  t = now;
}

// preamp_step with stamps (the twins' history rows before their
// predictors, which preamp_step interleaves: the same values)
__device__ __noinline__ double preamp_step_stamped(const double* pc,
                                                   double* ps, double g,
                                                   double x,
                                                   long long* acc) {
  long long t = clock64();
  double* v = ps + PS_V;
  double* inl = ps + PS_I;
  double* vnl = ps + PS_VNL;
  double* jcin = ps + PS_JCIN;
  double* cinprev = ps + PS_CINPREV;
  const double gprev = ps[PS_GPREV];
  const double u[2] = {x, 0.0};
  double rhs[2][8], v_pred[2][8], cin_now[2];
  for (int r = 0; r < 2; ++r) {
    matvec(pc + PR_A_NEG, v + 8 * r, rhs[r], 8, 8);
    rhs[r][FB] = rhs[r][FB] + (-gprev) * v[8 * r + FB];
    cin_now[r] = pc[PR_G_CIN] * u[r] + jcin[r];
    rhs[r][B1] = rhs[r][B1] + (cin_now[r] + cinprev[r]);
    rhs[r][E1] = rhs[r][E1] + inl[2 * r];
    rhs[r][C1] = rhs[r][C1] + (-inl[2 * r]);
    rhs[r][E2] = rhs[r][E2] + inl[2 * r + 1];
    rhs[r][C2] = rhs[r][C2] + (-inl[2 * r + 1]);
    for (int n = 0; n < 8; ++n) rhs[r][n] = rhs[r][n] + pc[PR_TWO_W + n];
  }
  stamp(acc, PT_HIST, t);
  const double sm_k = g / (1.0 + pc[PR_S_FB_FB] * g);
  for (int r = 0; r < 2; ++r) {
    double vpb[8];
    matvec(pc + PR_S_BASE, rhs[r], vpb, 8, 8);
    for (int n = 0; n < 8; ++n)
      v_pred[r][n] = vpb[n] - (sm_k * vpb[FB]) * pc[PR_S_FB_COL + n];
  }
  double kc[4];
  for (int k = 0; k < 4; ++k) kc[k] = pc[PR_K + k] - sm_k * pc[PR_K_OUTER + k];
  double p0[2], p1[2], v0[2], v1[2];
  for (int r = 0; r < 2; ++r) {
    p0[r] = v_pred[r][B1] - v_pred[r][E1];
    p1[r] = v_pred[r][C1] - v_pred[r][E2];
    v0[r] = vnl[2 * r];
    v1[r] = vnl[2 * r + 1];
  }
  stamp(acc, PT_PRED, t);
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
    acc[PT_PASSES] += 1;
    double f0[2], f1[2], gm0[2], gm1[2];
    bool conv[2];
    for (int r = 0; r < 2; ++r) {
      double ic0, ic1;
      bjt_ic_gm(v0[r], &ic0, &gm0[r]);
      bjt_ic_gm(v1[r], &ic1, &gm1[r]);
      f0[r] = v0[r] - p0[r] - kc[0] * ic0 - kc[1] * ic1;
      f1[r] = v1[r] - p1[r] - kc[2] * ic0 - kc[3] * ic1;
      conv[r] = fabs(f0[r]) < 1e-9 && fabs(f1[r]) < 1e-9;
    }
    if (conv[0] && conv[1]) break;
    for (int r = 0; r < 2; ++r) {
      const double j00 = 1.0 - kc[0] * gm0[r];
      const double j01 = -kc[1] * gm1[r];
      const double j10 = -kc[2] * gm0[r];
      const double j11 = 1.0 - kc[3] * gm1[r];
      const double det = j00 * j11 - j01 * j10;
      const bool big = fabs(det) > 1e-30;
      const bool ok = !conv[r] && big;
      const double inv_det = big ? 1.0 / det : 0.0;
      const double dv0 = inv_det * (j11 * f0[r] - j01 * f1[r]);
      const double dv1 = inv_det * (j00 * f1[r] - j10 * f0[r]);
      v0[r] = v0[r] - (ok ? dv0 : 0.0);
      v1[r] = v1[r] - (ok ? dv1 : 0.0);
    }
  }
  stamp(acc, PT_NEWTON, t);
  double v_new[2][8], ic0[2], ic1[2], jc[2];
  for (int r = 0; r < 2; ++r) {
    double gm;
    bjt_ic_gm(v0[r], &ic0[r], &gm);
    bjt_ic_gm(v1[r], &ic1[r], &gm);
    const double dot = pc[PR_SFB_NI] * ic0[r] + pc[PR_SFB_NI + 1] * ic1[r];
    for (int n = 0; n < 8; ++n) {
      const double s_ni =
          ic0[r] * pc[PR_NI_COL0 + n] + ic1[r] * pc[PR_NI_COL1 + n];
      v_new[r][n] = v_pred[r][n] + s_ni - (sm_k * dot) * pc[PR_S_FB_COL + n];
    }
    jc[r] = -pc[PR_GC_1PC] * (u[r] - v_new[r][B1]) - pc[PR_C_CIN] * jcin[r];
  }
  const double out = v_new[0][OUTN] - v_new[1][OUTN];
  stamp(acc, PT_FINAL, t);
  const bool bad = !finite(out);
  const double jdc = pc[PR_J_CIN_DC];
  for (int r = 0; r < 2; ++r) {
    for (int n = 0; n < 8; ++n)
      v[8 * r + n] = bad ? pc[PR_V_DC + n] : v_new[r][n];
    inl[2 * r] = bad ? pc[PR_I_NL_DC] : ic0[r];
    inl[2 * r + 1] = bad ? pc[PR_I_NL_DC + 1] : ic1[r];
    vnl[2 * r] = bad ? pc[PR_V_NL_DC] : v0[r];
    vnl[2 * r + 1] = bad ? pc[PR_V_NL_DC + 1] : v1[r];
    jcin[r] = bad ? jdc : jc[r];
    cinprev[r] = bad ? jdc : cin_now[r];
  }
  ps[PS_GPREV] = g;
  stamp(acc, PT_COMMIT, t);
  return bad ? 0.0 : out;
}

// the one-thread scan: a thread per stream over preamp_step (E7<diff>
// before its warp redesign), or over the stamped copy; parts (N_PARTS, G)
constexpr int DB_BLOCK = 32;

template <bool STAMP>
__global__ void __launch_bounds__(DB_BLOCK)
db_thread_kernel(const double* __restrict__ c, const double* __restrict__ x,
                 const double* __restrict__ r_ldr, double* state,
                 double* out, long long* parts, int n, int g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double s[PS_ROWS];
  for (int k = 0; k < PS_ROWS; ++k) s[k] = state[(size_t)k * g + j];
  long long acc[N_PARTS] = {0, 0, 0, 0, 0, 0};
  for (int t = 0; t < n; ++t) {
    const size_t at = (size_t)t * g + j;
    const double gl = 1.0 / jmax(r_ldr[at], 1000.0);
    out[at] = STAMP ? preamp_step_stamped(c, s, gl, x[at], acc)
                    : preamp_step(c, s, gl, x[at]);
  }
  for (int k = 0; k < PS_ROWS; ++k) state[(size_t)k * g + j] = s[k];
  if (STAMP)
    for (int k = 0; k < N_PARTS; ++k) parts[(size_t)k * g + j] = acc[k];
}

// dk_step_warp with stamps (every lane stamps its own totals); with BOTH,
// every lane evaluates both junctions' exps itself instead of taking them
// from lanes 0 and 1 by shuffle
template <bool BOTH>
__device__ __forceinline__ void bjt_pair_variant(double v0, double v1, int q,
                                                 double* ic, double* gm) {
  if (BOTH) {
    bjt_ic_gm(v0, &ic[0], &gm[0]);
    bjt_ic_gm(v1, &ic[1], &gm[1]);
  } else {
    bjt_pair(v0, v1, q, ic, gm);
  }
}

template <bool BOTH>
__device__ __noinline__ double dk_step_warp_stamped(const double* s,
                                                    DkWarp& st, double g,
                                                    double x, WarpScratch* w,
                                                    long long* acc) {
  long long t = clock64();
  const int lane = threadIdx.x & 31, r = lane >> 4, q = lane & 15;
  const int n = min(q, 7);
  const double* a = w->a + 16 * r;
  publish<16>(w->a, st.v, lane, 8);
  double rhs = row_dot<8, 8>(s + PR_A_NEG, a, n);
  const double u = r == 0 ? x : 0.0;
  const double cin_now = s[PR_G_CIN] * u + st.j_cin;
  rhs = n == FB ? rhs + (-st.g_prev) * st.v : rhs;
  rhs = n == B1 ? rhs + (cin_now + st.cin_prev) : rhs;
  rhs = n == E1 ? rhs + st.i_nl[0] : rhs;
  rhs = n == C1 ? rhs + (-st.i_nl[0]) : rhs;
  rhs = n == E2 ? rhs + st.i_nl[1] : rhs;
  rhs = n == C2 ? rhs + (-st.i_nl[1]) : rhs;
  rhs = rhs + s[PR_TWO_W + n];
  stamp(acc, PT_HIST, t);
  publish<16>(w->a, rhs, lane, 8);
  const double vpb = row_dot<8, 8>(s + PR_S_BASE, a, n);
  const double sm_k = g / (1.0 + s[PR_S_FB_FB] * g);
  const double vpb_fb = __shfl_sync(FULL, vpb, FB, 16);
  const double v_pred = vpb - (sm_k * vpb_fb) * s[PR_S_FB_COL + n];
  const double p0 = __shfl_sync(FULL, v_pred, B1, 16) -
                    __shfl_sync(FULL, v_pred, E1, 16);
  const double p1 = __shfl_sync(FULL, v_pred, C1, 16) -
                    __shfl_sync(FULL, v_pred, E2, 16);
  double kc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) kc[k] = s[PR_K + k] - sm_k * s[PR_K_OUTER + k];
  stamp(acc, PT_PRED, t);
  double v0 = st.v_nl[0], v1 = st.v_nl[1], ic[2], gm[2];
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
    acc[PT_PASSES] += 1;
    bjt_pair_variant<BOTH>(v0, v1, q, ic, gm);
    const double f0 = v0 - p0 - kc[0] * ic[0] - kc[1] * ic[1];
    const double f1 = v1 - p1 - kc[2] * ic[0] - kc[3] * ic[1];
    const bool conv = fabs(f0) < 1e-9 && fabs(f1) < 1e-9;
    if (__ballot_sync(FULL, conv) == FULL) {
      done = true;
      break;
    }
    const double j00 = 1.0 - kc[0] * gm[0];
    const double j01 = -kc[1] * gm[1];
    const double j10 = -kc[2] * gm[0];
    const double j11 = 1.0 - kc[3] * gm[1];
    const double det = j00 * j11 - j01 * j10;
    const bool big = fabs(det) > 1e-30;
    const bool ok = !conv && big;
    const double inv_det = big ? 1.0 / det : 0.0;
    const double dv0 = inv_det * (j11 * f0 - j01 * f1);
    const double dv1 = inv_det * (j00 * f1 - j10 * f0);
    v0 = v0 - (ok ? dv0 : 0.0);
    v1 = v1 - (ok ? dv1 : 0.0);
  }
  stamp(acc, PT_NEWTON, t);
  if (!done) bjt_pair_variant<BOTH>(v0, v1, q, ic, gm);
  const double dot = s[PR_SFB_NI] * ic[0] + s[PR_SFB_NI + 1] * ic[1];
  const double s_ni = ic[0] * s[PR_NI_COL0 + n] + ic[1] * s[PR_NI_COL1 + n];
  const double v_new = v_pred + s_ni - (sm_k * dot) * s[PR_S_FB_COL + n];
  const double jc = -s[PR_GC_1PC] * (u - __shfl_sync(FULL, v_new, B1, 16)) -
                    s[PR_C_CIN] * st.j_cin;
  const double out = __shfl_sync(FULL, v_new, OUTN) -
                     __shfl_sync(FULL, v_new, 16 + OUTN);
  stamp(acc, PT_FINAL, t);
  const bool bad = !finite(out);
  const double jdc = s[PR_J_CIN_DC];
  st.v = bad ? s[PR_V_DC + n] : v_new;
  st.i_nl[0] = bad ? s[PR_I_NL_DC] : ic[0];
  st.i_nl[1] = bad ? s[PR_I_NL_DC + 1] : ic[1];
  st.v_nl[0] = bad ? s[PR_V_NL_DC] : v0;
  st.v_nl[1] = bad ? s[PR_V_NL_DC + 1] : v1;
  st.j_cin = bad ? jdc : jc;
  st.cin_prev = bad ? jdc : cin_now;
  st.g_prev = g;
  stamp(acc, PT_COMMIT, t);
  return bad ? 0.0 : out;
}

// the stamped warp scan, laid out as E7<diff> (dk_scan_kernel)
template <bool BOTH>
__global__ void __launch_bounds__(E7_WARPS * 32)
db_warp_stamped_kernel(const double* __restrict__ c,
                       const double* __restrict__ x,
                       const double* __restrict__ r_ldr, double* state,
                       double* out, long long* parts, int n, int g) {
  __shared__ double s_pre[PR_SIZE];
  __shared__ WarpScratch scratch[E7_WARPS];
  stage_dk(c, s_pre);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;
  DkWarp st;
  load_dk(st, state + j, g, lane);
  long long acc[N_PARTS] = {0, 0, 0, 0, 0, 0};
  double x_next = x[j], r_next = r_ldr[j];
  for (int t = 0; t < n; ++t) {
    const size_t at = (size_t)t * g + j;
    const double xt = x_next, rt = r_next;
    if (t + 1 < n) {
      x_next = x[at + g];
      r_next = r_ldr[at + g];
    }
    const double y = dk_step_warp_stamped<BOTH>(
        s_pre, st, 1.0 / jmax(rt, 1000.0), xt, &scratch[warp], acc);
    if (lane == 0) out[at] = y;
  }
  store_dk(st, state + j, g, lane);
  if (lane == 0)
    for (int k = 0; k < N_PARTS; ++k) parts[(size_t)k * g + j] = acc[k];
}

// E7<diff> without its step-ahead loads: each step reads its own sample's
// input and resistance
__global__ void __launch_bounds__(E7_WARPS * 32)
db_warp_in_step_kernel(const double* __restrict__ c,
                       const double* __restrict__ x,
                       const double* __restrict__ r_ldr, double* state,
                       double* out, int n, int g) {
  __shared__ double s_pre[PR_SIZE];
  __shared__ WarpScratch scratch[E7_WARPS];
  stage_dk(c, s_pre);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;
  DkWarp st;
  load_dk(st, state + j, g, lane);
  for (int t = 0; t < n; ++t) {
    const size_t at = (size_t)t * g + j;
    const double y = dk_step_warp(s_pre, st, 1.0 / jmax(r_ldr[at], 1000.0),
                                  x[at], &scratch[warp]);
    if (lane == 0) out[at] = y;
  }
  store_dk(st, state + j, g, lane);
}

// E5<dk> before its warp redesign: a thread per stream, blocks of 32
__global__ void __launch_bounds__(DB_BLOCK)
db_e5_thread_kernel(const double* __restrict__ c,
                    const double* __restrict__ x, double* state,
                    const double* __restrict__ g_ldr, double* out, int n,
                    int g) {
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

constexpr int kVariants = 6;
constexpr int kE5Variants = 2;

}  // namespace

extern "C" int db_count() { return kVariants; }
extern "C" int db_e5_count() { return kE5Variants; }

extern "C" int db_launch(int which, const double* consts, int n_consts,
                         const double* x, const double* r_ldr, double* state,
                         double* out, long long* parts, int n, int g,
                         cudaStream_t stream) {
  if (n_consts != PR_SIZE || n < 1 || g <= 0 || which < 0 ||
      which >= kVariants)
    return (int)cudaErrorInvalidValue;
  const int tb = (g + DB_BLOCK - 1) / DB_BLOCK;
  const int wb = (g + E7_WARPS - 1) / E7_WARPS;
  const int wt = 32 * (g < E7_WARPS ? g : E7_WARPS);
  switch (which) {
    case 0:
      db_thread_kernel<false><<<tb, DB_BLOCK, 0, stream>>>(
          consts, x, r_ldr, state, out, parts, n, g);
      break;
    case 1:
      db_thread_kernel<true><<<tb, DB_BLOCK, 0, stream>>>(
          consts, x, r_ldr, state, out, parts, n, g);
      break;
    case 2:
      dk_scan_kernel<DK_TAP_DIFF><<<wb, wt, 0, stream>>>(consts, x, r_ldr,
                                                         state, out, n, g);
      break;
    case 3:
      db_warp_stamped_kernel<false><<<wb, wt, 0, stream>>>(
          consts, x, r_ldr, state, out, parts, n, g);
      break;
    case 4:
      db_warp_stamped_kernel<true><<<wb, wt, 0, stream>>>(
          consts, x, r_ldr, state, out, parts, n, g);
      break;
    case 5:
      db_warp_in_step_kernel<<<wb, wt, 0, stream>>>(consts, x, r_ldr, state,
                                                    out, n, g);
      break;
  }
  return (int)cudaGetLastError();
}

extern "C" int db_e5_launch(int which, const double* consts, int n_consts,
                            const double* x, double* state,
                            const double* g_ldr, double* out, int n, int g,
                            cudaStream_t stream) {
  if (n_consts != PR_SIZE || n < 0 || g <= 0 || which < 0 ||
      which >= kE5Variants)
    return (int)cudaErrorInvalidValue;
  if (which == 0) {
    db_e5_thread_kernel<<<(g + DB_BLOCK - 1) / DB_BLOCK, DB_BLOCK, 0,
                          stream>>>(consts, x, state, g_ldr, out, n, g);
  } else {
    preamp_scan_kernel<PRE_DK>
        <<<(g + E5_WARPS - 1) / E5_WARPS,
           32 * (g < E5_WARPS ? g : E5_WARPS), 0, stream>>>(
            consts, x, state, g_ldr, out, n, g);
  }
  return (int)cudaGetLastError();
}
