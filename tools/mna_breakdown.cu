// Where one mna step's time goes on the card when a warp runs it
// (mna_step_warp): at <7, 4, 2, 4>, the tremolo oscillator (E3, E2's
// tremolo), and at <21, 16, 8, 16>, the power amp (E6, E2's power amp),
// built and run by tools/torch_mna_breakdown.py.
//
// Each family has the one-thread step that the warp replaced, the warp's
// own kernel and a stamped copy of mna_step_warp that reads the SM's cycle
// counter (clock64) between the step's parts and adds each part's cycles
// to a per-circuit total, the trapezoidal pass's and the BE replay's
// apart:
//   history    A_hist · v, the sources, trap_i · N_i · i (the rhs)
//   linear     v_lin = S · rhs and the ports' p = N_v · v_lin
//   currents   each residual pass: the ports' voltages by shuffle, the
//              BJTs' currents, their publication, K · i, the residual and
//              the convergence vote (the converged pass's max |f| too)
//   derivs     each Newton iteration: the BJTs' derivatives, their
//              publication and the Jacobian row
//   elim       each Newton iteration: the f32 elimination (a pivot row
//              broadcast per column, the back substitution by shuffle)
//   limit      each Newton iteration: the clipped update, the junction
//              limit
//   fold       after Newton: v = v_lin + S_ni · i and the failure test
//   commit     the failure test, the damping net, the NaN reset, the
//              counters
//   around     the power amp's sources before the step, its guard and
//              rails after it (power_amp_step_warp's own work)
// The stamped copy runs the same arithmetic in the same order, so it too
// equals the kernel bit for bit, which the tool checks; a stamp waits for
// nothing in flight, so a part is the cycles between the warp reaching one
// stamp and the next.
//
// The tremolo family runs E3's layout (one circuit, its OSC_ROWS rows);
// the power-amp family E9's (x and out (n, G), the rows CH_PA_V ..
// CH_PA_LAST (G columns)), a warp per stream, four to a block, as E6.
// Beside them, E8 (the tremolo scan) before its warp redesign, a thread
// per circuit, for timing against the library's E8.

#include "../openwurli_tpu_torch/csrc/engine.cu"

namespace {

enum Part {
  PT_HIST, PT_LIN, PT_CUR, PT_DER, PT_ELIM, PT_LIMIT, PT_FOLD,
  N_PASS_PARTS,  // the BE replay's parts follow the trapezoidal pass's
  PT_COMMIT = 2 * N_PASS_PARTS, PT_AROUND, N_TIMED,
  CT_EVALS = N_TIMED, CT_ELIMS, CT_BE, N_PARTS
};

__device__ __forceinline__ void stamp(long long* acc, int part,
                                      long long& t) {
  const long long now = clock64();
  acc[part] += now - t;
  t = now;
}

// nr_solve_warp with stamps; acc already offset to the pass's parts
template <int N, int M, int NB, int ITERS>
__device__ __forceinline__ double nr_solve_warp_stamped(
    const double* s, const double* k_eff, double p, double& v_nl, double& i,
    WarpScratch* w, int lane, long long* acc, long long* counts,
    long long& t) {
  using L = SL<N, M, NB>;
  const int r = min(lane, M - 1);
  const double nvt = s[L::NVT + r], vcrit = s[L::VCRIT + r];
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
    counts[0] += 1;
    i = current_lane<NB>(s + L::GPC, v_nl, lane);
    publish(w->a, i, lane, M);
    const double f = v_nl - p - row_dot<M, M>(k_eff, w->a, r);
    if (__all_sync(FULL, lane >= M || fabs(f) < 1e-9)) {
      const double res = max_abs_warp(w->b, f, lane, M);
      stamp(acc, PT_CUR, t);
      return res;
    }
    stamp(acc, PT_CUR, t);
    counts[1] += 1;
    double top, bot;
    derivs_lane<NB>(s + L::GPD, v_nl, lane, &top, &bot);
    __syncwarp();
    if (lane < M) {
      w->a[lane] = top;
      w->b[lane] = bot;
    }
    __syncwarp();
    float aug[M + 1];
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int r0 = 2 * (k / 2);
      const double jac = (r == k ? 1.0 : 0.0) -
                         (k_eff[r0 * M + r] * w->a[k] +
                          k_eff[(r0 + 1) * M + r] * w->b[k]);
      aug[k] = (float)jac;
    }
    aug[M] = (float)f;
    stamp(acc, PT_DER, t);
    const double dv = (double)ge_solve_f32_warp<M>(aug, lane);
    stamp(acc, PT_ELIM, t);
    const double v_old = v_nl;
    const double v_new = v_old - jclip(dv, -2.0, 2.0);
    const double delta = v_new - v_old;
    const double lim = v_old + nvt * log1p(jmax(delta, 0.0) / nvt);
    const bool apply = (v_new > vcrit) && (delta > 2.0 * nvt);
    v_nl = apply ? lim : v_new;
    stamp(acc, PT_LIMIT, t);
  }
  counts[0] += 1;
  i = current_lane<NB>(s + L::GPC, v_nl, lane);
  publish(w->a, i, lane, M);
  const double f = v_nl - p - row_dot<M, M>(k_eff, w->a, r);
  const double res = max_abs_warp(w->b, f, lane, M);
  stamp(acc, PT_CUR, t);
  return res;
}

// mna_step_warp with stamps
template <int N, int M, int NB, int ITERS>
__device__ __noinline__ void mna_step_warp_stamped(const double* s,
                                                   LaneState& st,
                                                   double w_extra,
                                                   WarpScratch* w,
                                                   long long* acc) {
  using L = SL<N, M, NB>;
  long long t = clock64();
  const int lane = threadIdx.x & 31;
  const int rn = min(lane, N - 1), rm = min(lane, M - 1);
  const int n_nodes = (int)s[L::N_NODES];
  const bool trap_primary = s[L::TRAP_PRIMARY] != 0.0;
  double v = 0.0, i_new = 0.0, v_nl = 0.0, resid = 0.0;
  bool need_be = false;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const bool be = pass == 1;
    long long* a = acc + (be ? N_PASS_PARTS : 0);
    if (be) acc[CT_BE] += 1;
    const double* a_hist = s + (be ? L::AHBE : L::AH);
    const double* s_mat = s + (be ? L::SBE : L::S);
    const double* s_ni = s + (be ? L::SNIBE : L::SNI);
    const double* k_eff = s + (be ? L::KBE : L::K);
    const double w_sc = s[(be ? L::WSBE : L::WS) + rn];
    const double trap_i = be ? 0.0 : s[L::TRAP_I];
    __syncwarp();
    if (lane < N) w->a[lane] = st.v;
    if (lane < M) w->b[lane] = st.i;
    __syncwarp();
    double rhs = row_dot<N, N>(a_hist, w->a, rn);
    rhs = rhs + w_sc * s[L::W + rn] + w_extra;
    rhs = rhs + trap_i * row_dot<N, M>(s + L::NI, w->b, rn);
    stamp(a, PT_HIST, t);
    publish(w->a, rhs, lane, N);
    const double v_lin = row_dot<N, N>(s_mat, w->a, rn);
    publish(w->a, v_lin, lane, N);
    const double p = row_dot<M, N>(s + L::NV, w->a, rm);
    v_nl = st.v_nl;
    stamp(a, PT_LIN, t);
    resid = nr_solve_warp_stamped<N, M, NB, ITERS>(
        s, k_eff, p, v_nl, i_new, w, lane, a, acc + CT_EVALS, t);
    publish(w->a, i_new, lane, M);
    v = v_lin + row_dot<N, M>(s_ni, w->a, rn);
    if (be) {
      stamp(a, PT_FOLD, t);
      break;
    }
    need_be = trap_primary &&
              (failed_warp<N>(v, resid, n_nodes, lane) || st.diag[0] > 0.0);
    stamp(a, PT_FOLD, t);
    if (!need_be) break;
  }
  const bool fail = failed_warp<N>(v, resid, n_nodes, lane);
  const double dv = v - st.v;
  const double dv_max = max_abs_warp(w->b, dv, lane, N);
  const bool damp_hit = finite(dv_max) && dv_max > 30.0;
  const double scale = damp_hit ? 30.0 / jmax(dv_max, 1e-30) : 1.0;
  v = st.v + dv * scale;
  const bool bad = __any_sync(FULL, lane < N && !finite(v));
  st.v = bad ? s[L::VDC + rn] : v;
  st.i = bad ? s[L::IDC + rm] : i_new;
  st.v_nl = bad ? s[L::VNLDC + rm] : v_nl;
  st.resid = resid;
  double* dg = st.diag;
  dg[0] = fail ? 64.0 : (dg[0] - 1.0 > 0.0 ? dg[0] - 1.0 : 0.0);
  dg[1] = dg[1] + (fail ? 1.0 : 0.0);
  dg[2] = dg[2] + (bad ? 1.0 : 0.0);
  dg[3] = dg[3] + (damp_hit ? 1.0 : 0.0);
  dg[4] = dg[4] + (need_be ? 1.0 : 0.0);
  stamp(acc, PT_COMMIT, t);
}

// power_amp_step_warp around the stamped step
__device__ __noinline__ double power_amp_step_warp_stamped(
    const double* pa, const double* misc, PaWarp& st, double x, bool sag,
    WarpScratch* w, long long* acc) {
  long long t = clock64();
  const int lane = threadIdx.x & 31;
  const double sag_f = sag ? 1.0 : 0.0;
  double* rails = st.rails;
  const double w1 = (rails[0] - 22.5) * sag_f;
  const double w2 = (rails[1] - 22.5) * sag_f;
  const double wx = lane == (int)misc[M_PA_IN]   ? x
                    : lane == (int)misc[M_PA_V2] ? w2
                    : lane == (int)misc[M_PA_V1] ? w1
                                                 : 0.0;
  stamp(acc, PT_AROUND, t);
  mna_step_warp_stamped<21, 16, 8, 16>(pa, st.s, wx, w, acc);
  t = clock64();
  const double raw = __shfl_sync(FULL, st.s.v, (int)misc[M_PA_OUT]);
  const double result = raw / 22.0;
  const bool nr_failed = st.s.resid > 1e-3;
  const bool insane = __any_sync(
      FULL, lane < 21 && (!finite(st.s.v) || fabs(st.s.v) > 100.0));
  const bool reset = !finite(result) || insane;
  const bool bad = reset || nr_failed;
  if (reset) {
    const int rn = min(lane, 20), rm = min(lane, 15);
    st.s.v = pa[PaL::VDC + rn];
    st.s.i = pa[PaL::IDC + rm];
    st.s.v_nl = pa[PaL::VNLDC + rm];
  }
  const double out = bad ? st.last : jclip(result, -1.0, 1.0);
  st.last = out;
  if (sag) rails_after(misc, rails, raw, bad);
  stamp(acc, PT_AROUND, t);
  return out;
}

// ── the tremolo family: E3's layout, one circuit ──

// E3 before its warp redesign: one thread
__global__ void mb_trem_thread_kernel(const double* __restrict__ c,
                                      double* state, int n_steps) {
  double s[OSC_ROWS];
  for (int k = 0; k < OSC_ROWS; ++k) s[k] = state[k];
  SolverState st{s, s + 7, s + 11, s + 15, s + 16};
  const double w0[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int t = 0; t < n_steps; ++t) mna_step<7, 4, 2, 4>(c, st, w0);
  for (int k = 0; k < OSC_ROWS; ++k) state[k] = s[k];
}

// E3 with the stamped step
__global__ void __launch_bounds__(32)
mb_trem_stamped_kernel(const double* __restrict__ c, double* state,
                       long long* parts, int n_steps) {
  __shared__ double s_osc[TREM_BLOCK];
  __shared__ WarpScratch scratch;
  stage_block<7, 4, 2>(c, s_osc);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  LaneState st;
  load_lane<7, 4>(st, state, 1, lane);
  long long acc[N_PARTS] = {};
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t)
    mna_step_warp_stamped<7, 4, 2, 4>(s_osc, st, 0.0, &scratch, acc);
  store_lane<7, 4>(st, state, 1, lane);
  if (lane == 0)
    for (int k = 0; k < N_PARTS; ++k) parts[k] = acc[k];
}

// ── the power-amp family: E9's layout ──

// E9 before its warp redesign: a thread per stream, E2's power_amp_step
__global__ void __launch_bounds__(32)
mb_pa_thread_kernel(const double* __restrict__ c,
                    const double* __restrict__ x, double* state, double* out,
                    int n, int g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double ch[CHAIN_ROWS];  // only the power amp's rows
  for (int k = 0; k < E9_ROWS; ++k)
    ch[CH_PA_V + k] = state[(size_t)k * g + j];
  const double* misc = c + C_MISC;
  for (int t = 0; t < n; ++t)
    out[(size_t)t * g + j] =
        power_amp_step(c, misc, ch, x[(size_t)t * g + j], true);
  for (int k = 0; k < E9_ROWS; ++k)
    state[(size_t)k * g + j] = ch[CH_PA_V + k];
}

// the warp step over G streams, a warp each, E6's geometry; STAMP the
// stamped copy, parts (N_PARTS, G)
template <bool STAMP>
__global__ void __launch_bounds__(E6_WARPS * 32)
mb_pa_warp_kernel(const double* __restrict__ c,
                  const double* __restrict__ x, double* state, double* out,
                  long long* parts, int n, int g) {
  __shared__ double s_pa[PA_BLOCK];
  __shared__ WarpScratch scratch[E6_WARPS];
  stage_block<21, 16, 8>(c + C_PA, s_pa);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;
  PaWarp pa;
  load_pa(pa, state + j, g, lane);
  long long acc[N_PARTS] = {};
  const double* misc = c + C_MISC;
  for (int t = 0; t < n; ++t) {
    const double xt = x[(size_t)t * g + j];
    const double y =
        STAMP ? power_amp_step_warp_stamped(s_pa, misc, pa, xt, true,
                                            &scratch[warp], acc)
              : power_amp_step_warp(s_pa, misc, pa, xt, true,
                                    &scratch[warp]);
    if (lane == 0) out[(size_t)t * g + j] = y;
  }
  store_pa(pa, state + j, g, lane);
  if (STAMP && lane == 0)
    for (int k = 0; k < N_PARTS; ++k) parts[(size_t)k * g + j] = acc[k];
}

// ── E8: the tremolo scan (the oscillator, the vactrol, the divider) ──

// E8 before its warp redesign: a thread per circuit, blocks of 32, E2's
// one-thread tremolo_step on the circuit's rows in a local array
__global__ void __launch_bounds__(32)
mb_e8_thread_kernel(const double* __restrict__ c, double* state,
                    const double* __restrict__ depth, double* out, int n,
                    int g) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double ch[CHAIN_ROWS];  // only the tremolo's rows
  for (int k = 0; k < E8_ROWS; ++k)
    ch[CH_TREM_V + k] = state[(size_t)k * g + j];
  const double* misc = c + C_MISC;
  const double d = depth[j];
  for (int t = 0; t < n; ++t)
    out[(size_t)t * g + j] = tremolo_step(c, misc, ch, d);
  for (int k = 0; k < E8_ROWS; ++k)
    state[(size_t)k * g + j] = ch[CH_TREM_V + k];
}

constexpr int kTremVariants = 3;
constexpr int kPaVariants = 3;

}  // namespace

// E8: 0 a thread per circuit (before), 1 the library's (a warp per
// circuit); consts the chain's layout (kernels.engine.scan_consts), state
// (E8_ROWS, G), out (n, G)
extern "C" int mb_e8_launch(int which, const double* consts, int n_consts,
                            double* state, const double* depth, double* out,
                            int n, int g, cudaStream_t stream) {
  if (which == 1)
    return ow_tremolo_scan(consts, n_consts, state, depth, out, n, g,
                           stream);
  if (which != 0 || n_consts != C_TOTAL || n < 0 || g <= 0)
    return (int)cudaErrorInvalidValue;
  mb_e8_thread_kernel<<<(g + 31) / 32, 32, 0, stream>>>(consts, state, depth,
                                                        out, n, g);
  return (int)cudaGetLastError();
}

extern "C" int mb_parts() { return N_PARTS; }
extern "C" int mb_trem_count() { return kTremVariants; }
extern "C" int mb_pa_count() { return kPaVariants; }

// the tremolo family: 0 one thread (E3 before), 1 E3, 2 E3 stamped;
// state (OSC_ROWS,), parts (N_PARTS,)
extern "C" int mb_trem_launch(int which, const double* consts, int n_consts,
                              double* state, long long* parts, int n_steps,
                              cudaStream_t stream) {
  if (n_consts != TREM_BLOCK || n_steps < 0 || which < 0 ||
      which >= kTremVariants)
    return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0:
      mb_trem_thread_kernel<<<1, 1, 0, stream>>>(consts, state, n_steps);
      break;
    case 1:
      tremolo_settle_kernel<<<1, 32, 0, stream>>>(consts, state, n_steps);
      break;
    case 2:
      mb_trem_stamped_kernel<<<1, 32, 0, stream>>>(consts, state, parts,
                                                   n_steps);
      break;
  }
  return (int)cudaGetLastError();
}

// the power-amp family: 0 one thread (E9 before), 1 the warp step, 2
// stamped;
// consts the chain's layout (E9's), parts (N_PARTS, G)
extern "C" int mb_pa_launch(int which, const double* consts, int n_consts,
                            const double* x, double* state, double* out,
                            long long* parts, int n, int g,
                            cudaStream_t stream) {
  if (n_consts != C_TOTAL || n < 0 || g <= 0 || which < 0 ||
      which >= kPaVariants)
    return (int)cudaErrorInvalidValue;
  const int wb = (g + E6_WARPS - 1) / E6_WARPS;
  const int wt = 32 * (g < E6_WARPS ? g : E6_WARPS);
  switch (which) {
    case 0:
      mb_pa_thread_kernel<<<(g + 31) / 32, 32, 0, stream>>>(consts, x, state,
                                                           out, n, g);
      break;
    case 1:
      mb_pa_warp_kernel<false><<<wb, wt, 0, stream>>>(consts, x, state, out,
                                                      parts, n, g);
      break;
    case 2:
      mb_pa_warp_kernel<true><<<wb, wt, 0, stream>>>(consts, x, state, out,
                                                     parts, n, g);
      break;
  }
  return (int)cudaGetLastError();
}
