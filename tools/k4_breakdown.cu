// Where one K4 update's time goes on the card: timing variants of the
// tremolo pre-roll, built and run by tools/torch_k4_breakdown.py.
//
// Two families, each a copy of an update with pieces switched off (flags)
// or done another way:
//  * one_thread_update: trem_update as one thread walks it (K4's earlier
//    design, and still how every lane of K2 runs it);
//  * TremWarpVariant::update_v: TremWarp::update, K4's warp design.
// A variant with a piece switched off computes something else and is
// timed only; a variant marked exact must equal the kernel bit for bit,
// which the tool checks.

#include "../openwurli_tpu_torch/csrc/mono_chain.cu"

namespace {

enum {
  NO_TAIL = 1, NO_MATVEC = 2, NO_GE = 4, NO_PNJ = 8, NO_FINAL = 16,
  NO_GPD = 32, NO_ENV = 64,       // pieces switched off
  PNJ_SELECT = 128,               // pnjlim as a select, not a warp branch
  ROLLED = 256,                   // the Newton loop left rolled
  EXP8 = 512,                     // the 8 limexp calls on 8 lanes
  SMEM = 1024                     // the 4×5 system through shared memory
};

template <int F, int ITERS>
__device__ void one_thread_update(const float* A, const float* K, float r_low,
                                  float div_top, TremState& t) {
  const float* P = A + A_TREM_P;
  const float* Km = A + A_TREM_K;
  const float* cols = A + A_TREM_COLS;
  Gp gp[2] = {load_gp(A + A_TREM_GP), load_gp(A + A_TREM_GP + N_GP)};
  float x11[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) x11[k] = t.v[T_Z + k];
  float big[11];
#pragma unroll
  for (int r = 0; r < 11; ++r) {
    float acc = P[r * 11] * x11[0];
#pragma unroll
    for (int k = 1; k < 11; ++k) acc = acc + P[r * 11 + k] * x11[k];
    big[r] = (F & NO_MATVEC) ? x11[r] * 0.999f : acc;
  }
  float vnl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) vnl[r] = t.v[T_VNL + r];
  for (int it = 0; it < ITERS; ++it) {
    float ib[2], ic[2], gbb[2], gbc[2], gcb[2], gcc[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if constexpr (F & NO_GPD) {
        ib[b] = vnl[b] * 1e-3f; ic[b] = vnl[2 + b] * 1e-3f;
        gbb[b] = vnl[b] * 1e-2f; gbc[b] = vnl[2 + b] * 1e-2f;
        gcb[b] = vnl[b] * 2e-2f; gcc[b] = vnl[2 + b] * 2e-2f;
      } else {
        gp_derivs(gp[b], vnl[b], vnl[2 + b], ib[b], ic[b], gbb[b], gbc[b],
                  gcb[b], gcc[b]);
      }
    }
    const float i_abs[4] = {ib[0], ib[1], ic[0], ic[1]};
    float di[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) di[k] = i_abs[k] - cols[k * 9 + 1];
    float blk[5][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mv = Km[r * 4] * di[0];
#pragma unroll
      for (int k = 1; k < 4; ++k) mv = mv + Km[r * 4 + k] * di[k];
      blk[4][r] = (((vnl[r] - cols[r * 9 + 2]) - big[7 + r])
                   - cols[r * 9 + 0]) - mv;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = j % 2;
      const float g1 = j < 2 ? gbb[b] : gbc[b];
      const float g2 = j < 2 ? gcb[b] : gcc[b];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        blk[j][i] = (A[A_EYE4 + i * 4 + j] - Km[i * 4 + b] * g1)
                    - Km[i * 4 + b + 2] * g2;
    }
    float dv[4];
    if constexpr (F & NO_GE) {
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = blk[4][r] * blk[r][r];
    } else {
      ge_solve<4>(blk, dv);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float d = nclamp(dv[r], -0.5f, 0.5f);
      vnl[r] = (F & NO_PNJ) ? vnl[r] - d
                            : pnjlim(vnl[r], vnl[r] - d, cols[r * 9 + 7],
                                     cols[r * 9 + 8]);
    }
  }
  float ib[2], ic[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if constexpr (F & NO_FINAL) {
      ib[b] = vnl[b] * 1e-3f; ic[b] = vnl[2 + b] * 1e-3f;
    } else {
      gp_currents(gp[b], vnl[b], vnl[2 + b], ib[b], ic[b]);
    }
  }
  const float i_abs[4] = {ib[0], ib[1], ic[0], ic[1]};
  float di_new[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) di_new[k] = i_abs[k] - cols[k * 9 + 1];
  float rs = cols[3] * di_new[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) rs = rs + cols[k * 9 + 3] * di_new[k];
  const int oi = (int)K[TREM_OUT_IDX];
  float big_oi = big[0];
#pragma unroll
  for (int k = 1; k < 11; ++k) big_oi = k == oi ? big[k] : big_oi;
  const float v_out = (K[TREM_VDC_OUT] + big_oi) + rs;
  const float env_new = (F & NO_ENV) ? v_out * 0.5f + t.v[T_ENV]
                                     : trem_env(K, v_out, t.v[T_ENV]);
  const float gldr = (F & NO_TAIL) ? env_new
                                   : trem_gldr(K, env_new, r_low, div_top);
#pragma unroll
  for (int k = 0; k < 7; ++k) t.v[T_Z + k] = big[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) t.v[T_DI + k] = di_new[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) t.v[T_VNL + k] = vnl[k];
  t.v[T_ENV] = env_new;
  t.v[T_GLDR_UPD_PREV] = t.v[T_GLDR_CUR];
  t.v[T_GLDR_CUR] = gldr;
  t.v[T_PHASE] = 0.0f;
}

// K4's earlier design: thread 0 runs trem_update (here the copy above)
template <int F, int ITERS>
__global__ void __launch_bounds__(32)
one_thread_kernel(const float* __restrict__ consts,
                  const float* __restrict__ scalars,
                  const float* __restrict__ controls,
                  const float* __restrict__ state_in,
                  float* __restrict__ caps, int n_captures, int steps) {
  __shared__ float s_consts[A_TOTAL];
  __shared__ float s_scalars[N_SCALARS];
  for (int i = threadIdx.x; i < A_TOTAL; i += blockDim.x)
    s_consts[i] = consts[i];
  for (int i = threadIdx.x; i < N_SCALARS; i += blockDim.x)
    s_scalars[i] = scalars[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  TremState tr;
#pragma unroll
  for (int k = 0; k < PREROLL_ROWS; ++k) tr.v[k] = state_in[trem_row(k)];
  const float r_low = controls[C_R_LOWER], div_top = controls[C_DIV_TOP];
  for (int k = 0; k < n_captures; ++k) {
#pragma unroll
    for (int r = 0; r < PREROLL_ROWS; ++r)
      caps[k * PREROLL_ROWS + r] = tr.v[r];
    if (k + 1 < n_captures)
      for (int i = 0; i < steps; ++i)
        one_thread_update<F, ITERS>(s_consts, s_scalars, r_low, div_top, tr);
  }
}

// gp_derivs' algebra from its 8 limexp values (EXP8)
__device__ __forceinline__ void gp_derivs_from(
    const Gp& p, float vbe, float vbc, const float (&e)[8], float& ib,
    float& ic, float& gbb, float& gbc, float& gcb, float& gcc) {
  const float ef = e[0], def_ = e[1], er = e[2], der = e[3], el = e[4],
              dle = e[5], ec = e[6], dlc = e[7];
  const float i_f = p.is_ * (ef - 1.0f);
  const float i_r = p.is_ * (er - 1.0f);
  const float dif = (p.is_ * def_) * p.inv_nfvt;
  const float dir = (p.is_ * der) * p.inv_nrvt;
  const float q1_arg = (1.0f - vbc * p.inv_vaf) - vbe * p.inv_var;
  const bool clipped = q1_arg < 1e-4f;
  const float q1 = 1.0f / nmax(q1_arg, 1e-4f);
  const float q1sq = q1 * q1;
  const float dq1_be = clipped ? 0.0f : p.inv_var * q1sq;
  const float dq1_bc = clipped ? 0.0f : p.inv_vaf * q1sq;
  const float q2 = i_f * p.inv_ikf + i_r * p.inv_ikr;
  const float root = sqrtf(1.0f + 4.0f * nmax(q2, 0.0f));
  const float h = 0.5f * (1.0f + root);
  const float dh_dq2 = q2 > 0.0f ? 1.0f / root : 0.0f;
  const float qb = q1 * h;
  const float dqb_be = dq1_be * h + (q1 * dh_dq2) * (dif * p.inv_ikf);
  const float dqb_bc = dq1_bc * h + (q1 * dh_dq2) * (dir * p.inv_ikr);
  const float inv_qb = 1.0f / qb;
  const float ict = (i_f - i_r) * inv_qb;
  const float dict_be = (dif - ict * dqb_be) * inv_qb;
  const float dict_bc = (-dir - ict * dqb_bc) * inv_qb;
  const float ibe = i_f * p.inv_bf + p.ise * (el - 1.0f);
  const float ibc = i_r * p.inv_br + p.isc * (ec - 1.0f);
  const float dibe_be = dif * p.inv_bf + (p.ise * dle) * p.inv_nevt;
  const float dibc_bc = dir * p.inv_br + (p.isc * dlc) * p.inv_ncvt;
  ib = ibe + ibc;
  ic = ict - ibc;
  gbb = dibe_be;
  gbc = dibc_bc;
  gcb = dict_be;
  gcc = dict_bc - dibc_bc;
}

template <int F, int ITERS>
struct TremWarpVariant : TremWarp {
  __device__ void newton_step(float p_dev, float* s_blk) {
    const int lane = threadIdx.x;
    const float vo = __shfl_xor_sync(FULL, v, 2);
    const float vbe = r < 2 ? v : vo, vbc = r < 2 ? vo : v;
    float ib, ic, gbb, gbc, gcb, gcc;
    if constexpr (F & NO_GPD) {
      ib = vbe * 1e-3f; ic = vbc * 1e-3f; gbb = vbe * 1e-2f;
      gbc = vbc * 1e-2f; gcb = vbe * 2e-2f; gcc = vbc * 2e-2f;
    } else if constexpr (F & EXP8) {
      // lane l: limexp number (l >> 1) & 3 of transistor l & 1
      const int kind = (lane >> 1) & 3;
      const float xin = kind == 0 ? vbe * gp.inv_nfvt
                      : kind == 1 ? vbc * gp.inv_nrvt
                      : kind == 2 ? vbe * gp.inv_nevt : vbc * gp.inv_ncvt;
      float val, dval, e[8];
      limexp_d(xin, val, dval);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        e[2 * q] = __shfl_sync(FULL, val, b + 2 * q);
        e[2 * q + 1] = __shfl_sync(FULL, dval, b + 2 * q);
      }
      gp_derivs_from(gp, vbe, vbc, e, ib, ic, gbb, gbc, gcb, gcc);
    } else {
      gp_derivs(gp, vbe, vbc, ib, ic, gbb, gbc, gcb, gcc);
    }
    float di[4];
    currents_dc(ib, ic, di);
    float mv = km_r[0] * di[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) mv = mv + km_r[k] * di[k];
    const float f = (((v - vnl_dc) - p_dev) - corr0) - mv;
    const bool jlow = r < 2;
    const float jel = (eye - ka * (jlow ? gbb : gbc)) - kb * (jlow ? gcb : gcc);
    float blk[5][4];
    if constexpr (F & SMEM) {
      __syncwarp();
      if (lane < 16) s_blk[(lane & 3) * 4 + (lane >> 2)] = jel;
      if (lane < 4) s_blk[16 + lane] = f;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) blk[j][i] = s_blk[j * 4 + i];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          blk[j][i] = __shfl_sync(FULL, jel, j + 4 * i);
#pragma unroll
      for (int i = 0; i < 4; ++i) blk[4][i] = __shfl_sync(FULL, f, i);
    }
    float dv[4];
    if constexpr (F & NO_GE) {
#pragma unroll
      for (int q = 0; q < 4; ++q) dv[q] = blk[4][q] * blk[q][q];
    } else {
      ge_solve<4>(blk, dv);
    }
    const float dvr = r == 0 ? dv[0] : r == 1 ? dv[1] : r == 2 ? dv[2]
                                                               : dv[3];
    const float d = nclamp(dvr, -0.5f, 0.5f);
    if constexpr (F & NO_PNJ)
      v = v - d;
    else if constexpr (F & PNJ_SELECT)
      v = pnjlim(v, v - d, nvt, vcrit);
    else
      v = pnjlim_warp(v, v - d, nvt, vcrit);
  }

  __device__ void update_v(const float* K, int oi, float* s_blk) {
    float acc = prow[0] * x[0];
#pragma unroll
    for (int k = 1; k < 11; ++k) acc = acc + prow[k] * x[k];
    const float p_dev = __shfl_sync(FULL, acc, 7 + r);
    const float big_oi = __shfl_sync(FULL, acc, oi);
    float z[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) z[k] = __shfl_sync(FULL, acc, k);
    if constexpr (F & ROLLED) {
#pragma unroll 1
      for (int it = 0; it < ITERS; ++it) newton_step(p_dev, s_blk);
    } else {
#pragma unroll
      for (int it = 0; it < ITERS; ++it) newton_step(p_dev, s_blk);
    }
    const float vo = __shfl_xor_sync(FULL, v, 2);
    float ib, ic;
    gp_currents(gp, r < 2 ? v : vo, r < 2 ? vo : v, ib, ic);
    float di_new[4];
    currents_dc(ib, ic, di_new);
    float rs = sni[0] * di_new[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) rs = rs + sni[k] * di_new[k];
    env = trem_env(K, (K[TREM_VDC_OUT] + big_oi) + rs, env);
#pragma unroll
    for (int k = 0; k < 7; ++k) x[k] = z[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[7 + k] = di_new[k];
  }
};

// trem_preroll_kernel with the update of TremWarpVariant<F, ITERS>
template <int F, int ITERS>
__global__ void __launch_bounds__(32)
warp_kernel(const float* __restrict__ consts,
            const float* __restrict__ scalars,
            const float* __restrict__ controls,
            const float* __restrict__ state_in, float* __restrict__ caps,
            int n_captures, int steps) {
  __shared__ float s_scalars[N_SCALARS];
  __shared__ float s_blk[20];
  const int lane = threadIdx.x;
  for (int i = lane; i < N_SCALARS; i += 32) s_scalars[i] = scalars[i];
  __syncwarp();
  const float* K = s_scalars;
  const int oi_raw = (int)K[TREM_OUT_IDX];
  const int oi = oi_raw >= 1 && oi_raw <= 10 ? oi_raw : 0;
  TremWarpVariant<F, ITERS> tw;
  tw.load(consts, lane);
#pragma unroll
  for (int k = 0; k < 7; ++k) tw.x[k] = state_in[ST_TREM_Z + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) tw.x[7 + k] = state_in[ST_TREM_DI + k];
  tw.v = state_in[ST_TREM_VNL + tw.r];
  tw.env = state_in[ST_TREM_ENV];
  float g_cur = state_in[ST_GLDR_CUR], g_prev = state_in[ST_GLDR_UPD_PREV];
  float phase = state_in[ST_TREM_PHASE];
  const float r_low = controls[C_R_LOWER], div_top = controls[C_DIV_TOP];
  for (int k = 0; k < n_captures; ++k) {
    float vnl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) vnl[q] = __shfl_sync(FULL, tw.v, q);
    if (lane == 0) {
      float* cap = caps + k * PREROLL_ROWS;
#pragma unroll
      for (int q = 0; q < 11; ++q) cap[T_Z + q] = tw.x[q];
#pragma unroll
      for (int q = 0; q < 4; ++q) cap[T_VNL + q] = vnl[q];
      cap[T_ENV] = tw.env;
      cap[T_GLDR_CUR] = g_cur;
      cap[T_GLDR_UPD_PREV] = g_prev;
      cap[T_PHASE] = phase;
    }
    if (k + 1 == n_captures) break;
    for (int i = 0; i < steps; ++i) {
      tw.update_v(K, oi, s_blk);
      if (i >= steps - 2) {
        g_prev = g_cur;
        g_cur = trem_gldr(K, tw.env, r_low, div_top);
      }
    }
    phase = 0.0f;
  }
}

using Launch = void (*)(const float*, const float*, const float*,
                        const float*, float*, int, int, cudaStream_t);

template <int F, int ITERS>
void launch_one_thread(const float* a, const float* s, const float* c,
                       const float* st, float* caps, int n, int steps,
                       cudaStream_t stream) {
  one_thread_kernel<F, ITERS><<<1, 32, 0, stream>>>(a, s, c, st, caps, n,
                                                    steps);
}

template <int F, int ITERS>
void launch_warp(const float* a, const float* s, const float* c,
                 const float* st, float* caps, int n, int steps,
                 cudaStream_t stream) {
  warp_kernel<F, ITERS><<<1, 32, 0, stream>>>(a, s, c, st, caps, n, steps);
}

// The variants, in the order of VARIANTS in tools/torch_k4_breakdown.py.
constexpr Launch kVariants[] = {
    launch_one_thread<0, 3>,                    // the one-thread K4 (exact)
    launch_one_thread<NO_TAIL, 3>,
    launch_one_thread<NO_TAIL | NO_MATVEC, 3>,
    launch_one_thread<NO_TAIL, 2>,
    launch_one_thread<NO_TAIL, 1>,
    launch_one_thread<NO_TAIL, 0>,
    launch_one_thread<NO_TAIL | NO_GE, 3>,
    launch_one_thread<NO_TAIL | NO_PNJ, 3>,
    launch_one_thread<NO_TAIL | NO_GPD, 3>,
    launch_one_thread<NO_TAIL | NO_FINAL, 3>,
    launch_one_thread<NO_TAIL | NO_ENV, 3>,
    launch_warp<0, 3>,                          // K4 (exact)
    launch_warp<PNJ_SELECT, 3>,                 // exact
    launch_warp<PNJ_SELECT | ROLLED, 3>,        // exact
    launch_warp<PNJ_SELECT | SMEM, 3>,          // exact
    launch_warp<EXP8, 3>,                       // exact
    launch_warp<SMEM, 3>,                       // exact
    launch_warp<NO_GE, 3>,
    launch_warp<NO_GPD, 3>,
    launch_warp<NO_PNJ, 3>,
    launch_warp<0, 1>,
    launch_warp<0, 0>,
};

}  // namespace

extern "C" int k4b_count() {
  return (int)(sizeof(kVariants) / sizeof(kVariants[0]));
}

extern "C" int k4b_launch(int which, const float* consts, const float* scalars,
                          const float* controls, const float* state_in,
                          float* caps, int n_captures, int steps,
                          cudaStream_t stream) {
  if (which < 0 || which >= k4b_count() || n_captures <= 0 || steps <= 0)
    return (int)cudaErrorInvalidValue;
  kVariants[which](consts, scalars, controls, state_in, caps, n_captures,
                   steps, stream);
  return (int)cudaGetLastError();
}
