// Mono analog chain (kernel K2) for Hopper: tremolo → twin DK preamp →
// Class-AB power amp → 2× oversampling → speaker, one thread per stream.
//
// Replaces: openwurli_tpu/kernels/mono_chain.py, `_make_kernel` (`kernel`)
// as launched by `_render_tpu_jit` / `render_tpu`, noise=False.
//
// What bounds it on this card: a stream is one long serial recurrence
// (per base sample: a tremolo update every 2nd sample, then two
// oversampled preamp + power-amp solves, each power-amp solve 8 Newton
// iterations with a 10×10 elimination), so time is the per-thread
// latency of a few thousand dependent f32 operations per sample times the
// sample count; the card fills only with many streams. Device memory
// traffic is negligible (one f32 in and one out per sample and stream).
//
// What the design does about it: the 21 constant arrays (13 KB) are staged
// in shared memory once per block, the ~70 scalars sit in shared memory
// too, and each thread keeps its stream's 328-row state in registers /
// local memory for the whole call (read once, written once, in the
// reference's packed layout). The arithmetic follows the plain torch
// version (`openwurli_tpu_torch/kernels/mono_chain.py`) op for op, with
// sums in index order and no FMA contraction (built with -fmad=false):
// the compensated TwoSum/Dekker pb accumulation needs unfused, correctly
// rounded adds and multiplies, and matching rounding keeps this kernel
// within the f32 noise of its plain twin on a chain whose free trajectory
// amplifies ulp-level differences. The preamp's pump-scale node-row update
// is accumulated in double and rounded once (the accuracy the reference
// gets from FMA contraction there). Guards keep select semantics: NaNs
// propagate through min/max/clamp as they do in torch.
//
// Thermal-noise variant (kernel K5), `mono_chain_kernel<true>`. Replaces the
// same `_make_kernel` launched with noise=True: `preamp_step`'s noise
// branch. Per oversampled sample each stream advances its 40 LCG words
// (×1664525 + 1013904223), hashes each (murmur3 finalizer), turns the top
// 31 bits into a uniform and sums four into one of 10 unit-variance draws;
// the draws, scaled by the `noise` control row, enter the main solver's
// right-hand side through the pack-time columns pre_NS / pre_NP as the
// two-draw stamp w[n] + w[n−1], and draw 0 rides the input. About 400
// integer and 300 float operations beside the step's ~16000, so what bounds
// K2 bounds K5. It is the same template as K2 with every addition under
// `if constexpr (NOISE)`: the noise-off instantiation is the code it was
// before, and carries the nz_ rows untouched. One thread owns its stream's
// 40 words in native uint32_t; sums run in the plain version's order.
//
// Tremolo pre-roll (kernel K4), `trem_preroll_kernel` at the end of this
// file. Replaces: openwurli_tpu/kernels/mono_chain.py, `_make_preroll_kernel`
// as launched by `_trem_preroll_jit` / `trem_preroll`. It advances only the
// tremolo-owned rows and writes them out once per capture interval. It is
// one serial recurrence (each update needs the one before), so one thread
// walks it and its time is that thread's arithmetic latency per update
// times the number of updates; the bytes (19 floats per capture) are
// nothing beside it. The thread calls `Chain::trem_update`, the device
// function K2 calls, so the captures are K2's own tremolo states.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Constant-array offsets in the packed buffer (ARRAY_NAMES order).
enum ArrayOffset {
  A_PRE_SA = 0, A_PRE_SA_P = 256, A_PRE_COLS = 320, A_PRE_COLS_HI = 352,
  A_PRE_COLS_LO = 384, A_PRE_NS = 416, A_PRE_NP = 488, A_PA_P = 506,
  A_PA_K = 1875, A_PA_COLS = 2131, A_PA_NVCOLS = 2194, A_PA_GP = 2354,
  A_EYE16 = 2458, A_PA_K_ACT = 2714, A_PA_K_REL = 2874, A_PA_EYE_ACT = 2970,
  A_TREM_P = 3070, A_TREM_K = 3191, A_TREM_COLS = 3207, A_TREM_GP = 3270,
  A_EYE4 = 3296, A_TOTAL = 3312
};

// Scalar indices (SCALAR_NAMES order).
enum Sc {
  PRE_G0, PRE_VDCFB, PRE_GCIN, PRE_SFBFB, PRE_SMK0, PRE_VPBDCFB, PRE_K00,
  PRE_K01, PRE_K10, PRE_K11, PRE_NV0S0, PRE_NV0S1, PRE_NV1S0, PRE_NV1S1,
  PRE_PDC0, PRE_PDC1, PRE_CFB_P0, PRE_CFB_P1, PRE_CB1_P0, PRE_CB1_P1,
  PRE_CE1_P0, PRE_CE1_P1, PRE_CE2_P0, PRE_CE2_P1, PRE_INV_VT, PRE_IS,
  PRE_IS_VT, PRE_VMAX, PRE_SFBNI0, PRE_SFBNI1, PRE_Q0, PRE_IDC0, PRE_IDC1,
  PRE_GC1PC, PRE_CCIN, PRE_VNL_DC0, PRE_VNL_DC1, PA_RAIL_BIAS, PA_VDC_OUT,
  PA_INV_HEADROOM, PA_INV_LOAD, PA_RAIL_OPEN, PA_RAIL_REFF, PA_A_IAVG,
  PA_A_ATT, PA_A_REL, PA_OUT_IDX, TREM_VDC_OUT, TREM_OUT_IDX, TREM_VMAX,
  TREM_VSPAN, TREM_ATT, TREM_REL, TREM_GAMMA, TREM_LN_RMAX, TREM_LN_SPAN,
  TREM_RMAX, TREM_R18, OS_A0, OS_A1, OS_A2, OS_B0, OS_B1, OS_B2,
  SPK_THERMAL_ALPHA, POST_GAIN, DRIVE, NZ_U_SIGMA, N_SCALARS
};

// Packed state offsets (STATE_SPEC, 8-row aligned).
enum StateOffset {
  ST_PRE_D = 0, ST_PRE_VNL = 16, ST_PRE_DIC = 24, ST_PRE_DJ = 32,
  ST_PRE_DPREV = 40, ST_PRE_GLDR = 48, ST_TREM_Z = 56, ST_TREM_DI = 64,
  ST_TREM_VNL = 72, ST_TREM_ENV = 80, ST_GLDR_CUR = 88,
  ST_GLDR_UPD_PREV = 96, ST_TREM_PHASE = 104, ST_PA_Z = 112, ST_PA_DI = 136,
  ST_PA_VNL = 152, ST_PA_VNL_PREV = 168, ST_PA_RAILS = 184,
  ST_PA_LASTGOOD = 192, ST_OS_UA = 200, ST_OS_UB = 208, ST_OS_DA = 216,
  ST_OS_DB = 224, ST_OS_DELAY = 232, ST_SPK_HPF = 240, ST_SPK_LPF = 248,
  ST_SPK_THERMAL = 256, ST_GUARD_FIRES = 264, ST_NZ_W = 272,
  ST_NZ_LCG = 288, STATE_ROWS = 328
};

// Control rows (CTRL_SPEC).
enum Ctrl {
  C_VOLUME = 0, C_RAIL_SAG = 1, C_DIV_TOP = 2, C_R_LOWER = 3, C_HPF = 4,
  C_LPF = 9, C_A2 = 14, C_A3 = 15, C_THERMAL = 16, C_CHAR = 17,
  C_NOISE = 18, CTRL_ROWS = 19
};

constexpr int B1 = 0, FB = 7, OUT = 6;  // preamp nodes
constexpr int N_GP = 13;                 // Gummel-Poon parameter columns
constexpr int N_PRE_ITERS = 5, N_PA_ITERS = 8, N_TREM_ITERS = 3;
constexpr int N_ACT = 10, N_REL = 6;
__constant__ int kPaActive[N_ACT] = {0, 1, 2, 3, 4, 5, 6, 7, 10, 12};
__constant__ int kPaReleg[N_REL] = {8, 9, 11, 13, 14, 15};

// torch semantics: min/max/clamp propagate NaN.
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nclamp(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}

struct Gp {
  float is_, inv_nfvt, inv_nrvt, inv_vaf, inv_var, inv_ikf, inv_ikr, ise,
      inv_nevt, isc, inv_ncvt, inv_bf, inv_br;
};

__device__ __forceinline__ Gp load_gp(const float* row) {
  Gp p;
  p.is_ = row[0]; p.inv_nfvt = row[1]; p.inv_nrvt = row[2];
  p.inv_vaf = row[3]; p.inv_var = row[4]; p.inv_ikf = row[5];
  p.inv_ikr = row[6]; p.ise = row[7]; p.inv_nevt = row[8]; p.isc = row[9];
  p.inv_ncvt = row[10]; p.inv_bf = row[11]; p.inv_br = row[12];
  return p;
}

__device__ __forceinline__ void limexp_d(float x, float& val, float& dval) {
  const float xc = 40.0f, exc = (float)2.3538526683702e17;
  const float e = expf(fminf(x, xc));
  const bool lin = x < xc;
  val = lin ? e : exc * (1.0f + (x - xc));
  dval = lin ? e : exc;
}

// Currents and derivatives of one BJT (NPN convention).
__device__ void gp_derivs(const Gp& p, float vbe, float vbc, float& ib,
                          float& ic, float& gbb, float& gbc, float& gcb,
                          float& gcc) {
  float ef, def_, er, der, el, dle, ec, dlc;
  limexp_d(vbe * p.inv_nfvt, ef, def_);
  limexp_d(vbc * p.inv_nrvt, er, der);
  limexp_d(vbe * p.inv_nevt, el, dle);
  limexp_d(vbc * p.inv_ncvt, ec, dlc);
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

__device__ void gp_currents(const Gp& p, float vbe, float vbc, float& ib,
                            float& ic) {
  float ef, er, el, ec, unused;
  limexp_d(vbe * p.inv_nfvt, ef, unused);
  limexp_d(vbc * p.inv_nrvt, er, unused);
  limexp_d(vbe * p.inv_nevt, el, unused);
  limexp_d(vbc * p.inv_ncvt, ec, unused);
  const float i_f = p.is_ * (ef - 1.0f);
  const float i_r = p.is_ * (er - 1.0f);
  const float q1 = 1.0f / nmax((1.0f - vbc * p.inv_vaf) - vbe * p.inv_var,
                               1e-4f);
  const float q2 = i_f * p.inv_ikf + i_r * p.inv_ikr;
  const float qb = (q1 * 0.5f) * (1.0f + sqrtf(1.0f + 4.0f * nmax(q2, 0.0f)));
  const float ict = (i_f - i_r) / qb;
  const float ibe = i_f * p.inv_bf + p.ise * (el - 1.0f);
  const float ibc = i_r * p.inv_br + p.isc * (ec - 1.0f);
  ib = ibe + ibc;
  ic = ict - ibc;
}

// SPICE junction limiting (the plain version's _pnjlim).
__device__ __forceinline__ float pnjlim(float v_old, float v_new, float nvt,
                                        float vcrit) {
  const float delta = v_new - v_old;
  float lim = v_old + nvt * log1pf(nmax(delta, 0.0f) / nvt);
  lim = nmax(lim, nmin(v_new, vcrit));
  return (v_new > vcrit && delta > 2.0f * nvt) ? lim : v_new;
}

// Per-stream m×m elimination without pivoting, the plain version's
// _ge_solve_flat: blk[j] is column j (j < m), blk[m] the rhs. Every step
// updates all rows of the remaining blocks (rows at/above the pivot with
// a zero multiplier), as the reference does.
template <int M>
__device__ void ge_solve(float (&blk)[M + 1][M], float (&x)[M]) {
  float invs[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float piv = blk[k][k];
    const float inv = 1.0f / (fabsf(piv) > 1e-30f ? piv : 1e-30f);
    invs[k] = inv;
    float below[M];
#pragma unroll
    for (int i = 0; i < M; ++i) below[i] = (i > k ? blk[k][i] : 0.0f) * inv;
#pragma unroll
    for (int j = k + 1; j <= M; ++j) {
      const float rk = blk[j][k];
#pragma unroll
      for (int i = 0; i < M; ++i) blk[j][i] = blk[j][i] - below[i] * rk;
    }
  }
#pragma unroll
  for (int k = M - 1; k >= 0; --k) {
    const float xk = blk[M][k] * invs[k];
    x[k] = xk;
    if (k) {
#pragma unroll
      for (int i = 0; i < M; ++i)
        blk[M][i] = blk[M][i] - (i < k ? blk[k][i] : 0.0f) * xk;
    }
  }
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& err) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void split12(float x, float& hi, float& lo) {
  const float t = __fmul_rn(x, 4097.0f);
  hi = __fsub_rn(t, __fsub_rn(t, x));
  lo = __fsub_rn(x, hi);
}

__device__ __forceinline__ float prod_err(float a_hi, float a_lo, float b_hi,
                                          float b_lo, float p) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(a_hi, b_hi), p),
                          __fmul_rn(a_hi, b_lo)),
                __fmul_rn(a_lo, b_hi)),
      __fmul_rn(a_lo, b_lo));
}

struct Chain {
  const float* A;  // constant arrays (shared memory)
  const float* K;  // scalars (shared memory)
  float ctrl[CTRL_ROWS];
  float st[STATE_ROWS];

  __device__ float sc(int i) const { return K[i]; }

  // ── tremolo: one subsampled update of the tremolo-owned rows ──
  __device__ void trem_update() {
    const float* P = A + A_TREM_P;      // (11, 11)
    const float* Km = A + A_TREM_K;     // (4, 4)
    const float* cols = A + A_TREM_COLS;  // (7, 9)
    Gp gp[2] = {load_gp(A + A_TREM_GP), load_gp(A + A_TREM_GP + N_GP)};
    float x11[11];
    for (int k = 0; k < 7; ++k) x11[k] = st[ST_TREM_Z + k];
    for (int k = 0; k < 4; ++k) x11[7 + k] = st[ST_TREM_DI + k];
    float big[11];
    for (int r = 0; r < 11; ++r) {
      float acc = P[r * 11] * x11[0];
      for (int k = 1; k < 11; ++k) acc = acc + P[r * 11 + k] * x11[k];
      big[r] = acc;
    }
    float vnl[4];
    for (int r = 0; r < 4; ++r) vnl[r] = st[ST_TREM_VNL + r];
    for (int it = 0; it < N_TREM_ITERS; ++it) {
      float ib[2], ic[2], gbb[2], gbc[2], gcb[2], gcc[2];
      for (int b = 0; b < 2; ++b)
        gp_derivs(gp[b], vnl[b], vnl[2 + b], ib[b], ic[b], gbb[b], gbc[b],
                  gcb[b], gcc[b]);
      const float i_abs[4] = {ib[0], ib[1], ic[0], ic[1]};
      float di[4];
      for (int k = 0; k < 4; ++k) di[k] = i_abs[k] - cols[k * 9 + 1];
      float blk[5][4];
      for (int r = 0; r < 4; ++r) {
        float mv = Km[r * 4] * di[0];
        for (int k = 1; k < 4; ++k) mv = mv + Km[r * 4 + k] * di[k];
        blk[4][r] = (((vnl[r] - cols[r * 9 + 2]) - big[7 + r])
                     - cols[r * 9 + 0]) - mv;
      }
      for (int j = 0; j < 4; ++j) {
        const int b = j % 2;
        const float g1 = j < 2 ? gbb[b] : gbc[b];
        const float g2 = j < 2 ? gcb[b] : gcc[b];
        for (int i = 0; i < 4; ++i)
          blk[j][i] = (A[A_EYE4 + i * 4 + j] - Km[i * 4 + b] * g1)
                      - Km[i * 4 + b + 2] * g2;
      }
      float dv[4];
      ge_solve<4>(blk, dv);
      for (int r = 0; r < 4; ++r) {
        const float d = nclamp(dv[r], -0.5f, 0.5f);
        vnl[r] = pnjlim(vnl[r], vnl[r] - d, cols[r * 9 + 7], cols[r * 9 + 8]);
      }
    }
    float ib[2], ic[2];
    for (int b = 0; b < 2; ++b) gp_currents(gp[b], vnl[b], vnl[2 + b], ib[b],
                                            ic[b]);
    const float i_abs[4] = {ib[0], ib[1], ic[0], ic[1]};
    float di_new[4];
    for (int k = 0; k < 4; ++k) di_new[k] = i_abs[k] - cols[k * 9 + 1];
    float rs = cols[0 * 9 + 3] * di_new[0];
    for (int k = 1; k < 4; ++k) rs = rs + cols[k * 9 + 3] * di_new[k];
    const int oi = (int)sc(TREM_OUT_IDX);
    const float v_out = (sc(TREM_VDC_OUT) + big[oi]) + rs;

    const float env = st[ST_TREM_ENV];
    const float led = nclamp((sc(TREM_VMAX) - v_out) / sc(TREM_VSPAN), 0.0f,
                             1.0f);
    const float coeff = led > env ? sc(TREM_ATT) : sc(TREM_REL);
    const float env_new = led + coeff * (env - led);
    const float drv = nclamp(env_new, 0.0f, 1.0f);
    const float pw = expf(sc(TREM_GAMMA) * logf(nmax(drv, 1e-30f)));
    const float r_ldr = drv < 1e-6f
                            ? sc(TREM_RMAX)
                            : expf(sc(TREM_LN_RMAX) + sc(TREM_LN_SPAN) * pw);
    const float branch = sc(TREM_R18) + r_ldr;
    const float r_low = ctrl[C_R_LOWER];
    const float low = r_low > 0.0f ? (r_low * branch) / (r_low + branch)
                                   : 0.0f;
    const float gldr = 1.0f / nmax(ctrl[C_DIV_TOP] + low, 1000.0f);

    for (int k = 0; k < 7; ++k) st[ST_TREM_Z + k] = big[k];
    for (int k = 0; k < 4; ++k) st[ST_TREM_DI + k] = di_new[k];
    for (int k = 0; k < 4; ++k) st[ST_TREM_VNL + k] = vnl[k];
    st[ST_TREM_ENV] = env_new;
    st[ST_GLDR_UPD_PREV] = st[ST_GLDR_CUR];
    st[ST_GLDR_CUR] = gldr;
    st[ST_TREM_PHASE] = 0.0f;
  }

  // ── twin DK preamp, one oversampled sample; NOISE adds the thermal
  // noise of the main solver (the diff half) ──
  template <bool NOISE>
  __device__ float preamp_step(float u, float gldr) {
    float npred[8], npp[2];
    if constexpr (NOISE) {
      const float* NS = A + A_PRE_NS;  // (8, 9)
      const float* NP = A + A_PRE_NP;  // (2, 9)
      float un[40];
      for (int k = 0; k < 40; ++k) {
        const uint32_t lcg =
            __float_as_uint(st[ST_NZ_LCG + k]) * 1664525u + 1013904223u;
        st[ST_NZ_LCG + k] = __uint_as_float(lcg);
        uint32_t h = lcg;
        h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
        h = (h ^ (h >> 13)) * 0xC2B2AE35u;
        h = h ^ (h >> 16);
        un[k] = __int2float_rn((int)(h >> 1)) * (float)(2.0 / 4294967295.0)
                - 1.0f;
      }
      const float gain = ctrl[C_NOISE];
      float w[10];
      for (int r = 0; r < 10; ++r)
        w[r] = ((((un[r] + un[10 + r]) + un[20 + r]) + un[30 + r])
                * 0.8660254037844386f) * gain;
      float i_tz[9];
      for (int r = 0; r < 9; ++r) {
        i_tz[r] = w[1 + r] + st[ST_NZ_W + r];  // w[n] + w[n−1]
        st[ST_NZ_W + r] = w[1 + r];
      }
      for (int r = 0; r < 8; ++r) {
        float acc = NS[r * 9] * i_tz[0];
        for (int k = 1; k < 9; ++k) acc = acc + NS[r * 9 + k] * i_tz[k];
        npred[r] = acc;
      }
      for (int r = 0; r < 2; ++r) {
        float acc = NP[r * 9] * i_tz[0];
        for (int k = 1; k < 9; ++k) acc = acc + NP[r * 9 + k] * i_tz[k];
        npp[r] = acc;
      }
      u = u + w[0] * sc(NZ_U_SIGMA);
    }
    const float* SA = A + A_PRE_SA;       // (16, 16)
    const float* SAp = A + A_PRE_SA_P;    // (4, 16)
    const float* cols = A + A_PRE_COLS;   // (8, 4)
    const float* chi = A + A_PRE_COLS_HI;
    const float* clo = A + A_PRE_COLS_LO;
    float d[16];
    for (int k = 0; k < 16; ++k) d[k] = st[ST_PRE_D + k];
    const float gprev = st[ST_PRE_GLDR];
    const float dj0 = st[ST_PRE_DJ], dj1 = st[ST_PRE_DJ + 1];
    const float dpv0 = st[ST_PRE_DPREV], dpv1 = st[ST_PRE_DPREV + 1];
    float dic[4];
    for (int k = 0; k < 4; ++k) dic[k] = st[ST_PRE_DIC + k];

    float sad[16];
    for (int r = 0; r < 16; ++r) {
      float acc = SA[r * 16] * d[0];
      for (int k = 1; k < 16; ++k) acc = acc + SA[r * 16 + k] * d[k];
      sad[r] = acc;
    }
    const float c_fb_sh = -(gprev * d[FB] + (gprev - sc(PRE_G0)) * sc(PRE_VDCFB));
    const float c_b1_sh = dj0 + dpv0;
    const float c_fb_df = (-gprev) * d[8 + FB];
    const float c_b1_df = (sc(PRE_GCIN) * u + dj1) + dpv1;

    // Compensated pb accumulation (TwoSum cascade + Dekker products).
    float pb_sh[8], pb_df[8];
    const float cf_sh[4] = {c_fb_sh, c_b1_sh, dic[0], dic[2]};
    const float cf_df[4] = {c_fb_df, c_b1_df, dic[1], dic[3]};
    for (int half = 0; half < 2; ++half) {
      const float* cf = half ? cf_df : cf_sh;
      float bhi[4], blo[4];
      for (int j = 0; j < 4; ++j) split12(cf[j], bhi[j], blo[j]);
      for (int r = 0; r < 8; ++r) {
        float s = sad[half * 8 + r], lo = 0.0f;
        for (int j = 0; j < 4; ++j) {
          const float p = __fmul_rn(cols[r * 4 + j], cf[j]);
          const float e = prod_err(chi[r * 4 + j], clo[r * 4 + j], bhi[j],
                                   blo[j], p);
          float e2;
          two_sum(s, p, s, e2);
          lo = j == 0 ? __fadd_rn(e, e2) : __fadd_rn(lo, __fadd_rn(e, e2));
        }
        (half ? pb_df : pb_sh)[r] = __fadd_rn(s, lo);
      }
    }
    if constexpr (NOISE) {
      // before tpart: the feedback correction sees the noise through
      // pb_df[FB] as it sees every other rhs current
      for (int r = 0; r < 8; ++r) pb_df[r] = pb_df[r] + npred[r];
    }

    const float smk = gldr / (1.0f + sc(PRE_SFBFB) * gldr);
    const float kc00 = sc(PRE_K00) - smk * sc(PRE_NV0S0);
    const float kc01 = sc(PRE_K01) - smk * sc(PRE_NV0S1);
    const float kc10 = sc(PRE_K10) - smk * sc(PRE_NV1S0);
    const float kc11 = sc(PRE_K11) - smk * sc(PRE_NV1S1);
    const float tpart_sh = smk * pb_sh[FB] + (smk - sc(PRE_SMK0)) * sc(PRE_VPBDCFB);
    const float tpart_df = smk * pb_df[FB];
    // Pump-scale node rows: accumulated in double from the float terms
    // (products exact) and rounded once, as in the plain version.
    double pred_sh[8], pred_df[8];
    for (int r = 0; r < 8; ++r) {
      const double cfb = cols[r * 4];
      pred_sh[r] = (double)pb_sh[r] - (double)tpart_sh * cfb;
      pred_df[r] = (double)pb_df[r] - (double)tpart_df * cfb;
    }
    float p_sad[4];
    for (int r = 0; r < 4; ++r) {
      float acc = SAp[r * 16] * d[0];
      for (int k = 1; k < 16; ++k) acc = acc + SAp[r * 16 + k] * d[k];
      p_sad[r] = acc;
    }
    const float p0_sh = (((((sc(PRE_PDC0) + p_sad[0]) + sc(PRE_CFB_P0) * c_fb_sh)
                          + sc(PRE_CB1_P0) * c_b1_sh) + sc(PRE_CE1_P0) * dic[0])
                         + sc(PRE_CE2_P0) * dic[2]) - tpart_sh * sc(PRE_CFB_P0);
    const float p1_sh = (((((sc(PRE_PDC1) + p_sad[1]) + sc(PRE_CFB_P1) * c_fb_sh)
                          + sc(PRE_CB1_P1) * c_b1_sh) + sc(PRE_CE1_P1) * dic[0])
                         + sc(PRE_CE2_P1) * dic[2]) - tpart_sh * sc(PRE_CFB_P1);
    float p0_df = ((((p_sad[2] + sc(PRE_CFB_P0) * c_fb_df)
                           + sc(PRE_CB1_P0) * c_b1_df) + sc(PRE_CE1_P0) * dic[1])
                         + sc(PRE_CE2_P0) * dic[3]) - tpart_df * sc(PRE_CFB_P0);
    float p1_df = ((((p_sad[3] + sc(PRE_CFB_P1) * c_fb_df)
                     + sc(PRE_CB1_P1) * c_b1_df) + sc(PRE_CE1_P1) * dic[1])
                   + sc(PRE_CE2_P1) * dic[3]) - tpart_df * sc(PRE_CFB_P1);
    if constexpr (NOISE) {
      p0_df = p0_df + npp[0];
      p1_df = p1_df + npp[1];
    }
    const float p0[2] = {p0_sh + p0_df, p0_sh};  // [main, shadow]
    const float p1[2] = {p1_sh + p1_df, p1_sh};

    const float inv_vt = sc(PRE_INV_VT), IS = sc(PRE_IS), is_vt = sc(PRE_IS_VT);
    const float vmax = sc(PRE_VMAX);
    float vnl0[2] = {st[ST_PRE_VNL], st[ST_PRE_VNL + 1]};
    float vnl1[2] = {st[ST_PRE_VNL + 2], st[ST_PRE_VNL + 3]};
    for (int it = 0; it < N_PRE_ITERS; ++it) {
      for (int t = 0; t < 2; ++t) {
        const float e0 = expf(nclamp(vnl0[t], -1.0f, vmax) * inv_vt);
        const float e1 = expf(nclamp(vnl1[t], -1.0f, vmax) * inv_vt);
        const float ic0 = IS * (e0 - 1.0f), gm0 = is_vt * e0;
        const float ic1 = IS * (e1 - 1.0f), gm1 = is_vt * e1;
        const float f0 = ((vnl0[t] - p0[t]) - kc00 * ic0) - kc01 * ic1;
        const float f1 = ((vnl1[t] - p1[t]) - kc10 * ic0) - kc11 * ic1;
        const float j00 = 1.0f - kc00 * gm0;
        const float j01 = (-kc01) * gm1;
        const float j10 = (-kc10) * gm0;
        const float j11 = 1.0f - kc11 * gm1;
        const float det = j00 * j11 - j01 * j10;
        const bool conv = fabsf(f0) < 1e-6f && fabsf(f1) < 1e-6f;
        const bool det_ok = fabsf(det) > 1e-30f;
        const bool ok = !conv && det_ok;
        const float inv = det_ok ? 1.0f / det : 0.0f;
        vnl0[t] = vnl0[t] - (ok ? inv * (j11 * f0 - j01 * f1) : 0.0f);
        vnl1[t] = vnl1[t] - (ok ? inv * (j00 * f1 - j10 * f0) : 0.0f);
      }
    }
    float icn0[2], icn1[2];
    for (int t = 0; t < 2; ++t) {
      icn0[t] = IS * (expf(nclamp(vnl0[t], -1.0f, vmax) * inv_vt) - 1.0f);
      icn1[t] = IS * (expf(nclamp(vnl1[t], -1.0f, vmax) * inv_vt) - 1.0f);
    }
    const float i0_sh = icn0[1], i1_sh = icn1[1];
    const float di0 = icn0[0] - i0_sh, di1 = icn1[0] - i1_sh;
    const float q_sh = smk * (sc(PRE_SFBNI0) * i0_sh + sc(PRE_SFBNI1) * i1_sh)
                       - sc(PRE_Q0);
    const float q_df = smk * (sc(PRE_SFBNI0) * di0 + sc(PRE_SFBNI1) * di1);
    float dn_sh[8], dn_df[8];
    const double a0 = i0_sh - sc(PRE_IDC0), a1 = i1_sh - sc(PRE_IDC1);
    for (int r = 0; r < 8; ++r) {
      const double cfb = cols[r * 4], ce1 = cols[r * 4 + 2],
                   ce2 = cols[r * 4 + 3];
      dn_sh[r] = (float)(((pred_sh[r] + ce1 * a0) + ce2 * a1)
                         - (double)q_sh * cfb);
      dn_df[r] = (float)(((pred_df[r] + ce1 * (double)di0) + ce2 * (double)di1)
                         - (double)q_df * cfb);
    }
    const float dj_sh = sc(PRE_GC1PC) * dn_sh[B1] - sc(PRE_CCIN) * dj0;
    const float dj_df = sc(PRE_GC1PC) * (dn_df[B1] - u) - sc(PRE_CCIN) * dj1;
    for (int r = 0; r < 8; ++r) {
      st[ST_PRE_D + r] = dn_sh[r];
      st[ST_PRE_D + 8 + r] = dn_df[r];
    }
    st[ST_PRE_VNL] = vnl0[0];
    st[ST_PRE_VNL + 1] = vnl0[1];
    st[ST_PRE_VNL + 2] = vnl1[0];
    st[ST_PRE_VNL + 3] = vnl1[1];
    st[ST_PRE_DIC] = i0_sh - sc(PRE_IDC0);
    st[ST_PRE_DIC + 1] = di0;
    st[ST_PRE_DIC + 2] = i1_sh - sc(PRE_IDC1);
    st[ST_PRE_DIC + 3] = di1;
    st[ST_PRE_DJ] = dj_sh;
    st[ST_PRE_DJ + 1] = dj_df;
    st[ST_PRE_DPREV] = dj0;
    st[ST_PRE_DPREV + 1] = sc(PRE_GCIN) * u + dj1;
    st[ST_PRE_GLDR] = gldr;
    return dn_df[OUT];
  }

  // Newton residual f = (v − vnl_dc) − p_dev − corr0 − K·(i − i_dc).
  __device__ void pa_resid(const float* v, const float* i_abs,
                           const float* p_dev, float* f) const {
    const float* Km = A + A_PA_K;
    const float* nv = A + A_PA_NVCOLS;  // (16, 10)
    float di[16];
    for (int k = 0; k < 16; ++k) di[k] = i_abs[k] - nv[k * 10 + 4];
    for (int r = 0; r < 16; ++r) {
      float mv = Km[r * 16] * di[0];
      for (int k = 1; k < 16; ++k) mv = mv + Km[r * 16 + k] * di[k];
      f[r] = (((v[r] - nv[r * 10 + 5]) - p_dev[r]) - nv[r * 10 + 3]) - mv;
    }
  }

  __device__ void pa_currents(const float* v, float* i_abs) const {
    for (int b = 0; b < 8; ++b)
      gp_currents(load_gp(A + A_PA_GP + b * N_GP), v[b], v[8 + b], i_abs[b],
                  i_abs[8 + b]);
  }

  // ── power amp, one oversampled sample ──
  __device__ float pa_step(float x) {
    const float* nv = A + A_PA_NVCOLS;
    const float* P = A + A_PA_P;
    const float* pcols = A + A_PA_COLS;
    const float rail_sag = ctrl[C_RAIL_SAG];
    const float rails[4] = {st[ST_PA_RAILS], st[ST_PA_RAILS + 1],
                            st[ST_PA_RAILS + 2], st[ST_PA_RAILS + 3]};
    const float off_p = (rails[0] - sc(PA_RAIL_BIAS)) * rail_sag;
    const float off_n = (rails[1] - sc(PA_RAIL_BIAS)) * rail_sag;
    float x37[37];
    for (int k = 0; k < 21; ++k) x37[k] = st[ST_PA_Z + k];
    for (int k = 0; k < 16; ++k) x37[21 + k] = st[ST_PA_DI + k];
    float z_new[21], p_dev[16];
    for (int r = 0; r < 37; ++r) {
      float acc = P[r * 37] * x37[0];
      for (int k = 1; k < 37; ++k) acc = acc + P[r * 37 + k] * x37[k];
      if (r < 21)
        z_new[r] = ((acc + pcols[r * 3] * x) + pcols[r * 3 + 1] * off_p)
                   + pcols[r * 3 + 2] * off_n;
      else
        p_dev[r - 21] = ((acc + nv[(r - 21) * 10] * x)
                         + nv[(r - 21) * 10 + 1] * off_p)
                        + nv[(r - 21) * 10 + 2] * off_n;
    }

    float vnl_old[16], ws[16], vnl[16];
    for (int r = 0; r < 16; ++r) {
      vnl_old[r] = st[ST_PA_VNL + r];
      const float wc = r < 8 ? 0.02f : 2.0f;
      const float w = vnl_old[r] + nclamp(vnl_old[r] - st[ST_PA_VNL_PREV + r],
                                          -wc, wc);
      ws[r] = pnjlim(vnl_old[r], w, nv[r * 10 + 8], nv[r * 10 + 9]);
      vnl[r] = ws[r];
    }

    float fn0 = 0.0f;
    for (int it = 0; it < N_PA_ITERS; ++it) {
      float i_abs[16], g[4][8];  // g: dib/dvbe, dib/dvbc, dic/dvbe, dic/dvbc
      for (int b = 0; b < 8; ++b)
        gp_derivs(load_gp(A + A_PA_GP + b * N_GP), vnl[b], vnl[8 + b],
                  i_abs[b], i_abs[8 + b], g[0][b], g[1][b], g[2][b], g[3][b]);
      float f[16];
      pa_resid(vnl, i_abs, p_dev, f);
      float fn = fabsf(f[0]);
      for (int r = 1; r < 16; ++r) fn = nmax(fn, fabsf(f[r]));
      if (it == 0) fn0 = fn;

      // Reduced block system: active ports pivot, relegated ride along.
      const float* Ka = A + A_PA_K_ACT;   // (10, 16)
      const float* Kr = A + A_PA_K_REL;   // (6, 16)
      float blk[N_ACT + 1][N_ACT], crel[N_ACT][N_REL];
      for (int jj = 0; jj < N_ACT; ++jj) {
        const int j = kPaActive[jj], b = j % 8;
        const float g1 = j < 8 ? g[0][b] : g[1][b];
        const float g2 = j < 8 ? g[2][b] : g[3][b];
        for (int ii = 0; ii < N_ACT; ++ii)
          blk[jj][ii] = (A[A_PA_EYE_ACT + ii * N_ACT + jj]
                         - Ka[ii * 16 + b] * g1) - Ka[ii * 16 + b + 8] * g2;
        for (int rr = 0; rr < N_REL; ++rr)
          crel[jj][rr] = (-Kr[rr * 16 + b]) * g1 - Kr[rr * 16 + b + 8] * g2;
      }
      for (int ii = 0; ii < N_ACT; ++ii) blk[N_ACT][ii] = f[kPaActive[ii]];
      float x_act[N_ACT];
      ge_solve<N_ACT>(blk, x_act);
      float dv[16];
      for (int rr = 0; rr < N_REL; ++rr) {
        float acc = f[kPaReleg[rr]];
        for (int jj = 0; jj < N_ACT; ++jj) acc = acc - crel[jj][rr] * x_act[jj];
        dv[kPaReleg[rr]] = acc;
      }
      for (int ii = 0; ii < N_ACT; ++ii) dv[kPaActive[ii]] = x_act[ii];
      for (int r = 0; r < 16; ++r) {
        const float cl = nv[r * 10 + 7];
        float d = nclamp(dv[r], -cl, cl);
        d = fn < 1e-4f ? 0.0f : d;
        vnl[r] = pnjlim(vnl[r], vnl[r] - d, nv[r * 10 + 8], nv[r * 10 + 9]);
      }
    }

    float i_abs[16], f[16];
    pa_currents(vnl, i_abs);
    pa_resid(vnl, i_abs, p_dev, f);
    float fn_final = fabsf(f[0]);
    for (int r = 1; r < 16; ++r) fn_final = nmax(fn_final, fabsf(f[r]));
    // Explosion reset: keep the warm start when NR ended farther away.
    const bool exploded = fn_final > nmax(4.0f * fn0, 1.0f);
    if (exploded) {
      for (int r = 0; r < 16; ++r) vnl[r] = ws[r];
      pa_currents(ws, i_abs);
    }
    float di_new[16];
    for (int k = 0; k < 16; ++k) di_new[k] = i_abs[k] - nv[k * 10 + 4];
    float rs = nv[0 * 10 + 6] * di_new[0];
    for (int k = 1; k < 16; ++k) rs = rs + nv[k * 10 + 6] * di_new[k];
    const int oi = (int)sc(PA_OUT_IDX);
    const float raw = sc(PA_VDC_OUT) + (z_new[oi] + rs);
    const float result = raw * sc(PA_INV_HEADROOM);

    // Divergence guard: hold on NR failure, reset + hold when insane.
    const bool nr_failed = fn_final > 0.5f || exploded;
    float zmax = fabsf(z_new[0]);
    for (int r = 1; r < 21; ++r) zmax = nmax(zmax, fabsf(z_new[r]));
    const bool reset = zmax > 100.0f || !isfinite(result);
    const bool bad = reset || nr_failed;
    for (int r = 0; r < 21; ++r) st[ST_PA_Z + r] = reset ? 0.0f : z_new[r];
    for (int r = 0; r < 16; ++r) {
      st[ST_PA_DI + r] = reset ? 0.0f : di_new[r];
      st[ST_PA_VNL + r] = reset ? nv[r * 10 + 5] : vnl[r];
      st[ST_PA_VNL_PREV + r] = reset ? nv[r * 10 + 5] : vnl_old[r];
    }
    const float out = bad ? st[ST_PA_LASTGOOD] : nclamp(result, -1.0f, 1.0f);
    st[ST_PA_LASTGOOD] = out;

    // Rail dynamics from the raw output voltage.
    const float i_pos = nmax(raw * sc(PA_INV_LOAD), 0.0f);
    const float i_neg = nmax((-raw) * sc(PA_INV_LOAD), 0.0f);
    const float iavg_p = rails[2] + sc(PA_A_IAVG) * (i_pos - rails[2]);
    const float iavg_n = rails[3] + sc(PA_A_IAVG) * (i_neg - rails[3]);
    const float tgt_p = sc(PA_RAIL_OPEN) - iavg_p * sc(PA_RAIL_REFF);
    const float tgt_n = sc(PA_RAIL_OPEN) - iavg_n * sc(PA_RAIL_REFF);
    const float a_p = tgt_p < rails[0] ? sc(PA_A_ATT) : sc(PA_A_REL);
    const float a_n = tgt_n < rails[1] ? sc(PA_A_ATT) : sc(PA_A_REL);
    const float new_rails[4] = {rails[0] + a_p * (tgt_p - rails[0]),
                                rails[1] + a_n * (tgt_n - rails[1]), iavg_p,
                                iavg_n};
    const float init_rails[4] = {sc(PA_RAIL_BIAS), sc(PA_RAIL_BIAS), 0.0f,
                                 0.0f};
    const bool sag_on = rail_sag > 0.5f;
    for (int k = 0; k < 4; ++k)
      st[ST_PA_RAILS + k] = sag_on ? (bad ? init_rails[k] : new_rails[k])
                                   : rails[k];
    return out;
  }

  __device__ float allpass(int coeff0, int state_off, float x) {
    float y = x;
    for (int i = 0; i < 3; ++i) {
      const float a = sc(coeff0 + i);
      const float o = a * y + st[state_off + i];
      st[state_off + i] = y - a * o;
      y = o;
    }
    return y;
  }

  __device__ float bq(int rows, int state_off, float xin) {
    const float b0 = ctrl[rows], b1 = ctrl[rows + 1], b2 = ctrl[rows + 2];
    const float a1 = ctrl[rows + 3], a2 = ctrl[rows + 4];
    const float y = b0 * xin + st[state_off];
    const float z1 = (b1 * xin - a1 * y) + st[state_off + 1];
    const float z2 = b2 * xin - a2 * y;
    st[state_off] = z1;
    st[state_off + 1] = z2;
    return y;
  }

  // ── one base-rate sample ──
  template <bool NOISE>
  __device__ float base_step(float x) {
    const float e = allpass(OS_A0, ST_OS_UA, x);
    const float o = allpass(OS_B0, ST_OS_UB, x);
    const float g_cur = st[ST_GLDR_CUR], g_prev = st[ST_GLDR_UPD_PREV];
    const float ph = st[ST_TREM_PHASE];
    float ys[2];
    for (int t_os = 0; t_os < 2; ++t_os) {
      const float frac = (ph + (float)(t_os + 1)) * 0.25f;
      const float gldr = g_prev + frac * (g_cur - g_prev);
      const float pre_out = preamp_step<NOISE>(t_os ? o : e, gldr);
      ys[t_os] = pa_step(pre_out * sc(DRIVE));
    }
    st[ST_TREM_PHASE] = ph + 2.0f;
    const float a = allpass(OS_A0, ST_OS_DA, ys[0]);
    const float b = allpass(OS_B0, ST_OS_DB, ys[1]);
    const float amp_out = (a + st[ST_OS_DELAY]) * 0.5f;
    st[ST_OS_DELAY] = b;

    const float a2 = ctrl[C_A2], a3 = ctrl[C_A3];
    const float x2 = amp_out * amp_out;
    const float shaped = ((amp_out + a2 * x2) + (a3 * x2) * amp_out)
                         / ((1.0f + a2) + a3);
    const float limited = ctrl[C_CHAR] < 0.001f ? shaped : tanhf(shaped);
    const float th = st[ST_SPK_THERMAL];
    const float thermal = th + (x2 - th) * sc(SPK_THERMAL_ALPHA);
    const float tgain = 1.0f / (1.0f + ctrl[C_THERMAL] * sqrtf(thermal));
    st[ST_SPK_THERMAL] = thermal;
    const float filt = bq(C_HPF, ST_SPK_HPF, limited * tgain);
    const float spk_out = bq(C_LPF, ST_SPK_LPF, filt);
    const float out = (spk_out * sc(POST_GAIN)) * ctrl[C_VOLUME];

    // Final NaN guard: reset the chain, output silence.
    if (!isfinite(out)) {
      const int zero_spans[][2] = {
          {ST_PRE_D, 16}, {ST_PRE_DIC, 4}, {ST_PRE_DJ, 2}, {ST_PRE_DPREV, 2},
          {ST_PA_Z, 21}, {ST_PA_DI, 16}, {ST_OS_UA, 3}, {ST_OS_UB, 3},
          {ST_OS_DA, 3}, {ST_OS_DB, 3}, {ST_OS_DELAY, 1}, {ST_SPK_HPF, 2},
          {ST_SPK_LPF, 2}, {ST_SPK_THERMAL, 1}, {ST_PA_LASTGOOD, 1}};
      for (const auto& zs : zero_spans)
        for (int k = 0; k < zs[1]; ++k) st[zs[0] + k] = 0.0f;
      st[ST_PRE_VNL] = st[ST_PRE_VNL + 1] = sc(PRE_VNL_DC0);
      st[ST_PRE_VNL + 2] = st[ST_PRE_VNL + 3] = sc(PRE_VNL_DC1);
      for (int r = 0; r < 16; ++r)
        st[ST_PA_VNL + r] = st[ST_PA_VNL_PREV + r] = A[A_PA_NVCOLS + r * 10 + 5];
      st[ST_GUARD_FIRES] = st[ST_GUARD_FIRES] + 1.0f;
      return 0.0f;
    }
    st[ST_GUARD_FIRES] = st[ST_GUARD_FIRES] + 0.0f;
    return out;
  }
};

template <bool NOISE>
__global__ void __launch_bounds__(64)
mono_chain_kernel(const float* __restrict__ consts,
                  const float* __restrict__ scalars,
                  const float* __restrict__ controls,
                  const float* __restrict__ state_in,
                  const float* __restrict__ audio, float* __restrict__ out,
                  float* __restrict__ state_out, int streams, int t_len) {
  __shared__ float s_consts[A_TOTAL];
  __shared__ float s_scalars[N_SCALARS];
  for (int i = threadIdx.x; i < A_TOTAL; i += blockDim.x)
    s_consts[i] = consts[i];
  for (int i = threadIdx.x; i < N_SCALARS; i += blockDim.x)
    s_scalars[i] = scalars[i];
  __syncthreads();

  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= streams) return;
  Chain ch;
  ch.A = s_consts;
  ch.K = s_scalars;
  for (int r = 0; r < CTRL_ROWS; ++r) ch.ctrl[r] = controls[r * streams + s];
  for (int r = 0; r < STATE_ROWS; ++r) ch.st[r] = state_in[r * streams + s];

  for (int i = 0; i < t_len; ++i) {
    if (i % 2 == 0) ch.trem_update();  // SUB_BASE = 2, before base_step
    out[(size_t)i * streams + s] =
        ch.base_step<NOISE>(audio[(size_t)i * streams + s]);
  }
  for (int r = 0; r < STATE_ROWS; ++r) state_out[r * streams + s] = ch.st[r];
}

// K4: thread 0 walks n_captures intervals of steps_per_capture tremolo
// updates; caps[k] is the state entering interval k (before its first
// update), in the order trem_z, trem_di, trem_vnl, trem_env, gldr_cur,
// gldr_upd_prev, trem_phase.
constexpr int PREROLL_ROWS = 19;
__constant__ int kPrerollSpans[7][2] = {
    {ST_TREM_Z, 7},      {ST_TREM_DI, 4},       {ST_TREM_VNL, 4},
    {ST_TREM_ENV, 1},    {ST_GLDR_CUR, 1},      {ST_GLDR_UPD_PREV, 1},
    {ST_TREM_PHASE, 1}};

__global__ void __launch_bounds__(64)
trem_preroll_kernel(const float* __restrict__ consts,
                    const float* __restrict__ scalars,
                    const float* __restrict__ controls,
                    const float* __restrict__ state_in,
                    float* __restrict__ caps, int n_captures,
                    int steps_per_capture) {
  __shared__ float s_consts[A_TOTAL];
  __shared__ float s_scalars[N_SCALARS];
  for (int i = threadIdx.x; i < A_TOTAL; i += blockDim.x)
    s_consts[i] = consts[i];
  for (int i = threadIdx.x; i < N_SCALARS; i += blockDim.x)
    s_scalars[i] = scalars[i];
  __syncthreads();
  if (threadIdx.x != 0) return;

  Chain ch;
  ch.A = s_consts;
  ch.K = s_scalars;
  for (int r = 0; r < CTRL_ROWS; ++r) ch.ctrl[r] = controls[r];
  for (int r = 0; r < STATE_ROWS; ++r) ch.st[r] = state_in[r];
  for (int k = 0; k < n_captures; ++k) {
    int col = 0;
    for (int sp = 0; sp < 7; ++sp)
      for (int r = 0; r < kPrerollSpans[sp][1]; ++r)
        caps[k * PREROLL_ROWS + col++] = ch.st[kPrerollSpans[sp][0] + r];
    // the updates after the last capture would reach no output
    if (k + 1 < n_captures)
      for (int i = 0; i < steps_per_capture; ++i) ch.trem_update();
  }
}

}  // namespace

extern "C" int ow_trem_preroll(const float* consts, int n_consts,
                               const float* scalars, int n_scalars,
                               const float* controls, const float* state_in,
                               float* caps, int n_captures,
                               int steps_per_capture, cudaStream_t stream) {
  if (n_consts != A_TOTAL || n_scalars != N_SCALARS || n_captures <= 0 ||
      steps_per_capture <= 0)
    return (int)cudaErrorInvalidValue;
  trem_preroll_kernel<<<1, 64, 0, stream>>>(consts, scalars, controls,
                                            state_in, caps, n_captures,
                                            steps_per_capture);
  return (int)cudaGetLastError();
}

namespace {

template <bool NOISE>
int launch_mono_chain(const float* consts, int n_consts, const float* scalars,
                      int n_scalars, const float* controls,
                      const float* state_in, const float* audio, float* out,
                      float* state_out, int streams, int t_len,
                      cudaStream_t stream) {
  if (n_consts != A_TOTAL || n_scalars != N_SCALARS || streams <= 0 ||
      t_len < 0)
    return (int)cudaErrorInvalidValue;
  const int threads = 64;
  const int blocks = (streams + threads - 1) / threads;
  mono_chain_kernel<NOISE><<<blocks, threads, 0, stream>>>(
      consts, scalars, controls, state_in, audio, out, state_out, streams,
      t_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ow_mono_chain(const float* consts, int n_consts,
                             const float* scalars, int n_scalars,
                             const float* controls, const float* state_in,
                             const float* audio, float* out, float* state_out,
                             int streams, int t_len, cudaStream_t stream) {
  return launch_mono_chain<false>(consts, n_consts, scalars, n_scalars,
                                  controls, state_in, audio, out, state_out,
                                  streams, t_len, stream);
}

// K5: the same call with the thermal-noise branch compiled in.
extern "C" int ow_mono_chain_noise(const float* consts, int n_consts,
                                   const float* scalars, int n_scalars,
                                   const float* controls,
                                   const float* state_in, const float* audio,
                                   float* out, float* state_out, int streams,
                                   int t_len, cudaStream_t stream) {
  return launch_mono_chain<true>(consts, n_consts, scalars, n_scalars,
                                 controls, state_in, audio, out, state_out,
                                 streams, t_len, stream);
}
