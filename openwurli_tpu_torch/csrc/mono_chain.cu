// Mono analog chain (kernel K2) for Hopper: tremolo → twin DK preamp →
// Class-AB power amp → 2× oversampling → speaker, one warp per stream.
//
// Replaces: openwurli_tpu/kernels/mono_chain.py, `_make_kernel` (`kernel`)
// as launched by `_render_tpu_jit` / `render_tpu`, noise=False.
//
// What bounds it on this card: a stream is one long serial recurrence.
// Per base sample: a tremolo update every 2nd sample, then two
// oversampled preamp + power-amp solves, each power-amp solve 8 Newton
// iterations with a 10×10 elimination; about 65800 f32 operations, nine
// tenths of them in the power amp. Device memory traffic is negligible
// (one f32 in and one out per sample and stream), and the card's issue
// rate is far away: time is the length of the chain of dependent
// operations per sample times the sample count, whatever the width until
// the warps of many streams fill the SMs' issue slots. Walked in order by
// one thread, that chain is every operation of the sample.
//
// What the design does about it: one warp computes one stream, and the
// operations that do not depend on one another go to separate lanes, so
// the dependent chain per sample is the critical path of each solve, not
// its operation count. That path is now mostly the power amp's Newton
// iterations: per iteration the transistors' exps, a 16-term residual row,
// ten elimination steps (each a shuffle of the pivot, an IEEE division and
// an update), ten back-substitution steps and the relegated rows; then
// the replicated tremolo (about a twentieth of a sample's time) and the
// preamp. A block holds kWarps warps = kWarps streams; the warps are
// independent, so kWarps only sets how many blocks cover the streams.
//  * Power amp: the 37 history rows on 32 lanes (lanes 0-4 take a second
//    row); the 8 Gummel-Poon transistors and the 16 residual rows on lanes
//    0-15 (lanes 16-31 mirror them); the 10×10 elimination with lane
//    (row i, column group cg) = i + 10·cg owning rows i of columns
//    4cg..4cg+3 (the right-hand side is column 10, group 2), the pivot and
//    each update's operands broadcast by shuffles, the back-substitution on
//    the right-hand side's lanes, every solution element on every lane;
//    the 6 relegated rows and the clamp / pnjlim on the lanes that own
//    their rows.
//  * Preamp: the 16 SA rows and 4 SAp rows on lanes 0-19; the 16
//    compensated pb rows (8 rows × 2 halves) and the 16 double-precision
//    node rows on lanes 0-15, row r on lane r; the twin 2×2 Newton and the
//    scalar algebra replicated on every lane.
//  * Thermal noise (K5): lane l owns LCG word l, lanes 0-7 also word
//    32 + l; the 10 draws are summed on lanes 0-9 in the plain order, the
//    two-draw stamp on lanes 1-9, the (8, 9) and (2, 9) noise rows on
//    lanes 8-17.
//  * The tremolo (it never reads the audio), allpasses, speaker, rails,
//    guards and scalar algebra are short or serial: every lane runs them
//    on the same inputs and gets the same bits, with no divergence.
// Each value is computed by one lane with the operations, and in the
// order, of the plain torch version (`openwurli_tpu_torch/kernels/
// mono_chain.py`): dot products are summed within one lane in index order
// (no tree reductions), the elimination updates every row of the remaining
// columns (rows at and above the pivot with a zero multiplier, whose
// 0·inf = NaN the plain version shares), and max-reductions are butterfly
// shuffles (a max does not depend on its order; with a NaN anywhere every
// order gives NaN, so the comparisons on it stay uniform across the warp).
// No FMA contraction (built with -fmad=false): the compensated
// TwoSum/Dekker pb accumulation needs unfused, correctly rounded adds and
// multiplies, and matching rounding keeps this kernel bit-identical to its
// plain twin on a chain whose free trajectory amplifies ulp-level
// differences. The preamp's pump-scale node rows are accumulated in double
// and rounded once. Guards keep select semantics: NaNs propagate through
// min/max/clamp as they do in torch. No tensor cores: the chain is f32
// summed in index order, and TF32 would be a different chain.
//
// State: each lane keeps the rows it owns in registers (the power amp's
// node voltages, the noise words) and every lane a copy of the replicated
// rows; the vectors that all lanes read (the PA history x = [z, di], the
// preamp's d, the Newton iterate's currents and conductances) sit in a
// small per-warp area of shared memory, written by their owners between
// __syncwarp()s. The packed (STATE_ROWS, S) layout is read once and written
// once. Constants are staged in shared memory once per block; the
// matrices that lanes read row-wise with a stride of 16 (pre_SA / pre_SA_p,
// pa_K, pa_K_act, pa_K_rel) also as transposed copies, free of bank
// conflicts.
//
// Thermal-noise variant (kernel K5), `mono_chain_kernel<true>`. Replaces the
// same `_make_kernel` launched with noise=True: `preamp_step`'s noise
// branch. Per oversampled sample each stream advances its 40 LCG words
// (×1664525 + 1013904223), hashes each (murmur3 finalizer), turns the top
// 31 bits into a uniform and sums four into one of 10 unit-variance draws;
// the draws, scaled by the `noise` control row, enter the main solver's
// right-hand side through the pack-time columns pre_NS / pre_NP as the
// two-draw stamp w[n] + w[n−1], and draw 0 rides the input. It is the same
// template as K2 with every addition under `if constexpr (NOISE)`; the
// noise-off instantiation carries the nz_ rows untouched. LCG words pass
// only through loads, stores, shuffles and __float_as_uint.
//
// Tremolo pre-roll (kernel K4), `trem_preroll_kernel` at the end of this
// file. Replaces: openwurli_tpu/kernels/mono_chain.py, `_make_preroll_kernel`
// as launched by `_trem_preroll_jit` / `trem_preroll`. It advances only the
// tremolo-owned rows and writes them out once per capture interval. It is
// one serial recurrence (each update needs the one before), so its time is
// the critical path of one update times the number of updates; the bytes
// (19 floats per capture) are nothing beside it. One warp computes each
// update (`TremWarp`): the history matvec's rows, the two transistors, the
// residual rows, the Jacobian's elements and the clamp / pnjlim rows on
// their own lanes, the 4×4 elimination on every lane from broadcast
// inputs, every constant in the registers of the lanes that use it. The
// LDR tail, which nothing in the recurrence reads, runs only where a
// capture reads it. Each value has `trem_update`'s operations in its order,
// so the captures are K2's own tremolo states, bit for bit.

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
constexpr int kPaActive[N_ACT] = {0, 1, 2, 3, 4, 5, 6, 7, 10, 12};
constexpr int kPaReleg[N_REL] = {8, 9, 11, 13, 14, 15};
// The two port lists as functions the device code can call with a
// lane-dependent index (and fold with a constant one).
__host__ __device__ constexpr int pa_active(int jj) {
  return jj < 8 ? jj : (jj == 8 ? 10 : 12);
}
__host__ __device__ constexpr int pa_releg(int rr) {
  return rr < 2 ? 8 + rr : (rr == 2 ? 11 : 10 + rr);
}
constexpr bool ports_match() {
  for (int jj = 0; jj < N_ACT; ++jj)
    if (pa_active(jj) != kPaActive[jj]) return false;
  for (int rr = 0; rr < N_REL; ++rr)
    if (pa_releg(rr) != kPaReleg[rr]) return false;
  return true;
}
static_assert(ports_match(), "pa_active / pa_releg differ from the lists");

constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarps = 4;  // streams (warps) per block

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
__device__ __forceinline__ void gp_derivs(const Gp& p, float vbe, float vbc,
                                          float& ib, float& ic, float& gbb,
                                          float& gbc, float& gcb,
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

__device__ __forceinline__ void gp_currents(const Gp& p, float vbe,
                                            float vbc, float& ib, float& ic) {
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

// The tremolo-owned rows, in the pre-roll's capture order (K4 writes them
// out in this order; K2 keeps a copy on every lane).
constexpr int PREROLL_ROWS = 19;
constexpr int kPrerollSpans[7][2] = {
    {ST_TREM_Z, 7},      {ST_TREM_DI, 4},       {ST_TREM_VNL, 4},
    {ST_TREM_ENV, 1},    {ST_GLDR_CUR, 1},      {ST_GLDR_UPD_PREV, 1},
    {ST_TREM_PHASE, 1}};
constexpr int T_Z = 0, T_DI = 7, T_VNL = 11, T_ENV = 15, T_GLDR_CUR = 16,
              T_GLDR_UPD_PREV = 17, T_PHASE = 18;
// packed state row of capture row k
__host__ __device__ constexpr int trem_row(int k) {
  return k < T_DI      ? ST_TREM_Z + k
       : k < T_VNL     ? ST_TREM_DI + (k - T_DI)
       : k < T_ENV     ? ST_TREM_VNL + (k - T_VNL)
       : k == T_ENV    ? ST_TREM_ENV
       : k == T_GLDR_CUR ? ST_GLDR_CUR
       : k == T_GLDR_UPD_PREV ? ST_GLDR_UPD_PREV
                       : ST_TREM_PHASE;
}
constexpr bool spans_match() {
  int col = 0;
  for (const auto& sp : kPrerollSpans)
    for (int r = 0; r < sp[1]; ++r)
      if (trem_row(col++) != sp[0] + r) return false;
  return col == PREROLL_ROWS;
}
static_assert(spans_match(), "trem_row differs from kPrerollSpans");

struct TremState {
  float v[PREROLL_ROWS];
};

// The tremolo's envelope: the LED drive from the oscillator's output
// voltage, one attack/release step.
__device__ __forceinline__ float trem_env(const float* K, float v_out,
                                          float env) {
  const float led = nclamp((K[TREM_VMAX] - v_out) / K[TREM_VSPAN], 0.0f,
                           1.0f);
  const float coeff = led > env ? K[TREM_ATT] : K[TREM_REL];
  return led + coeff * (env - led);
}

// The LDR tail: the divider's conductance gldr from the new envelope.
// Nothing in the tremolo's recurrence reads it; the chain reads the last
// two.
__device__ __forceinline__ float trem_gldr(const float* K, float env_new,
                                           float r_low, float div_top) {
  const float drv = nclamp(env_new, 0.0f, 1.0f);
  const float pw = expf(K[TREM_GAMMA] * logf(nmax(drv, 1e-30f)));
  const float r_ldr = drv < 1e-6f
                          ? K[TREM_RMAX]
                          : expf(K[TREM_LN_RMAX] + K[TREM_LN_SPAN] * pw);
  const float branch = K[TREM_R18] + r_ldr;
  const float low = r_low > 0.0f ? (r_low * branch) / (r_low + branch)
                                 : 0.0f;
  return 1.0f / nmax(div_top + low, 1000.0f);
}

// ── tremolo: one subsampled update of the tremolo-owned rows (K2 and K5
// run it on every lane) ──
__device__ void trem_update(const float* A, const float* K, float r_low,
                            float div_top, TremState& t) {
  const float* P = A + A_TREM_P;      // (11, 11)
  const float* Km = A + A_TREM_K;     // (4, 4)
  const float* cols = A + A_TREM_COLS;  // (7, 9)
  Gp gp[2] = {load_gp(A + A_TREM_GP), load_gp(A + A_TREM_GP + N_GP)};
  float x11[11];
#pragma unroll
  for (int k = 0; k < 7; ++k) x11[k] = t.v[T_Z + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) x11[7 + k] = t.v[T_DI + k];
  float big[11];
#pragma unroll
  for (int r = 0; r < 11; ++r) {
    float acc = P[r * 11] * x11[0];
#pragma unroll
    for (int k = 1; k < 11; ++k) acc = acc + P[r * 11 + k] * x11[k];
    big[r] = acc;
  }
  float vnl[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) vnl[r] = t.v[T_VNL + r];
  // left rolled: unrolled, the three iterations cost K2 time
  for (int it = 0; it < N_TREM_ITERS; ++it) {
    float ib[2], ic[2], gbb[2], gbc[2], gcb[2], gcc[2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
      gp_derivs(gp[b], vnl[b], vnl[2 + b], ib[b], ic[b], gbb[b], gbc[b],
                gcb[b], gcc[b]);
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
    ge_solve<4>(blk, dv);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float d = nclamp(dv[r], -0.5f, 0.5f);
      vnl[r] = pnjlim(vnl[r], vnl[r] - d, cols[r * 9 + 7], cols[r * 9 + 8]);
    }
  }
  float ib[2], ic[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) gp_currents(gp[b], vnl[b], vnl[2 + b], ib[b],
                                          ic[b]);
  const float i_abs[4] = {ib[0], ib[1], ic[0], ic[1]};
  float di_new[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) di_new[k] = i_abs[k] - cols[k * 9 + 1];
  float rs = cols[0 * 9 + 3] * di_new[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) rs = rs + cols[k * 9 + 3] * di_new[k];
  // big[oi] at a runtime row, as a select chain: the array stays in
  // registers
  const int oi = (int)K[TREM_OUT_IDX];
  float big_oi = big[0];
#pragma unroll
  for (int k = 1; k < 11; ++k) big_oi = k == oi ? big[k] : big_oi;
  const float v_out = (K[TREM_VDC_OUT] + big_oi) + rs;

  const float env_new = trem_env(K, v_out, t.v[T_ENV]);
  const float gldr = trem_gldr(K, env_new, r_low, div_top);

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

// One warp's rows in shared memory: the vectors that every lane reads.
struct Scratch {
  float ctrl[CTRL_ROWS];
  float x37[37];   // the PA history vector: pa_z (21), then pa_di (16)
  float d[16];     // pre_d
  float di[16];    // PA Newton: i_abs − i_dc of the current iterate
  float g[4][8];   // PA Newton: dib/dvbe, dib/dvbc, dic/dvbe, dic/dvbc
};

// Constants in shared memory, one copy per block.
struct Tables {
  const float* A;    // the packed constant arrays
  const float* K;    // the scalars
  const float* saT;  // [pre_SA; pre_SA_p] transposed: saT[k·20 + r]
  const float* kT;   // pa_K transposed: kT[k·16 + r]
  const float* kaT;  // pa_K_act transposed: kaT[k·10 + i]
  const float* krT;  // pa_K_rel transposed: krT[k·6 + r]
};

__device__ __forceinline__ float bcast(float v, int src) {
  return __shfl_sync(FULL, v, src);
}

// max over 16 rows held by lanes 0-15 (and mirrored on lanes 16-31), on
// every lane
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = nmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float lcg_uniform(uint32_t& word) {
  const uint32_t lcg = word * 1664525u + 1013904223u;
  word = lcg;
  uint32_t h = lcg;
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  h = h ^ (h >> 16);
  return __int2float_rn((int)(h >> 1)) * (float)(2.0 / 4294967295.0) - 1.0f;
}

struct Chain {
  Tables T;
  Scratch* w;
  int lane, r16;       // r16: the 16-row index (lanes 16-31 mirror 0-15)
  int gi, gcg;         // elimination: row and column group of this lane
  int rel_rr;          // relegated row of r16, or -1
  TremState tr;
  // replicated rows
  float pre_vnl[4], pre_dic[4], pre_dj[2], pre_dprev[2], pre_gldr;
  float rails[4], lastgood;
  float os_ua[3], os_ub[3], os_da[3], os_db[3], os_delay;
  float spk_hpf[2], spk_lpf[2], spk_thermal, guard;
  // rows this lane owns
  float vnl, vnl_prev;        // pa_vnl / pa_vnl_prev row r16
  uint32_t lcg_a, lcg_b;      // nz_lcg words lane and 32 + lane (lanes 0-7)
  float nz_w;                 // nz_w row lane − 1 (lanes 1-9)

  __device__ float sc(int i) const { return T.K[i]; }

  // ── twin DK preamp, one oversampled sample; NOISE adds the thermal
  // noise of the main solver (the diff half) ──
  template <bool NOISE>
  __device__ float preamp_step(float u, float gldr) {
    const float* A = T.A;
    float npv = 0.0f;  // lanes 8-17: row lane − 8 of [NS; NP] · i_tz
    if constexpr (NOISE) {
      const float ua = lcg_uniform(lcg_a);  // un[lane]
      const float ub = lcg_uniform(lcg_b);  // un[32 + lane], lanes 0-7
      const float t1 = bcast(ua, (lane + 10) & 31);
      const float t2 = bcast(ua, (lane + 20) & 31);
      const float t3a = bcast(ua, (lane + 30) & 31);
      const float t3b = bcast(ub, (lane + 30) & 31);
      // draw r on lane r (0-9): ((un[r] + un[10+r]) + un[20+r]) + un[30+r]
      const float wd = ((((ua + t1) + t2) + (lane < 2 ? t3a : t3b))
                        * 0.8660254037844386f) * w->ctrl[C_NOISE];
      const float itz = wd + nz_w;  // i_tz[lane − 1] = w[n] + w[n−1]
      nz_w = wd;
      float i_tz[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) i_tz[k] = bcast(itz, k + 1);
      // pre_NS (8, 9) and pre_NP (2, 9) are consecutive in the buffer
      const float* ns = A + A_PRE_NS + min((lane - 8) & 15, 9) * 9;
      float acc = ns[0] * i_tz[0];
#pragma unroll
      for (int k = 1; k < 9; ++k) acc = acc + ns[k] * i_tz[k];
      npv = acc;
      u = u + bcast(wd, 0) * sc(NZ_U_SIGMA);
    }
    const float* cols = A + A_PRE_COLS;   // (8, 4)
    const float* chi = A + A_PRE_COLS_HI;
    const float* clo = A + A_PRE_COLS_LO;
    const float* d = w->d;
    // lanes 0-15: SA row lane; lanes 16-19: SAp row lane − 16
    const int prow = lane < 20 ? lane : lane - 20;
    float sad = T.saT[prow] * d[0];
#pragma unroll
    for (int k = 1; k < 16; ++k) sad = sad + T.saT[k * 20 + prow] * d[k];

    const float gprev = pre_gldr;
    const float dj0 = pre_dj[0], dj1 = pre_dj[1];
    const float dpv0 = pre_dprev[0], dpv1 = pre_dprev[1];
    const float c_fb_sh =
        -(gprev * d[FB] + (gprev - sc(PRE_G0)) * sc(PRE_VDCFB));
    const float c_b1_sh = dj0 + dpv0;
    const float c_fb_df = (-gprev) * d[8 + FB];
    const float c_b1_df = (sc(PRE_GCIN) * u + dj1) + dpv1;

    // Compensated pb accumulation (TwoSum cascade + Dekker products): row
    // rr of half `half` on lane r16 = 8·half + rr.
    const int half = r16 >> 3, rr = r16 & 7;
    const float cf[4] = {half ? c_fb_df : c_fb_sh, half ? c_b1_df : c_b1_sh,
                         half ? pre_dic[1] : pre_dic[0],
                         half ? pre_dic[3] : pre_dic[2]};
    float s = sad, lo = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float bhi, blo;
      split12(cf[j], bhi, blo);
      const float p = __fmul_rn(cols[rr * 4 + j], cf[j]);
      const float e = prod_err(chi[rr * 4 + j], clo[rr * 4 + j], bhi, blo, p);
      float e2;
      two_sum(s, p, s, e2);
      lo = j == 0 ? __fadd_rn(e, e2) : __fadd_rn(lo, __fadd_rn(e, e2));
    }
    float pb = __fadd_rn(s, lo);
    if constexpr (NOISE) {
      // before tpart: the feedback correction sees the noise through
      // pb_df[FB] as it sees every other rhs current
      pb = half ? pb + npv : pb;
    }

    const float smk = gldr / (1.0f + sc(PRE_SFBFB) * gldr);
    const float kc00 = sc(PRE_K00) - smk * sc(PRE_NV0S0);
    const float kc01 = sc(PRE_K01) - smk * sc(PRE_NV0S1);
    const float kc10 = sc(PRE_K10) - smk * sc(PRE_NV1S0);
    const float kc11 = sc(PRE_K11) - smk * sc(PRE_NV1S1);
    const float tpart_sh = smk * bcast(pb, FB)
                           + (smk - sc(PRE_SMK0)) * sc(PRE_VPBDCFB);
    const float tpart_df = smk * bcast(pb, 8 + FB);
    // Pump-scale node rows: accumulated in double from the float terms
    // (products exact) and rounded once, as in the plain version.
    const double cfb = cols[rr * 4];
    const double pred = (double)pb - (double)(half ? tpart_df : tpart_sh) * cfb;
    float p_sad[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) p_sad[r] = bcast(sad, 16 + r);
    const float p0_sh = (((((sc(PRE_PDC0) + p_sad[0]) + sc(PRE_CFB_P0) * c_fb_sh)
                          + sc(PRE_CB1_P0) * c_b1_sh) + sc(PRE_CE1_P0) * pre_dic[0])
                         + sc(PRE_CE2_P0) * pre_dic[2]) - tpart_sh * sc(PRE_CFB_P0);
    const float p1_sh = (((((sc(PRE_PDC1) + p_sad[1]) + sc(PRE_CFB_P1) * c_fb_sh)
                          + sc(PRE_CB1_P1) * c_b1_sh) + sc(PRE_CE1_P1) * pre_dic[0])
                         + sc(PRE_CE2_P1) * pre_dic[2]) - tpart_sh * sc(PRE_CFB_P1);
    float p0_df = ((((p_sad[2] + sc(PRE_CFB_P0) * c_fb_df)
                           + sc(PRE_CB1_P0) * c_b1_df) + sc(PRE_CE1_P0) * pre_dic[1])
                         + sc(PRE_CE2_P0) * pre_dic[3]) - tpart_df * sc(PRE_CFB_P0);
    float p1_df = ((((p_sad[3] + sc(PRE_CFB_P1) * c_fb_df)
                     + sc(PRE_CB1_P1) * c_b1_df) + sc(PRE_CE1_P1) * pre_dic[1])
                   + sc(PRE_CE2_P1) * pre_dic[3]) - tpart_df * sc(PRE_CFB_P1);
    if constexpr (NOISE) {
      p0_df = p0_df + bcast(npv, 16);
      p1_df = p1_df + bcast(npv, 17);
    }
    const float p0[2] = {p0_sh + p0_df, p0_sh};  // [main, shadow]
    const float p1[2] = {p1_sh + p1_df, p1_sh};

    const float inv_vt = sc(PRE_INV_VT), IS = sc(PRE_IS), is_vt = sc(PRE_IS_VT);
    const float vmax = sc(PRE_VMAX);
    float vnl0[2] = {pre_vnl[0], pre_vnl[1]};
    float vnl1[2] = {pre_vnl[2], pre_vnl[3]};
#pragma unroll
    for (int it = 0; it < N_PRE_ITERS; ++it) {
#pragma unroll
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
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      icn0[t] = IS * (expf(nclamp(vnl0[t], -1.0f, vmax) * inv_vt) - 1.0f);
      icn1[t] = IS * (expf(nclamp(vnl1[t], -1.0f, vmax) * inv_vt) - 1.0f);
    }
    const float i0_sh = icn0[1], i1_sh = icn1[1];
    const float di0 = icn0[0] - i0_sh, di1 = icn1[0] - i1_sh;
    const float q_sh = smk * (sc(PRE_SFBNI0) * i0_sh + sc(PRE_SFBNI1) * i1_sh)
                       - sc(PRE_Q0);
    const float q_df = smk * (sc(PRE_SFBNI0) * di0 + sc(PRE_SFBNI1) * di1);
    const double a0 = i0_sh - sc(PRE_IDC0), a1 = i1_sh - sc(PRE_IDC1);
    const double ce1 = cols[rr * 4 + 2], ce2 = cols[rr * 4 + 3];
    const float dn_sh = (float)(((pred + ce1 * a0) + ce2 * a1)
                                - (double)q_sh * cfb);
    const float dn_df = (float)(((pred + ce1 * (double)di0)
                                 + ce2 * (double)di1) - (double)q_df * cfb);
    const float dn = half ? dn_df : dn_sh;
    const float dj_sh = sc(PRE_GC1PC) * bcast(dn, B1) - sc(PRE_CCIN) * dj0;
    const float dj_df = sc(PRE_GC1PC) * (bcast(dn, 8 + B1) - u)
                        - sc(PRE_CCIN) * dj1;
    const float out = bcast(dn, 8 + OUT);
    __syncwarp();  // every lane has read d
    if (lane < 16) w->d[lane] = dn;
    __syncwarp();
    pre_vnl[0] = vnl0[0];
    pre_vnl[1] = vnl0[1];
    pre_vnl[2] = vnl1[0];
    pre_vnl[3] = vnl1[1];
    pre_dic[0] = i0_sh - sc(PRE_IDC0);
    pre_dic[1] = di0;
    pre_dic[2] = i1_sh - sc(PRE_IDC1);
    pre_dic[3] = di1;
    pre_dj[0] = dj_sh;
    pre_dj[1] = dj_df;
    pre_dprev[0] = dj0;
    pre_dprev[1] = sc(PRE_GCIN) * u + dj1;
    pre_gldr = gldr;
    return out;
  }

  // i_abs row r16 at node voltages v (row r16 on this lane): transistor
  // r16 mod 8, its base current on lanes 0-7, its collector current on
  // lanes 8-15 (and their mirrors)
  __device__ float pa_current(float v) const {
    const int b = r16 & 7;
    float ib, ic;
    gp_currents(load_gp(T.A + A_PA_GP + b * N_GP), bcast(v, b),
                bcast(v, b + 8), ib, ic);
    return r16 < 8 ? ib : ic;
  }

  // Newton residual row r16: f = (v − vnl_dc) − p_dev − corr0 − K·di,
  // with di = i − i_dc already in w->di
  __device__ float pa_resid(float v, float p_dev) const {
    const float* nv = T.A + A_PA_NVCOLS;  // (16, 10)
    const float* di = w->di;
    float mv = T.kT[r16] * di[0];
#pragma unroll
    for (int k = 1; k < 16; ++k) mv = mv + T.kT[k * 16 + r16] * di[k];
    return (((v - nv[r16 * 10 + 5]) - p_dev) - nv[r16 * 10 + 3]) - mv;
  }

  // publish di = i_abs − i_dc for pa_resid / the output row sum
  __device__ void put_di(float i_abs) {
    __syncwarp();  // every lane has read the previous di
    if (lane < 16) w->di[lane] = i_abs - T.A[A_PA_NVCOLS + lane * 10 + 4];
    __syncwarp();
  }

  // ── power amp, one oversampled sample ──
  __device__ float pa_step(float x) {
    const float* A = T.A;
    const float* nv = A + A_PA_NVCOLS;
    const float* P = A + A_PA_P;
    const float* pcols = A + A_PA_COLS;
    const float rail_sag = w->ctrl[C_RAIL_SAG];
    const float off_p = (rails[0] - sc(PA_RAIL_BIAS)) * rail_sag;
    const float off_n = (rails[1] - sc(PA_RAIL_BIAS)) * rail_sag;
    // history rows: row lane on every lane, row 32 + lane on lanes 0-4
    const float* x37 = w->x37;
    const int row2 = 32 + (lane < 5 ? lane : 0);
    float acc1 = P[lane * 37] * x37[0], acc2 = P[row2 * 37] * x37[0];
#pragma unroll
    for (int k = 1; k < 37; ++k) {
      acc1 = acc1 + P[lane * 37 + k] * x37[k];
      acc2 = acc2 + P[row2 * 37 + k] * x37[k];
    }
    // rows 0-20: z_new on lanes 0-20; rows 21-36: p_dev[0-10] on lanes
    // 21-31, p_dev[11-15] on lanes 0-4 (second row)
    const int zr = lane < 21 ? lane : 0;
    const float z_new = ((acc1 + pcols[zr * 3] * x) + pcols[zr * 3 + 1] * off_p)
                        + pcols[zr * 3 + 2] * off_n;
    const int p1r = lane >= 21 ? lane - 21 : 0, p2r = row2 - 21;
    const float pd1 = ((acc1 + nv[p1r * 10] * x) + nv[p1r * 10 + 1] * off_p)
                      + nv[p1r * 10 + 2] * off_n;
    const float pd2 = ((acc2 + nv[p2r * 10] * x) + nv[p2r * 10 + 1] * off_p)
                      + nv[p2r * 10 + 2] * off_n;
    const float p_dev = bcast(lane >= 21 ? pd1 : pd2,
                              r16 <= 10 ? r16 + 21 : r16 - 11);

    const float vnl_old = vnl;
    const float wc = r16 < 8 ? 0.02f : 2.0f;
    const float wv = vnl_old + nclamp(vnl_old - vnl_prev, -wc, wc);
    const float ws = pnjlim(vnl_old, wv, nv[r16 * 10 + 8], nv[r16 * 10 + 9]);
    float v = ws;

    // elimination roles: lane gi + 10·gcg holds rows gi of columns
    // 4·gcg .. 4·gcg + 3 of [A | rhs] (column N_ACT is the rhs)
    int jport[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      jport[m] = pa_active(min(4 * gcg + m, N_ACT - 1));
    const int iport = pa_active(gi);
    const float* Ka = T.kaT;
    const float* Kr = T.krT;
    const int rr = rel_rr < 0 ? 0 : rel_rr;

    float fn0 = 0.0f;
    for (int it = 0; it < N_PA_ITERS; ++it) {
      const int b = r16 & 7;
      float ib, ic, gbb, gbc, gcb, gcc;
      gp_derivs(load_gp(A + A_PA_GP + b * N_GP), bcast(v, b), bcast(v, b + 8),
                ib, ic, gbb, gbc, gcb, gcc);
      __syncwarp();  // every lane has read the previous g
      if (lane < 8) {
        w->g[0][lane] = gbb;
        w->g[1][lane] = gbc;
        w->g[2][lane] = gcb;
        w->g[3][lane] = gcc;
      }
      put_di(r16 < 8 ? ib : ic);
      const float f = pa_resid(v, p_dev);
      const float fn = max16(fabsf(f));
      if (it == 0) fn0 = fn;

      // Reduced block system: active ports pivot, relegated ride along.
      float c[4];
      const float rhs_f = bcast(f, iport);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int jj = 4 * gcg + m, j = jport[m], jb = j % 8;
        const float g1 = j < 8 ? w->g[0][jb] : w->g[1][jb];
        const float g2 = j < 8 ? w->g[2][jb] : w->g[3][jb];
        const float a = (A[A_PA_EYE_ACT + gi * N_ACT + min(jj, N_ACT - 1)]
                         - Ka[jb * N_ACT + gi] * g1)
                        - Ka[(jb + 8) * N_ACT + gi] * g2;
        c[m] = jj < N_ACT ? a : (jj == N_ACT ? rhs_f : 0.0f);
      }
      float crel[N_ACT];
#pragma unroll
      for (int jj = 0; jj < N_ACT; ++jj) {
        const int j = pa_active(jj), jb = j % 8;
        const float g1 = j < 8 ? w->g[0][jb] : w->g[1][jb];
        const float g2 = j < 8 ? w->g[2][jb] : w->g[3][jb];
        crel[jj] = (-Kr[jb * N_REL + rr]) * g1 - Kr[(jb + 8) * N_REL + rr] * g2;
      }
      // elimination without pivoting, every row of the remaining columns
      float invs[N_ACT];
#pragma unroll
      for (int k = 0; k < N_ACT; ++k) {
        const int gk = k / 4, mk = k % 4;
        const float piv = bcast(c[mk], k + 10 * gk);
        const float colk = bcast(c[mk], gi + 10 * gk);
        float rk[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) rk[m] = bcast(c[m], (k + 10 * gcg) & 31);
        const float inv = 1.0f / (fabsf(piv) > 1e-30f ? piv : 1e-30f);
        invs[k] = inv;
        const float below = (gi > k ? colk : 0.0f) * inv;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (4 * gcg + m > k) c[m] = c[m] - below * rk[m];
      }
      // back-substitution on the rhs lanes (column N_ACT: group 2, slot 2)
      float ucol[N_ACT];
#pragma unroll
      for (int k = 1; k < N_ACT; ++k)
        ucol[k] = bcast(c[k % 4], gi + 10 * (k / 4));
      float rhs = c[2];
      float xa[N_ACT];
#pragma unroll
      for (int k = N_ACT - 1; k >= 0; --k) {
        const float xk = bcast(rhs, k + 20) * invs[k];
        xa[k] = xk;
        if (k) rhs = rhs - (gi < k ? ucol[k] : 0.0f) * xk;
      }
      float dv = f;  // relegated: f − C·x_act, in jj order
#pragma unroll
      for (int jj = 0; jj < N_ACT; ++jj) dv = dv - crel[jj] * xa[jj];
      if (rel_rr < 0) {
#pragma unroll
        for (int jj = 0; jj < N_ACT; ++jj)
          if (pa_active(jj) == r16) dv = xa[jj];
      }
      const float cl = nv[r16 * 10 + 7];
      float d = nclamp(dv, -cl, cl);
      d = fn < 1e-4f ? 0.0f : d;
      v = pnjlim(v, v - d, nv[r16 * 10 + 8], nv[r16 * 10 + 9]);
    }

    float i_abs = pa_current(v);
    put_di(i_abs);
    const float fn_final = max16(fabsf(pa_resid(v, p_dev)));
    // Explosion reset: keep the warm start when NR ended farther away.
    const bool exploded = fn_final > nmax(4.0f * fn0, 1.0f);
    if (exploded) {
      v = ws;
      i_abs = pa_current(ws);
    }
    const float di_new = i_abs - nv[r16 * 10 + 4];
    put_di(i_abs);
    float rs = nv[0 * 10 + 6] * w->di[0];
#pragma unroll
    for (int k = 1; k < 16; ++k) rs = rs + nv[k * 10 + 6] * w->di[k];
    const int oi = (int)sc(PA_OUT_IDX);
    const float raw = sc(PA_VDC_OUT) + (bcast(z_new, oi) + rs);
    const float result = raw * sc(PA_INV_HEADROOM);

    // Divergence guard: hold on NR failure, reset + hold when insane.
    const bool nr_failed = fn_final > 0.5f || exploded;
    float zmax = lane < 21 ? fabsf(z_new) : 0.0f;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      zmax = nmax(zmax, __shfl_xor_sync(FULL, zmax, o));
    const bool reset = zmax > 100.0f || !isfinite(result);
    const bool bad = reset || nr_failed;
    __syncwarp();  // every lane has read x37 and di
    if (lane < 21) w->x37[lane] = reset ? 0.0f : z_new;
    if (lane < 16) w->x37[21 + lane] = reset ? 0.0f : di_new;
    __syncwarp();
    vnl = reset ? nv[r16 * 10 + 5] : v;
    vnl_prev = reset ? nv[r16 * 10 + 5] : vnl_old;
    const float out = bad ? lastgood : nclamp(result, -1.0f, 1.0f);
    lastgood = out;

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
#pragma unroll
    for (int k = 0; k < 4; ++k)
      rails[k] = sag_on ? (bad ? init_rails[k] : new_rails[k]) : rails[k];
    return out;
  }

  __device__ float allpass(int coeff0, float (&s)[3], float x) {
    float y = x;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float a = sc(coeff0 + i);
      const float o = a * y + s[i];
      s[i] = y - a * o;
      y = o;
    }
    return y;
  }

  __device__ float bq(int rows, float (&s)[2], float xin) {
    const float* ctrl = w->ctrl;
    const float b0 = ctrl[rows], b1 = ctrl[rows + 1], b2 = ctrl[rows + 2];
    const float a1 = ctrl[rows + 3], a2 = ctrl[rows + 4];
    const float y = b0 * xin + s[0];
    const float z1 = (b1 * xin - a1 * y) + s[1];
    const float z2 = b2 * xin - a2 * y;
    s[0] = z1;
    s[1] = z2;
    return y;
  }

  // ── one base-rate sample ──
  template <bool NOISE>
  __device__ float base_step(float x) {
    const float e = allpass(OS_A0, os_ua, x);
    const float o = allpass(OS_B0, os_ub, x);
    const float g_cur = tr.v[T_GLDR_CUR], g_prev = tr.v[T_GLDR_UPD_PREV];
    const float ph = tr.v[T_PHASE];
    float ys[2];
#pragma unroll
    for (int t_os = 0; t_os < 2; ++t_os) {
      const float frac = (ph + (float)(t_os + 1)) * 0.25f;
      const float gldr = g_prev + frac * (g_cur - g_prev);
      const float pre_out = preamp_step<NOISE>(t_os ? o : e, gldr);
      ys[t_os] = pa_step(pre_out * sc(DRIVE));
    }
    tr.v[T_PHASE] = ph + 2.0f;
    const float a = allpass(OS_A0, os_da, ys[0]);
    const float b = allpass(OS_B0, os_db, ys[1]);
    const float amp_out = (a + os_delay) * 0.5f;
    os_delay = b;

    const float* ctrl = w->ctrl;
    const float a2 = ctrl[C_A2], a3 = ctrl[C_A3];
    const float x2 = amp_out * amp_out;
    const float shaped = ((amp_out + a2 * x2) + (a3 * x2) * amp_out)
                         / ((1.0f + a2) + a3);
    const float limited = ctrl[C_CHAR] < 0.001f ? shaped : tanhf(shaped);
    const float thermal =
        spk_thermal + (x2 - spk_thermal) * sc(SPK_THERMAL_ALPHA);
    const float tgain = 1.0f / (1.0f + ctrl[C_THERMAL] * sqrtf(thermal));
    spk_thermal = thermal;
    const float filt = bq(C_HPF, spk_hpf, limited * tgain);
    const float spk_out = bq(C_LPF, spk_lpf, filt);
    const float out = (spk_out * sc(POST_GAIN)) * ctrl[C_VOLUME];

    // Final NaN guard: reset the chain, output silence. `out` is the same
    // on every lane, so the whole warp takes this branch or none does.
    if (!isfinite(out)) {
      const float* nv = T.A + A_PA_NVCOLS;
      __syncwarp();
      if (lane < 16) w->d[lane] = 0.0f;
      for (int k = lane; k < 37; k += 32) w->x37[k] = 0.0f;  // pa_z, pa_di
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 4; ++k) pre_dic[k] = 0.0f;
      pre_dj[0] = pre_dj[1] = pre_dprev[0] = pre_dprev[1] = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        os_ua[k] = os_ub[k] = os_da[k] = os_db[k] = 0.0f;
      os_delay = 0.0f;
      spk_hpf[0] = spk_hpf[1] = spk_lpf[0] = spk_lpf[1] = 0.0f;
      spk_thermal = 0.0f;
      lastgood = 0.0f;
      pre_vnl[0] = pre_vnl[1] = sc(PRE_VNL_DC0);
      pre_vnl[2] = pre_vnl[3] = sc(PRE_VNL_DC1);
      vnl = vnl_prev = nv[r16 * 10 + 5];
      guard = guard + 1.0f;
      return 0.0f;
    }
    guard = guard + 0.0f;  // −0 → +0, as the plain version's add of 0
    return out;
  }
};

template <bool NOISE>
__global__ void __launch_bounds__(kWarps * 32)
mono_chain_kernel(const float* __restrict__ consts,
                  const float* __restrict__ scalars,
                  const float* __restrict__ controls,
                  const float* __restrict__ state_in,
                  const float* __restrict__ audio, float* __restrict__ out,
                  float* __restrict__ state_out, int streams, int t_len) {
  __shared__ float s_consts[A_TOTAL];
  __shared__ float s_scalars[N_SCALARS];
  __shared__ float s_saT[16 * 20], s_kT[16 * 16], s_kaT[16 * N_ACT],
      s_krT[16 * N_REL];
  __shared__ Scratch s_warp[kWarps];
  for (int i = threadIdx.x; i < A_TOTAL; i += blockDim.x)
    s_consts[i] = consts[i];
  for (int i = threadIdx.x; i < N_SCALARS; i += blockDim.x)
    s_scalars[i] = scalars[i];
  for (int i = threadIdx.x; i < 16 * 20; i += blockDim.x) {
    const int k = i / 20, r = i % 20;
    s_saT[i] = r < 16 ? consts[A_PRE_SA + r * 16 + k]
                      : consts[A_PRE_SA_P + (r - 16) * 16 + k];
  }
  for (int i = threadIdx.x; i < 16 * 16; i += blockDim.x)
    s_kT[i] = consts[A_PA_K + (i % 16) * 16 + i / 16];
  for (int i = threadIdx.x; i < 16 * N_ACT; i += blockDim.x)
    s_kaT[i] = consts[A_PA_K_ACT + (i % N_ACT) * 16 + i / N_ACT];
  for (int i = threadIdx.x; i < 16 * N_REL; i += blockDim.x)
    s_krT[i] = consts[A_PA_K_REL + (i % N_REL) * 16 + i / N_REL];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= streams) return;  // the whole warp: no warp-level sync follows
  const auto in = [&](int row) { return state_in[(size_t)row * streams + s]; };

  Chain ch;
  ch.T = {s_consts, s_scalars, s_saT, s_kT, s_kaT, s_krT};
  ch.w = &s_warp[warp];
  ch.lane = lane;
  ch.r16 = lane & 15;
  ch.gi = lane < 30 ? lane % 10 : lane - 30;
  ch.gcg = lane < 30 ? lane / 10 : 3;
  ch.rel_rr = -1;
#pragma unroll
  for (int rr = 0; rr < N_REL; ++rr)
    if (pa_releg(rr) == ch.r16) ch.rel_rr = rr;

  // rows this kernel does not write (padding, and K2's nz_ rows) pass
  // through: copy the whole column, then overwrite the written rows
  for (int r = lane; r < STATE_ROWS; r += 32)
    state_out[(size_t)r * streams + s] = in(r);
  if (lane < CTRL_ROWS) ch.w->ctrl[lane] = controls[lane * streams + s];
  if (lane < 16) ch.w->d[lane] = in(ST_PRE_D + lane);
  for (int k = lane; k < 37; k += 32)
    ch.w->x37[k] = in(k < 21 ? ST_PA_Z + k : ST_PA_DI + (k - 21));
#pragma unroll
  for (int k = 0; k < PREROLL_ROWS; ++k) ch.tr.v[k] = in(trem_row(k));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ch.pre_vnl[k] = in(ST_PRE_VNL + k);
    ch.pre_dic[k] = in(ST_PRE_DIC + k);
    ch.rails[k] = in(ST_PA_RAILS + k);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    ch.pre_dj[k] = in(ST_PRE_DJ + k);
    ch.pre_dprev[k] = in(ST_PRE_DPREV + k);
    ch.spk_hpf[k] = in(ST_SPK_HPF + k);
    ch.spk_lpf[k] = in(ST_SPK_LPF + k);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ch.os_ua[k] = in(ST_OS_UA + k);
    ch.os_ub[k] = in(ST_OS_UB + k);
    ch.os_da[k] = in(ST_OS_DA + k);
    ch.os_db[k] = in(ST_OS_DB + k);
  }
  ch.pre_gldr = in(ST_PRE_GLDR);
  ch.lastgood = in(ST_PA_LASTGOOD);
  ch.os_delay = in(ST_OS_DELAY);
  ch.spk_thermal = in(ST_SPK_THERMAL);
  ch.guard = in(ST_GUARD_FIRES);
  ch.vnl = in(ST_PA_VNL + ch.r16);
  ch.vnl_prev = in(ST_PA_VNL_PREV + ch.r16);
  ch.lcg_a = ch.lcg_b = 0u;
  ch.nz_w = 0.0f;
  if constexpr (NOISE) {
    ch.lcg_a = __float_as_uint(in(ST_NZ_LCG + lane));
    ch.lcg_b = __float_as_uint(in(ST_NZ_LCG + 32 + (lane & 7)));
    ch.nz_w = in(ST_NZ_W + (lane >= 1 && lane <= 9 ? lane - 1 : 0));
  }
  __syncwarp();

  const float r_low = ch.w->ctrl[C_R_LOWER], div_top = ch.w->ctrl[C_DIV_TOP];
  for (int i = 0; i < t_len; ++i) {
    if (i % 2 == 0)  // SUB_BASE = 2, before base_step
      trem_update(s_consts, s_scalars, r_low, div_top, ch.tr);
    const float y = ch.base_step<NOISE>(audio[(size_t)i * streams + s]);
    if (lane == 0) out[(size_t)i * streams + s] = y;
  }

  __syncwarp();  // the pass-through copy is done before the rows it covers
  const auto put = [&](int row, float v) {
    state_out[(size_t)row * streams + s] = v;
  };
  if (lane < 16) {
    put(ST_PRE_D + lane, ch.w->d[lane]);
    put(ST_PA_VNL + lane, ch.vnl);
    put(ST_PA_VNL_PREV + lane, ch.vnl_prev);
  }
  for (int k = lane; k < 37; k += 32)
    put(k < 21 ? ST_PA_Z + k : ST_PA_DI + (k - 21), ch.w->x37[k]);
  if constexpr (NOISE) {
    put(ST_NZ_LCG + lane, __uint_as_float(ch.lcg_a));
    if (lane < 8) put(ST_NZ_LCG + 32 + lane, __uint_as_float(ch.lcg_b));
    if (lane >= 1 && lane <= 9) put(ST_NZ_W + lane - 1, ch.nz_w);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < PREROLL_ROWS; ++k) put(trem_row(k), ch.tr.v[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      put(ST_PRE_VNL + k, ch.pre_vnl[k]);
      put(ST_PRE_DIC + k, ch.pre_dic[k]);
      put(ST_PA_RAILS + k, ch.rails[k]);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      put(ST_PRE_DJ + k, ch.pre_dj[k]);
      put(ST_PRE_DPREV + k, ch.pre_dprev[k]);
      put(ST_SPK_HPF + k, ch.spk_hpf[k]);
      put(ST_SPK_LPF + k, ch.spk_lpf[k]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      put(ST_OS_UA + k, ch.os_ua[k]);
      put(ST_OS_UB + k, ch.os_ub[k]);
      put(ST_OS_DA + k, ch.os_da[k]);
      put(ST_OS_DB + k, ch.os_db[k]);
    }
    put(ST_PRE_GLDR, ch.pre_gldr);
    put(ST_PA_LASTGOOD, ch.lastgood);
    put(ST_OS_DELAY, ch.os_delay);
    put(ST_SPK_THERMAL, ch.spk_thermal);
    put(ST_GUARD_FIRES, ch.guard);
  }
}

// pnjlim on a warp: the limited value (a division and a log1p) is
// computed only when the row of some lane takes it. The same value as
// pnjlim's; the tremolo's rows rarely take it, and in K4 it was the
// longest step of each Newton iteration.
__device__ __forceinline__ float pnjlim_warp(float v_old, float v_new,
                                             float nvt, float vcrit) {
  const float delta = v_new - v_old;
  const bool take = v_new > vcrit && delta > 2.0f * nvt;
  if (!__any_sync(FULL, take)) return v_new;
  const float lim = v_old + nvt * log1pf(nmax(delta, 0.0f) / nvt);
  return take ? nmax(lim, nmin(v_new, vcrit)) : v_new;
}

// K4's update on one warp: trem_update's values, each computed by the
// lanes named here with trem_update's operations in its order; the other
// lanes get it by a shuffle. Lane l owns
//  * row r = l & 3 of the Newton unknowns vnl: its residual row, its clamp
//    and pnjlim (lane l ^ 2 holds the row that completes its transistor);
//  * transistor b = l & 1 (vbe = vnl[b], vbc = vnl[2 + b]): gp_derivs in
//    each Newton iteration and the final gp_currents;
//  * Jacobian element (i, j) = (l >> 2 & 3, l & 3) on lanes 0-15: column
//    j's transistor j % 2 is the lane's own;
//  * row l % 11 of the history matvec P·[z; di].
// The 4×4 elimination, rs, v_out and the envelope run on every lane from
// the same broadcast inputs, so every lane holds the same bits of them.
// Each lane keeps the constants of its rows in registers.
struct TremWarp {
  int r, b;
  Gp gp;
  float prow[11];             // row l % 11 of trem_P
  float km_r[4];              // row r of trem_K
  float corr0, vnl_dc, nvt, vcrit;  // trem_cols row r: columns 0, 2, 7, 8
  float i_dc[4], sni[4];      // trem_cols columns 1 and 3
  float eye, ka, kb;          // the Jacobian element's eye4 and trem_K
  // state
  float x[11];                // [z; di], every lane
  float v;                    // vnl row r
  float env;

  __device__ void load(const float* A, int lane) {
    const float* cols = A + A_TREM_COLS;  // (7, 9)
    const float* Km = A + A_TREM_K;       // (4, 4)
    r = lane & 3;
    b = lane & 1;
    gp = load_gp(A + A_TREM_GP + b * N_GP);
    const int h = lane % 11;
#pragma unroll
    for (int k = 0; k < 11; ++k) prow[k] = A[A_TREM_P + h * 11 + k];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      km_r[k] = Km[r * 4 + k];
      i_dc[k] = cols[k * 9 + 1];
      sni[k] = cols[k * 9 + 3];
    }
    corr0 = cols[r * 9];
    vnl_dc = cols[r * 9 + 2];
    nvt = cols[r * 9 + 7];
    vcrit = cols[r * 9 + 8];
    const int i = (lane >> 2) & 3, j = lane & 3;
    eye = A[A_EYE4 + i * 4 + j];
    ka = Km[i * 4 + b];
    kb = Km[i * 4 + b + 2];
  }

  // [ib[0], ib[1], ic[0], ic[1]] − i_dc from this lane's transistor and
  // its partner's (lane ^ 1)
  __device__ void currents_dc(float ib, float ic, float (&di)[4]) const {
    const float ib_o = __shfl_xor_sync(FULL, ib, 1);
    const float ic_o = __shfl_xor_sync(FULL, ic, 1);
    const float i_abs[4] = {b ? ib_o : ib, b ? ib : ib_o, b ? ic_o : ic,
                            b ? ic : ic_o};
#pragma unroll
    for (int k = 0; k < 4; ++k) di[k] = i_abs[k] - i_dc[k];
  }

  // one update of z, di, vnl and env (the LDR tail is the caller's)
  __device__ void update(const float* K, int oi) {
    float acc = prow[0] * x[0];
#pragma unroll
    for (int k = 1; k < 11; ++k) acc = acc + prow[k] * x[k];
    const float p_dev = __shfl_sync(FULL, acc, 7 + r);
    const float big_oi = __shfl_sync(FULL, acc, oi);
    float z[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) z[k] = __shfl_sync(FULL, acc, k);
    const bool jlow = r < 2;  // the Jacobian element's column j = r
#pragma unroll
    for (int it = 0; it < N_TREM_ITERS; ++it) {
      const float vo = __shfl_xor_sync(FULL, v, 2);
      float ib, ic, gbb, gbc, gcb, gcc;
      gp_derivs(gp, r < 2 ? v : vo, r < 2 ? vo : v, ib, ic, gbb, gbc, gcb,
                gcc);
      float di[4];
      currents_dc(ib, ic, di);
      float mv = km_r[0] * di[0];
#pragma unroll
      for (int k = 1; k < 4; ++k) mv = mv + km_r[k] * di[k];
      const float f = (((v - vnl_dc) - p_dev) - corr0) - mv;
      const float jel = (eye - ka * (jlow ? gbb : gbc))
                        - kb * (jlow ? gcb : gcc);
      float blk[5][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          blk[j][i] = __shfl_sync(FULL, jel, j + 4 * i);
#pragma unroll
      for (int i = 0; i < 4; ++i) blk[4][i] = __shfl_sync(FULL, f, i);
      float dv[4];
      ge_solve<4>(blk, dv);
      const float dvr = r == 0 ? dv[0] : r == 1 ? dv[1] : r == 2 ? dv[2]
                                                                 : dv[3];
      const float d = nclamp(dvr, -0.5f, 0.5f);
      v = pnjlim_warp(v, v - d, nvt, vcrit);
    }
    const float vo = __shfl_xor_sync(FULL, v, 2);
    float ib, ic;
    gp_currents(gp, r < 2 ? v : vo, r < 2 ? vo : v, ib, ic);
    float di_new[4];
    currents_dc(ib, ic, di_new);
    float rs = sni[0] * di_new[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) rs = rs + sni[k] * di_new[k];
    const float v_out = (K[TREM_VDC_OUT] + big_oi) + rs;
    env = trem_env(K, v_out, env);
#pragma unroll
    for (int k = 0; k < 7; ++k) x[k] = z[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[7 + k] = di_new[k];
  }
};

// K4: one warp walks n_captures intervals of steps_per_capture tremolo
// updates; caps[k] is the state entering interval k (before its first
// update), in kPrerollSpans order. The LDR tail runs only in an interval's
// last two updates: the capture after it reads gldr_cur and gldr_upd_prev,
// and nothing else reads them (with one update per interval,
// gldr_upd_prev is the previous interval's last gldr).
__global__ void __launch_bounds__(32)
trem_preroll_kernel(const float* __restrict__ consts,
                    const float* __restrict__ scalars,
                    const float* __restrict__ controls,
                    const float* __restrict__ state_in,
                    float* __restrict__ caps, int n_captures,
                    int steps_per_capture) {
  __shared__ float s_scalars[N_SCALARS];
  const int lane = threadIdx.x;
  for (int i = lane; i < N_SCALARS; i += 32) s_scalars[i] = scalars[i];
  __syncwarp();
  const float* K = s_scalars;
  // trem_update's big[oi]: row oi for oi in 1..10, else row 0
  const int oi_raw = (int)K[TREM_OUT_IDX];
  const int oi = oi_raw >= 1 && oi_raw <= 10 ? oi_raw : 0;

  TremWarp tw;
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
  const int n = steps_per_capture;
  for (int k = 0; k < n_captures; ++k) {
    float vnl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) vnl[q] = __shfl_sync(FULL, tw.v, q);
    if (lane == 0) {
      float* cap = caps + k * PREROLL_ROWS;
#pragma unroll
      for (int q = 0; q < 11; ++q) cap[T_Z + q] = tw.x[q];  // z, then di
#pragma unroll
      for (int q = 0; q < 4; ++q) cap[T_VNL + q] = vnl[q];
      cap[T_ENV] = tw.env;
      cap[T_GLDR_CUR] = g_cur;
      cap[T_GLDR_UPD_PREV] = g_prev;
      cap[T_PHASE] = phase;
    }
    // the updates after the last capture would reach no output
    if (k + 1 == n_captures) break;
    for (int i = 0; i < n; ++i) {
      tw.update(K, oi);
      if (i >= n - 2) {
        g_prev = g_cur;
        g_cur = trem_gldr(K, tw.env, r_low, div_top);
      }
    }
    phase = 0.0f;
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
  trem_preroll_kernel<<<1, 32, 0, stream>>>(consts, scalars, controls,
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
  const int blocks = (streams + kWarps - 1) / kWarps;
  mono_chain_kernel<NOISE><<<blocks, kWarps * 32, 0, stream>>>(
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
