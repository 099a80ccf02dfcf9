// The f64 engine's kernels (openwurli_tpu_torch/kernels/engine.py):
//
//   E1 engine_voices   the 64 main + 64 steal voice slots over one chunk
//   E2 engine_chain    the mono chain over that chunk
//   E3 tremolo_settle  the tremolo oscillator's step, n times
//
// Replaces: the reference's jitted lax.scan of its float64 engine
// (openwurli_tpu/engine.py:452 `_render`) and of its tremolo settle
// (openwurli_tpu/circuits/tremolo.py:160); neither is a Pallas kernel.
//
// Bound: latency. A chunk is a serial recurrence: E1 advances each voice
// slot by one thread (a block of 128), E2 and E3 are one thread walking
// the chain's data-dependent Newton solves sample by sample. The bytes are
// a few hundred per sample and the operations some 10^4-10^5 f64 per base
// sample, far from the card's rates; what bounds the time is the length of
// the dependent chain of f64 operations and libm calls per sample. The
// design takes two exact savings: each Newton loop ends once every row has
// converged (the masked iterations of the reference change nothing), and
// E2 reuses the speaker's coefficients while the character is unchanged.
//
// Every kernel equals its plain torch version bit for bit: compiled with
// -fmad=false, sums in the plain version's index order, every max/min/clip
// a select that keeps NaN (jmax/jmin below, exact.maximum in the plain
// version), and the f32 Newton elimination with each update rounded once
// from double (mna.ge_solve_numpy).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAXV = 64;
constexpr int SLOTS = 128;
constexpr int NM = 7;
constexpr int TILE = 32;  // samples per shared-memory output tile in E1

// voice layouts (kernels/engine.py), rows × SLOTS
enum VPar {
  P_COS = 0, P_SIN = 7, P_PHASE = 14, P_AMP = 21, P_DECAY = 28,
  P_RAMP_N = 35, P_RAMP_INC = 36, P_SHAPE = 37, P_REVERT = 38, P_DIFF = 39,
  P_NDECAY = 40, P_BPF = 41, P_BETA = 46, P_DS = 47, P_GAIN = 48,
  P_MIDI = 49, NPAR = 50
};
enum VSt {
  S_S = 0, S_C = 7, S_ENV = 14, S_DRIFT = 21, S_DRATE = 28, S_DMULT = 35,
  S_DRAMP = 42, S_DCOUNT = 43, S_NAMP = 44, S_Z1 = 45, S_Z2 = 46, S_Q = 47,
  NST = 48
};
enum VStI { I_JST = 0, I_N = 1, I_DACT = 2, I_DDONE = 3, I_NREM = 4,
            I_NFADE = 5, I_NRNG = 6, NSTI = 7 };
enum EngI { EI_FIRES = 128, ENG_I = 129 };

// chain state layout (kernels/engine.py CHAIN_SPEC)
enum ChainOffset {
  CH_OS_UP_A = 0, CH_OS_UP_B = 3, CH_OS_DOWN_A = 6, CH_OS_DOWN_B = 9,
  CH_OS_DELAY = 12, CH_TREM_V = 13, CH_TREM_I = 20, CH_TREM_VNL = 24,
  CH_TREM_RESID = 28, CH_TREM_DIAG = 29, CH_TREM_ENV = 34, CH_TREM_RLDR = 35,
  CH_PRE_V = 36, CH_PRE_I = 52, CH_PRE_VNL = 56, CH_PRE_JCIN = 60,
  CH_PRE_CINPREV = 62, CH_PRE_GPREV = 64, CH_PA_V = 65, CH_PA_I = 86,
  CH_PA_VNL = 102, CH_PA_RESID = 118, CH_PA_DIAG = 119, CH_PA_RAILS = 124,
  CH_PA_LAST = 128, CH_SPK = 129, CH_SM_VOLUME = 134, CH_SM_DEPTH = 138,
  CH_SM_CHAR = 142, CHAIN_ROWS = 146
};

// chain constants (kernels/engine.py chain_params): block offsets, then
// the preamp block and the misc scalars
enum ConstOffset {
  C_TREM = 0, C_PA = 440, C_PRE = 4420, C_MISC = 4607, C_TOTAL = 4623
};
enum PreOffset {
  PR_A_NEG = 0, PR_S_BASE = 64, PR_TWO_W = 128, PR_K = 136, PR_K_OUTER = 140,
  PR_S_FB_COL = 144, PR_NI_COL0 = 152, PR_NI_COL1 = 160, PR_SFB_NI = 168,
  PR_V_DC = 170, PR_V_NL_DC = 178, PR_I_NL_DC = 180, PR_S_FB_FB = 182,
  PR_G_CIN = 183, PR_C_CIN = 184, PR_GC_1PC = 185, PR_J_CIN_DC = 186
};
enum Misc {
  M_TREM_OUT = 0, M_TREM_ATT, M_TREM_REL, M_PA_OUT, M_PA_V1, M_PA_V2,
  M_PA_IN, M_PA_ATT, M_PA_REL, M_PA_IAVG, M_SPK_SR, M_SPK_ALPHA,
  M_OVERSAMPLE, M_POST_GAIN, M_LN_RMAX, M_LN_SPAN, N_MISC
};

constexpr double EXC = 0x1.a220d397972eap+57;  // float(np.exp(40.0))
constexpr double XC = 40.0;

// ── selects that keep NaN, as the reference's jnp.maximum/minimum ──

__device__ __forceinline__ double jmax(double a, double b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ double jmin(double a, double b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ double jclip(double x, double lo, double hi) {
  return jmin(jmax(x, lo), hi);
}
__device__ __forceinline__ bool finite(double x) { return isfinite(x); }

// max |x| over n, NaN if any entry is NaN (torch.amax)
__device__ __forceinline__ double max_abs(const double* x, int n) {
  double m = fabs(x[0]);
  for (int i = 1; i < n; ++i) {
    double a = fabs(x[i]);
    if (a != a || a > m) m = a;
  }
  return m;
}

// a (rows × cols, row-major) @ x, columns summed in index order
__device__ __forceinline__ void matvec(const double* a, const double* x,
                                       double* y, int rows, int cols) {
  for (int r = 0; r < rows; ++r) {
    const double* ar = a + r * cols;
    double acc = ar[0] * x[0];
    for (int c = 1; c < cols; ++c) acc = acc + ar[c] * x[c];
    y[r] = acc;
  }
}

// ═════════════════════════════ E1: voices ═════════════════════════════

__device__ __forceinline__ long long lcg(long long s) {
  return (s * 1664525LL + 1013904223LL) & 0xFFFFFFFFLL;
}

__global__ void __launch_bounds__(SLOTS, 1)
engine_voices_kernel(const double* __restrict__ vpar, double* vst,
                     long long* vsti, long long* eng_i, double* mono, int n,
                     double fade_len, double sample_rate) {
  __shared__ double tile[TILE][SLOTS];
  __shared__ int bad_tile[TILE];
  __shared__ unsigned long long fires;
  const int j = threadIdx.x;
  const bool main_slot = j < MAXV;
#define PAR(r) vpar[(r) * SLOTS + j]
#define ST(r) vst[(r) * SLOTS + j]
#define STI(r) vsti[(r) * SLOTS + j]
  double cos_inc[NM], sin_inc[NM], phase_inc[NM], amp[NM], decay[NM];
  double s[NM], c[NM], env[NM], drift[NM], drate[NM], dmult[NM];
  for (int k = 0; k < NM; ++k) {
    cos_inc[k] = PAR(P_COS + k);
    sin_inc[k] = PAR(P_SIN + k);
    phase_inc[k] = PAR(P_PHASE + k);
    amp[k] = PAR(P_AMP + k);
    decay[k] = PAR(P_DECAY + k);
    s[k] = ST(S_S + k);
    c[k] = ST(S_C + k);
    env[k] = ST(S_ENV + k);
    drift[k] = ST(S_DRIFT + k);
    drate[k] = ST(S_DRATE + k);
    dmult[k] = ST(S_DMULT + k);
  }
  const double ramp_n = PAR(P_RAMP_N), ramp_inc = PAR(P_RAMP_INC);
  const double shape = PAR(P_SHAPE), revert = PAR(P_REVERT);
  const double diffusion = PAR(P_DIFF), ndecay = PAR(P_NDECAY);
  const double b0 = PAR(P_BPF), b1 = PAR(P_BPF + 1), b2 = PAR(P_BPF + 2);
  const double a1 = PAR(P_BPF + 3), a2 = PAR(P_BPF + 4);
  const double beta = PAR(P_BETA), ds = PAR(P_DS), gain = PAR(P_GAIN);
  double dramp = ST(S_DRAMP), dcount = ST(S_DCOUNT), namp = ST(S_NAMP);
  double z1 = ST(S_Z1), z2 = ST(S_Z2), q = ST(S_Q);
  long long jst = STI(I_JST), nn = STI(I_N), nrem = STI(I_NREM);
  long long nfade = STI(I_NFADE), nrng = STI(I_NRNG);
  bool dact = STI(I_DACT) != 0, ddone = STI(I_DDONE) != 0;
  long long gate = eng_i[j];  // slot state (main) or steal fade (steal)
  if (j == 0) fires = 0;

  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int tn = min(TILE, n - t0);
    if (j < TILE) bad_tile[j] = 0;
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      // ── reed.step: damper → onset → jitter → output/rotation → renorm
      const double rel = dact ? dcount + 1.0 : dcount;
      const bool past = rel > dramp;
      const bool in_ramp = dact && !ddone && !past;
      const bool done2 = ddone || (dact && past);
      const double ratio = rel / jmax(dramp, 1e-30);
      for (int k = 0; k < NM; ++k) {
        const double inst = drate[k] * ratio;
        env[k] = env[k] * (in_ramp ? exp(-inst) : 1.0);
        env[k] = env[k] * ((dact && done2) ? dmult[k] : 1.0);
      }
      const double cosine = 0.5 * (1.0 - cos((double)nn * ramp_inc));
      double shaped;
      if (shape <= 1.001) shaped = cosine;
      else if (shape >= 1.999) shaped = cosine * cosine;
      else shaped = pow(jmax(cosine, 0.0), shape);
      const double onset = ((double)nn < ramp_n) ? shaped : 1.0;
      if ((nn & 15) == 0) {
        long long js = jst;
        for (int k = 0; k < NM; ++k) {
          js = lcg(js);
          const double u = (double)(js >> 1) / 2147483647.5;
          const double nz = (u * 2.0 - 1.0) * 1.7320508080;
          drift[k] = revert * drift[k] + diffusion * nz;
        }
        jst = js;
      }
      double reed_out = 0.0;
      for (int k = 0; k < NM; ++k) {
        const double term = amp[k] * s[k] * onset * env[k];
        reed_out = (k == 0) ? term : reed_out + term;
      }
      const bool renorm = ((nn & 1023) == 0) && nn > 0;
      for (int k = 0; k < NM; ++k) {
        const double dp = drift[k] * phase_inc[k];
        const double ci = cos_inc[k] - dp * sin_inc[k];
        const double si = sin_inc[k] + dp * cos_inc[k];
        const double s_new = s[k] * ci + c[k] * si;
        const double c_new = c[k] * ci - s[k] * si;
        env[k] = env[k] * decay[k];
        const double scale =
            renorm ? 1.0 / sqrt(s_new * s_new + c_new * c_new) : 1.0;
        s[k] = s_new * scale;
        c[k] = c_new * scale;
      }
      nn += 1;
      dcount = rel;
      ddone = done2;

      // ── hammer.noise_step
      const bool active = nrem > 0;
      const bool in_fade = nfade > 0;
      const double tf = (double)(16 - nfade) / 16.0;
      const double nenv = in_fade ? 0.5 * (1.0 - cos(M_PI * tf)) : 1.0;
      const long long r = lcg(nrng);
      const double noise =
          (double)(r >= 2147483648LL ? r - 4294967296LL : r) / 2147483647.0;
      const double y = b0 * noise + z1;
      const double nz1 = b1 * noise - a1 * y + z2;
      const double nz2 = b2 * noise - a2 * y;
      const double noise_out = active ? namp * nenv * y : 0.0;
      if (active) {
        namp = namp * ndecay;
        nrem = nrem - 1;
        if (in_fade) nfade = nfade - 1;
        z1 = nz1;
        z2 = nz2;
        nrng = r;
      }

      // ── pickup.step
      const double yy = (reed_out + noise_out) * ds;
      const double ay = fabs(yy);
      const double rng = 0.98 - 0.94;
      double ys = yy;
      if (!(ay < 0.94)) {
        const double sat = 0.94 + rng * tanh((ay - 0.94) / rng);
        ys = yy >= 0.0 ? sat : -sat;
      }
      const double omy = 1.0 - ys;
      const double alpha = beta * omy;
      q = (q * (1.0 - alpha) + 2.0 * beta) / (1.0 + alpha);
      const double out = (q * omy - 1.0) * 1.8375 * gain;

      // ── gates and NaN guard #1
      double g;
      bool bad;
      if (main_slot) {
        const double v = gate != 0 ? out : 0.0;
        bad = !finite(v);
        g = bad ? 0.0 : v;
        if (bad) gate = 0;
      } else {
        const double gn = (double)gate / fade_len;
        const double sv = gate > 0 ? out * gn : 0.0;
        gate = gate - 1 > 0 ? gate - 1 : 0;
        bad = !finite(sv);
        g = bad ? 0.0 : sv;
        if (bad) gate = 0;
      }
      tile[tt][j] = g;
      if (bad) atomicOr(&bad_tile[tt], 1);
    }
    __syncthreads();
    if (j < tn) {
      double m = tile[j][0], st = tile[j][MAXV];
      for (int k = 1; k < MAXV; ++k) {
        m = m + tile[j][k];
        st = st + tile[j][MAXV + k];
      }
      mono[t0 + j] = m + st;
      if (bad_tile[j]) atomicAdd(&fires, 1ULL);
    }
    __syncthreads();
  }

  // chunk-end cleanup: a silent main voice goes FREE
  if (main_slot && gate != 0) {
    const double rel_s = dact ? dcount / sample_rate : 0.0;
    bool silent = dact && rel_s > 10.0;
    bool quiet = true;
    for (int k = 0; k < NM; ++k) quiet = quiet && fabs(amp[k] * env[k]) <= 1e-4;
    if (silent || quiet) gate = 0;
  }
  for (int k = 0; k < NM; ++k) {
    ST(S_S + k) = s[k];
    ST(S_C + k) = c[k];
    ST(S_ENV + k) = env[k];
    ST(S_DRIFT + k) = drift[k];
  }
  ST(S_DCOUNT) = dcount;
  ST(S_NAMP) = namp;
  ST(S_Z1) = z1;
  ST(S_Z2) = z2;
  ST(S_Q) = q;
  STI(I_JST) = jst;
  STI(I_N) = nn;
  STI(I_DDONE) = ddone ? 1 : 0;
  STI(I_NREM) = nrem;
  STI(I_NFADE) = nfade;
  STI(I_NRNG) = nrng;
  eng_i[j] = gate;
  __syncthreads();
  if (j == 0) eng_i[EI_FIRES] += (long long)fires;
#undef PAR
#undef ST
#undef STI
}

// ═══════════════════════ the generic mna step ═══════════════════════

// solver constants of one netlist (kernels/engine.py solver_block)
template <int N, int M, int NB>
struct SL {
  static constexpr int TRAP_I = 0, N_NODES = 1, TRAP_PRIMARY = 2;
  static constexpr int S = 4, AH = S + N * N, NV = AH + N * N,
                       NI = NV + M * N, SNI = NI + N * M, K = SNI + N * M,
                       W = K + M * M, WS = W + N, VDC = WS + N, IDC = VDC + N,
                       VNLDC = IDC + M, SBE = VNLDC + M, AHBE = SBE + N * N,
                       SNIBE = AHBE + N * N, KBE = SNIBE + N * M,
                       WSBE = KBE + M * M, NVT = WSBE + N, VCRIT = NVT + M,
                       GPD = VCRIT + M, GPC = GPD + NB * 13,
                       SIZE = GPC + NB * 13;
};
static_assert(SL<7, 4, 2>::SIZE == C_PA - C_TREM, "tremolo block size");
static_assert(SL<21, 16, 8>::SIZE == C_PRE - C_PA, "power-amp block size");

struct SolverState {
  double* v;     // (N,)
  double* i;     // (M,)
  double* v_nl;  // (M,)
  double* resid;
  double* diag;  // cooldown, nr_fail, nan_reset, damp, be_steps
};

__device__ __forceinline__ double limexp(double x) {
  return x < XC ? exp(jmin(x, XC)) : EXC * (1.0 + (x - XC));
}

// the reference's mna.bjt_currents (gp.bjt_currents), per BJT
template <int M, int NB>
__device__ __noinline__ void currents(const double* gpc, const double* vnl, double* i) {
  for (int b = 0; b < NB; ++b) {
    const double* p = gpc + 13 * b;
    const double is_ = p[0], nf_vt = p[1], nr_vt = p[2], inv_vaf = p[3],
                 inv_var = p[4], inv_ikf = p[5], inv_ikr = p[6], bf = p[7],
                 br = p[8], ise = p[9], ne_vt = p[10], isc = p[11],
                 nc_vt = p[12];
    const double vbe = vnl[2 * b], vbc = vnl[2 * b + 1];
    const double i_f = is_ * (limexp(vbe / nf_vt) - 1.0);
    const double i_r = is_ * (limexp(vbc / nr_vt) - 1.0);
    const double q1 = 1.0 / jmax(1.0 - vbc * inv_vaf - vbe * inv_var, 1e-4);
    const double q2 = i_f * inv_ikf + i_r * inv_ikr;
    const double qb = q1 * 0.5 * (1.0 + sqrt(1.0 + 4.0 * jmax(q2, 0.0)));
    const double ict = (i_f - i_r) / qb;
    const double ibe = i_f / bf + ise * (limexp(vbe / ne_vt) - 1.0);
    const double ibc = i_r / br + isc * (limexp(vbc / nc_vt) - 1.0);
    i[2 * b] = ibe + ibc;
    i[2 * b + 1] = ict - ibc;
  }
}

__device__ __forceinline__ void limexp_d(double x, double* val, double* dv) {
  const double e = exp(jmin(x, XC));
  const bool lin = x < XC;
  *val = lin ? e : EXC * (1.0 + (x - XC));
  *dv = lin ? e : EXC;
}

// closed-form GP derivatives (gp.bjt_currents_derivs_packed): the two
// entries of each Jacobian column inside its block, top = dI[2b]/dV[k],
// bot = dI[2b+1]/dV[k]
template <int M, int NB>
__device__ __noinline__ void derivs(const double* gpd, const double* vnl, double* top,
                       double* bot) {
  for (int b = 0; b < NB; ++b) {
    const double* p = gpd + 13 * b;
    const double is_ = p[0], inv_nfvt = p[1], inv_nrvt = p[2],
                 inv_vaf = p[3], inv_var = p[4], inv_ikf = p[5],
                 inv_ikr = p[6], ise = p[7], inv_nevt = p[8], isc = p[9],
                 inv_ncvt = p[10], inv_bf = p[11], inv_br = p[12];
    const double vbe = vnl[2 * b], vbc = vnl[2 * b + 1];
    double ef, def, er, der, el, dle, ec, dlc;
    limexp_d(vbe * inv_nfvt, &ef, &def);
    limexp_d(vbc * inv_nrvt, &er, &der);
    limexp_d(vbe * inv_nevt, &el, &dle);
    limexp_d(vbc * inv_ncvt, &ec, &dlc);
    const double i_f = is_ * (ef - 1.0);
    const double i_r = is_ * (er - 1.0);
    const double dif = is_ * def * inv_nfvt;
    const double dir = is_ * der * inv_nrvt;
    const double q1_arg = 1.0 - vbc * inv_vaf - vbe * inv_var;
    const bool clipped = q1_arg < 1e-4;
    const double q1 = 1.0 / jmax(q1_arg, 1e-4);
    const double q1sq = q1 * q1;
    const double dq1_be = clipped ? 0.0 : inv_var * q1sq;
    const double dq1_bc = clipped ? 0.0 : inv_vaf * q1sq;
    const double q2 = i_f * inv_ikf + i_r * inv_ikr;
    const double root = sqrt(1.0 + 4.0 * jmax(q2, 0.0));
    const double h = 0.5 * (1.0 + root);
    const double dh = q2 > 0.0 ? 1.0 / root : 0.0;
    const double qb = q1 * h;
    const double dqb_be = dq1_be * h + q1 * dh * (dif * inv_ikf);
    const double dqb_bc = dq1_bc * h + q1 * dh * (dir * inv_ikr);
    const double inv_qb = 1.0 / qb;
    const double ict = (i_f - i_r) * inv_qb;
    const double dict_be = (dif - ict * dqb_be) * inv_qb;
    const double dict_bc = (-dir - ict * dqb_bc) * inv_qb;
    const double dibe_be = dif * inv_bf + ise * dle * inv_nevt;
    const double dibc_bc = dir * inv_br + isc * dlc * inv_ncvt;
    top[2 * b] = dibe_be;
    top[2 * b + 1] = dibc_bc;
    bot[2 * b] = dict_be;
    bot[2 * b + 1] = dict_bc - dibc_bc;
  }
}

// the f32 unpivoted elimination of mna.ge_solve_numpy: jac (M×M) and f
// rounded to float, each update c − a·b rounded once from double
template <int M>
__device__ __noinline__ void ge_solve_f32(const double* jac, const double* f,
                             double* x_out) {
  float aug[M][M + 1];
  for (int r = 0; r < M; ++r) {
    for (int c = 0; c < M; ++c) aug[r][c] = (float)jac[r * M + c];
    aug[r][M] = (float)f[r];
  }
  // columns left of the running pivot are never read again: not updated
#pragma unroll 1
  for (int k = 0; k < M; ++k) {
    const float piv = aug[k][k];
    const float inv = 1.0f / (fabsf(piv) > 1e-30f ? piv : 1e-30f);
    for (int c = k + 1; c <= M; ++c) aug[k][c] = aug[k][c] * inv;
    for (int i = k + 1; i < M; ++i) {
      const double fac = (double)aug[i][k];
      for (int c = k + 1; c <= M; ++c)
        aug[i][c] = (float)((double)aug[i][c] - fac * (double)aug[k][c]);
    }
  }
  float x[M];
  for (int i = M - 1; i >= 0; --i) {
    float acc = aug[i][M];
    for (int j = i + 1; j < M; ++j)
      acc = (float)((double)acc - (double)aug[i][j] * (double)x[j]);
    x[i] = acc;
  }
  for (int i = 0; i < M; ++i) x_out[i] = (double)x[i];
}

// Newton on v_nl = p + K i(v_nl): at most ITERS iterations, leaving once
// the residual has converged; leaves v_nl's currents in i and returns the
// final residual
template <int N, int M, int NB, int ITERS>
__device__ __noinline__ double nr_solve(const double* c, const double* k_eff,
                           const double* p, double* v_nl, double* i) {
  using L = SL<N, M, NB>;
  double f[M], ki[M];
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
    currents<M, NB>(c + L::GPC, v_nl, i);
    matvec(k_eff, i, ki, M, M);
    bool conv = true;
    for (int r = 0; r < M; ++r) {
      f[r] = v_nl[r] - p[r] - ki[r];
      conv = conv && fabs(f[r]) < 1e-9;
    }
    if (conv) return max_abs(f, M);
    double top[M], bot[M], jac[M * M], dv[M];
    derivs<M, NB>(c + L::GPD, v_nl, top, bot);
    for (int r = 0; r < M; ++r)
      for (int k = 0; k < M; ++k) {
        const int r0 = 2 * (k / 2);
        jac[r * M + k] = (r == k ? 1.0 : 0.0) -
                         (k_eff[r * M + r0] * top[k] +
                          k_eff[r * M + r0 + 1] * bot[k]);
      }
    ge_solve_f32<M>(jac, f, dv);
    for (int r = 0; r < M; ++r) {
      const double v_old = v_nl[r];
      const double v_new = v_old - jclip(dv[r], -2.0, 2.0);
      const double nvt = c[L::NVT + r];
      const double delta = v_new - v_old;
      const double lim = v_old + nvt * log1p(jmax(delta, 0.0) / nvt);
      const bool apply = (v_new > c[L::VCRIT + r]) && (delta > 2.0 * nvt);
      v_nl[r] = apply ? lim : v_new;
    }
  }
  currents<M, NB>(c + L::GPC, v_nl, i);
  matvec(k_eff, i, ki, M, M);
  for (int r = 0; r < M; ++r) f[r] = v_nl[r] - p[r] - ki[r];
  return max_abs(f, M);
}

// one integration step with the trapezoidal (be = false) or the
// backward-Euler matrices, from the state's v, i, v_nl
template <int N, int M, int NB, int ITERS>
__device__ __noinline__ double solve_once(const double* c, const SolverState& st,
                             const double* w_extra, bool be, double* v,
                             double* i_new, double* v_nl) {
  using L = SL<N, M, NB>;
  const double* a_hist = c + (be ? L::AHBE : L::AH);
  const double* s_mat = c + (be ? L::SBE : L::S);
  const double* s_ni = c + (be ? L::SNIBE : L::SNI);
  const double* k_eff = c + (be ? L::KBE : L::K);
  const double* w_sc = c + (be ? L::WSBE : L::WS);
  const double trap_i = be ? 0.0 : c[L::TRAP_I];
  double rhs[N], t[N], v_lin[N], p[M];
  matvec(a_hist, st.v, rhs, N, N);
  for (int r = 0; r < N; ++r)
    rhs[r] = rhs[r] + w_sc[r] * c[L::W + r] + w_extra[r];
  matvec(c + L::NI, st.i, t, N, M);
  for (int r = 0; r < N; ++r) rhs[r] = rhs[r] + trap_i * t[r];
  matvec(s_mat, rhs, v_lin, N, N);
  matvec(c + L::NV, v_lin, p, M, N);
  for (int r = 0; r < M; ++r) v_nl[r] = st.v_nl[r];
  const double resid = nr_solve<N, M, NB, ITERS>(c, k_eff, p, v_nl, i_new);
  matvec(s_ni, i_new, t, N, M);
  for (int r = 0; r < N; ++r) v[r] = v_lin[r] + t[r];
  return resid;
}

template <int N>
__device__ bool failed(const double* v, double resid, int n_nodes) {
  bool nonfin = false;
  for (int r = 0; r < N; ++r) nonfin = nonfin || !finite(v[r]);
  return resid > 1e-3 || max_abs(v, n_nodes) > 55.0 || nonfin;
}

// mna.make_step's step: trapezoidal primary → failure → BE replay and its
// 64-sample hold → the 30 V damping net → NaN reset to the DC point
template <int N, int M, int NB, int ITERS>
__device__ __noinline__ void mna_step(const double* c, SolverState& st,
                         const double* w_extra) {
  using L = SL<N, M, NB>;
  const int n_nodes = (int)c[L::N_NODES];
  const bool trap_primary = c[L::TRAP_PRIMARY] != 0.0;
  double* dg = st.diag;
  double v[N], i_new[M], v_nl[M];
  double resid = solve_once<N, M, NB, ITERS>(c, st, w_extra, false, v,
                                             i_new, v_nl);
  const bool need_be =
      trap_primary && (failed<N>(v, resid, n_nodes) || dg[0] > 0.0);
  if (need_be)
    resid = solve_once<N, M, NB, ITERS>(c, st, w_extra, true, v, i_new,
                                        v_nl);
  const bool fail = failed<N>(v, resid, n_nodes);
  double dv[N];
  for (int r = 0; r < N; ++r) dv[r] = v[r] - st.v[r];
  const double dv_max = max_abs(dv, N);
  const bool damp_hit = finite(dv_max) && dv_max > 30.0;
  const double scale = damp_hit ? 30.0 / jmax(dv_max, 1e-30) : 1.0;
  bool bad = false;
  for (int r = 0; r < N; ++r) {
    v[r] = st.v[r] + dv[r] * scale;
    bad = bad || !finite(v[r]);
  }
  for (int r = 0; r < N; ++r) st.v[r] = bad ? c[L::VDC + r] : v[r];
  for (int r = 0; r < M; ++r) {
    st.i[r] = bad ? c[L::IDC + r] : i_new[r];
    st.v_nl[r] = bad ? c[L::VNLDC + r] : v_nl[r];
  }
  *st.resid = resid;
  dg[0] = fail ? 64.0 : (dg[0] - 1.0 > 0.0 ? dg[0] - 1.0 : 0.0);
  dg[1] = dg[1] + (fail ? 1.0 : 0.0);
  dg[2] = dg[2] + (bad ? 1.0 : 0.0);
  dg[3] = dg[3] + (damp_hit ? 1.0 : 0.0);
  dg[4] = dg[4] + (need_be ? 1.0 : 0.0);
}

// ═════════════════════════════ E2: chain ═════════════════════════════

__device__ __forceinline__ double branch_step(const double* coeffs,
                                              double* st, double x) {
  double y = x;
  for (int k = 0; k < 3; ++k) {
    const double out = coeffs[k] * y + st[k];
    st[k] = y - coeffs[k] * out;
    y = out;
  }
  return y;
}

__constant__ double kBranchA[3] = {0.036681502163648, 0.248030921580110,
                                   0.643184620136480};
__constant__ double kBranchB[3] = {0.110377634768680, 0.420399304190880,
                                   0.854640112701920};

__device__ __forceinline__ double smoother_next(double* s) {
  const bool active = s[3] > 0.0;
  double nxt = active ? s[0] + s[2] : s[0];
  const double rem = active ? s[3] - 1.0 : s[3];
  nxt = (active && rem == 0.0) ? s[1] : nxt;
  s[0] = nxt;
  s[3] = rem;
  return nxt;
}

__device__ __forceinline__ void bjt_ic_gm(double vbe, double* ic,
                                          double* gm) {
  const double e = exp(jclip(vbe, -1.0, 0.85) / 0.026);
  *ic = 3.03e-14 * (e - 1.0);
  *gm = (3.03e-14 / 0.026) * e;
}

enum { B1 = 0, E1 = 1, C1 = 2, E2 = 3, C2 = 5, OUTN = 6, FB = 7 };

// dk_preamp.step on the chain state; returns main − shadow
__device__ __noinline__ double preamp_step(const double* pc, double* ch, double g,
                              double x) {
  double* v = ch + CH_PRE_V;       // (2, 8)
  double* inl = ch + CH_PRE_I;     // (2, 2)
  double* vnl = ch + CH_PRE_VNL;   // (2, 2)
  double* jcin = ch + CH_PRE_JCIN;
  double* cinprev = ch + CH_PRE_CINPREV;
  const double gprev = ch[CH_PRE_GPREV];
  const double u[2] = {x, 0.0};
  double v_pred[2][8], cin_now[2];
  const double sm_k = g / (1.0 + pc[PR_S_FB_FB] * g);
  for (int r = 0; r < 2; ++r) {
    double rhs[8], vpb[8];
    matvec(pc + PR_A_NEG, v + 8 * r, rhs, 8, 8);
    rhs[FB] = rhs[FB] + (-gprev) * v[8 * r + FB];
    cin_now[r] = pc[PR_G_CIN] * u[r] + jcin[r];
    rhs[B1] = rhs[B1] + (cin_now[r] + cinprev[r]);
    rhs[E1] = rhs[E1] + inl[2 * r];
    rhs[C1] = rhs[C1] + (-inl[2 * r]);
    rhs[E2] = rhs[E2] + inl[2 * r + 1];
    rhs[C2] = rhs[C2] + (-inl[2 * r + 1]);
    for (int n = 0; n < 8; ++n) rhs[n] = rhs[n] + pc[PR_TWO_W + n];
    matvec(pc + PR_S_BASE, rhs, vpb, 8, 8);
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
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
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
  ch[CH_PRE_GPREV] = g;
  return bad ? 0.0 : out;
}

__device__ void init_preamp(const double* pc, double* ch) {
  for (int r = 0; r < 2; ++r) {
    for (int n = 0; n < 8; ++n) ch[CH_PRE_V + 8 * r + n] = pc[PR_V_DC + n];
    for (int k = 0; k < 2; ++k) {
      ch[CH_PRE_I + 2 * r + k] = pc[PR_I_NL_DC + k];
      ch[CH_PRE_VNL + 2 * r + k] = pc[PR_V_NL_DC + k];
    }
    ch[CH_PRE_JCIN + r] = pc[PR_J_CIN_DC];
    ch[CH_PRE_CINPREV + r] = pc[PR_J_CIN_DC];
  }
  ch[CH_PRE_GPREV] = 1.0 / 1000000.0;
}

__device__ void init_power_amp(const double* pa, double* ch) {
  using L = SL<21, 16, 8>;
  for (int r = 0; r < 21; ++r) ch[CH_PA_V + r] = pa[L::VDC + r];
  for (int r = 0; r < 16; ++r) {
    ch[CH_PA_I + r] = pa[L::IDC + r];
    ch[CH_PA_VNL + r] = pa[L::VNLDC + r];
  }
  ch[CH_PA_RESID] = 0.0;
  for (int k = 0; k < 5; ++k) ch[CH_PA_DIAG + k] = 0.0;
  ch[CH_PA_RAILS] = 22.5;
  ch[CH_PA_RAILS + 1] = 22.5;
  ch[CH_PA_RAILS + 2] = 0.0;
  ch[CH_PA_RAILS + 3] = 0.0;
  ch[CH_PA_LAST] = 0.0;
}

// tremolo.step: oscillator → vactrol → CdS R → divider; returns the shunt
__device__ __noinline__ double tremolo_step(const double* c, const double* misc,
                               double* ch, double depth) {
  SolverState st{ch + CH_TREM_V, ch + CH_TREM_I, ch + CH_TREM_VNL,
                 ch + CH_TREM_RESID, ch + CH_TREM_DIAG};
  const double w0[7] = {0, 0, 0, 0, 0, 0, 0};
  mna_step<7, 4, 2, 4>(c + C_TREM, st, w0);
  const double v_out = ch[CH_TREM_V + (int)misc[M_TREM_OUT]];
  const double led = jclip((10.95 - v_out) / (10.95 - 0.70), 0.0, 1.0);
  const double env0 = ch[CH_TREM_ENV];
  const double coeff = led > env0 ? misc[M_TREM_ATT] : misc[M_TREM_REL];
  const double env = led + coeff * (env0 - led);
  const double drive = jclip(env, 0.0, 1.0);
  const double log_r =
      misc[M_LN_RMAX] + misc[M_LN_SPAN] * pow(jmax(drive, 1e-30), 0.9);
  const double r_ldr = drive < 1e-6 ? 1000000.0 : exp(log_r);
  ch[CH_TREM_ENV] = env;
  ch[CH_TREM_RLDR] = r_ldr;
  const double r_upper = 50000.0 * (1.0 - depth);
  const double r_lower = 50000.0 * depth;
  const double top =
      r_upper > 0.0 ? r_upper * 18000.0 / (r_upper + 18000.0) : 0.0;
  const double br = 680.0 + r_ldr;
  const double low = r_lower > 0.0 ? r_lower * br / (r_lower + br) : 0.0;
  return top + low;
}

// power_amp.step: rails into the sources, the circuit, the two-tier
// guard, the rails after the solve
__device__ __noinline__ double power_amp_step(const double* c, const double* misc,
                                 double* ch, double x, bool sag) {
  const double sag_f = sag ? 1.0 : 0.0;
  double* rails = ch + CH_PA_RAILS;
  double w[21];
  for (int r = 0; r < 21; ++r) w[r] = 0.0;
  w[(int)misc[M_PA_V1]] = (rails[0] - 22.5) * sag_f;
  w[(int)misc[M_PA_V2]] = (rails[1] - 22.5) * sag_f;
  w[(int)misc[M_PA_IN]] = x;
  SolverState st{ch + CH_PA_V, ch + CH_PA_I, ch + CH_PA_VNL,
                 ch + CH_PA_RESID, ch + CH_PA_DIAG};
  const double* pa = c + C_PA;
  mna_step<21, 16, 8, 16>(pa, st, w);
  using L = SL<21, 16, 8>;
  const double raw = ch[CH_PA_V + (int)misc[M_PA_OUT]];
  const double result = raw / 22.0;
  const bool nr_failed = ch[CH_PA_RESID] > 1e-3;
  bool insane = false;
  for (int r = 0; r < 21; ++r) {
    const double vr = ch[CH_PA_V + r];
    insane = insane || !finite(vr) || fabs(vr) > 100.0;
  }
  const bool reset = !finite(result) || insane;
  const bool bad = reset || nr_failed;
  if (reset) {
    for (int r = 0; r < 21; ++r) ch[CH_PA_V + r] = pa[L::VDC + r];
    for (int r = 0; r < 16; ++r) {
      ch[CH_PA_I + r] = pa[L::IDC + r];
      ch[CH_PA_VNL + r] = pa[L::VNLDC + r];
    }
  }
  const double out = bad ? ch[CH_PA_LAST] : jclip(result, -1.0, 1.0);
  ch[CH_PA_LAST] = out;
  if (sag) {
    if (bad) {
      rails[0] = 22.5;
      rails[1] = 22.5;
      rails[2] = 0.0;
      rails[3] = 0.0;
    } else {
      const double a_i = misc[M_PA_IAVG];
      const double i_pos = jmax(raw / 8.0, 0.0);
      const double i_neg = jmax(-raw / 8.0, 0.0);
      const double iap = rails[2] + a_i * (i_pos - rails[2]);
      const double ian = rails[3] + a_i * (i_neg - rails[3]);
      const double tp = 24.5 - iap * 3.5;
      const double tn = 24.5 - ian * 3.5;
      const double ap = tp < rails[0] ? misc[M_PA_ATT] : misc[M_PA_REL];
      const double an = tn < rails[1] ? misc[M_PA_ATT] : misc[M_PA_REL];
      rails[0] = rails[0] + ap * (tp - rails[0]);
      rails[1] = rails[1] + an * (tn - rails[1]);
      rails[2] = iap;
      rails[3] = ian;
    }
  }
  return out;
}

struct Biquad { double b0, b1, b2, a1, a2; };

__device__ __noinline__ Biquad design(bool lowpass, double hz, double q, double sr) {
  const double w0 = 2.0 * M_PI * hz / sr;
  const double sn = sin(w0), cs = cos(w0);
  const double alpha = sn / (2.0 * q);
  double b0, b1;
  if (lowpass) {
    b1 = 1.0 - cs;
    b0 = b1 / 2.0;
  } else {
    b1 = -(1.0 + cs);
    b0 = (1.0 + cs) / 2.0;
  }
  const double a0 = 1.0 + alpha;
  return Biquad{b0 / a0, b1 / a0, b0 / a0, (-2.0 * cs) / a0,
                (1.0 - alpha) / a0};
}

__device__ __forceinline__ double biquad(const Biquad& k, double* z,
                                         double x) {
  const double y = k.b0 * x + z[0];
  const double z1 = k.b1 * x - k.a1 * y + z[1];
  z[1] = k.b2 * x - k.a2 * y;
  z[0] = z1;
  return y;
}

// the whole chain of one base sample (engine.py's render body after the
// voice sum); returns the f64 output before the cast
__device__ __noinline__ double chain_sample(const double* c, double* ch, double mono,
                               bool sag, double* last_char, Biquad* hpf,
                               Biquad* lpf, double* spk_k) {
  const double* misc = c + C_MISC;
  const double* pc = c + C_PRE;
  const double depth = smoother_next(ch + CH_SM_DEPTH);
  const double vol = smoother_next(ch + CH_SM_VOLUME);
  const double chr = smoother_next(ch + CH_SM_CHAR);
  double amp_out;
  const double drive = 0.25;  // tables.FIXED_CIRCUIT_DRIVE
  if (misc[M_OVERSAMPLE] != 0.0) {
    const double e = branch_step(kBranchA, ch + CH_OS_UP_A, mono);
    const double o = branch_step(kBranchB, ch + CH_OS_UP_B, mono);
    double y[2];
    const double us[2] = {e, o};
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const double shunt = tremolo_step(c, misc, ch, depth);
      const double g = 1.0 / jmax(shunt, 1000.0);
      const double pre = preamp_step(pc, ch, g, us[h]);
      y[h] = power_amp_step(c, misc, ch, pre * drive, sag);
    }
    const double a = branch_step(kBranchA, ch + CH_OS_DOWN_A, y[0]);
    const double b = branch_step(kBranchB, ch + CH_OS_DOWN_B, y[1]);
    amp_out = (a + ch[CH_OS_DELAY]) * 0.5;
    ch[CH_OS_DELAY] = b;
  } else {
    const double shunt = tremolo_step(c, misc, ch, depth);
    const double g = 1.0 / jmax(shunt, 1000.0);
    const double pre = preamp_step(pc, ch, g, mono);
    amp_out = power_amp_step(c, misc, ch, pre * drive, sag);
  }
  // speaker: coefficients redesigned only when the character moved
  if (__double_as_longlong(chr) != __double_as_longlong(*last_char)) {
    *last_char = chr;
    const double cc = jclip(chr, 0.0, 1.0);
    const double sr = misc[M_SPK_SR];
    *hpf = design(false, 20.0 * pow(30.0 / 20.0, cc), 0.75, sr);
    *lpf = design(true, 20000.0 * pow(5500.0 / 20000.0, cc), 0.707, sr);
    spk_k[0] = 0.2 * cc;
    spk_k[1] = 0.6 * cc;
    spk_k[2] = 2.0 * cc;
    spk_k[3] = cc;
  }
  double* spk = ch + CH_SPK;
  const double a2 = spk_k[0], a3 = spk_k[1];
  const double x2 = amp_out * amp_out;
  const double shaped =
      (amp_out + a2 * x2 + a3 * x2 * amp_out) / (1.0 + a2 + a3);
  const double limited = spk_k[3] < 0.001 ? shaped : tanh(shaped);
  const double thermal = spk[4] + (x2 - spk[4]) * misc[M_SPK_ALPHA];
  spk[4] = thermal;
  const double tg = 1.0 / (1.0 + spk_k[2] * sqrt(thermal));
  const double filtered = biquad(*hpf, spk, limited * tg);
  const double y = biquad(*lpf, spk + 2, filtered);
  const double out = y * misc[M_POST_GAIN] * vol;
  if (!finite(out)) {
    // NaN guard #2: preamp, oversampler, power amp and speaker reset
    for (int k = 0; k < 13; ++k) ch[CH_OS_UP_A + k] = 0.0;
    init_preamp(pc, ch);
    init_power_amp(c + C_PA, ch);
    for (int k = 0; k < 5; ++k) spk[k] = 0.0;
    return 0.0;
  }
  return out;
}

__global__ void engine_chain_kernel(const double* __restrict__ c,
                                    const double* __restrict__ mono,
                                    double* chain, float* out, int n,
                                    int sag) {
  double ch[CHAIN_ROWS];
  for (int k = 0; k < CHAIN_ROWS; ++k) ch[k] = chain[k];
  double last_char = __longlong_as_double(0x7ff8dead0000beefLL);  // NaN
  Biquad hpf, lpf;
  double spk_k[4];
  for (int t = 0; t < n; ++t)
    out[t] = (float)chain_sample(c, ch, mono[t], sag != 0, &last_char, &hpf,
                                 &lpf, spk_k);
  for (int k = 0; k < CHAIN_ROWS; ++k) chain[k] = ch[k];
}

// ═════════════════════════════ E3: settle ═════════════════════════════

constexpr int OSC_ROWS = 7 + 4 + 4 + 1 + 5;

__global__ void tremolo_settle_kernel(const double* __restrict__ c,
                                      double* state, int n_steps) {
  double s[OSC_ROWS];
  for (int k = 0; k < OSC_ROWS; ++k) s[k] = state[k];
  SolverState st{s, s + 7, s + 11, s + 15, s + 16};
  const double w0[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int t = 0; t < n_steps; ++t) mna_step<7, 4, 2, 4>(c, st, w0);
  for (int k = 0; k < OSC_ROWS; ++k) state[k] = s[k];
}

}  // namespace

extern "C" int ow_engine_voices(const double* vpar, double* vst,
                                long long* vsti, long long* eng_i,
                                double* mono, int n, double fade_len,
                                double sample_rate, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  engine_voices_kernel<<<1, SLOTS, 0, stream>>>(vpar, vst, vsti, eng_i, mono,
                                                n, fade_len, sample_rate);
  return (int)cudaGetLastError();
}

extern "C" int ow_engine_chain(const double* consts, int n_consts,
                               const double* mono, double* chain, float* out,
                               int n, int rail_sag, cudaStream_t stream) {
  if (n_consts != C_TOTAL || n < 0) return (int)cudaErrorInvalidValue;
  engine_chain_kernel<<<1, 1, 0, stream>>>(consts, mono, chain, out, n,
                                           rail_sag);
  return (int)cudaGetLastError();
}

extern "C" int ow_tremolo_settle(const double* consts, int n_consts,
                                 double* state, int n_steps,
                                 cudaStream_t stream) {
  if (n_consts != SL<7, 4, 2>::SIZE || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  tremolo_settle_kernel<<<1, 1, 0, stream>>>(consts, state, n_steps);
  return (int)cudaGetLastError();
}
