// The f64 kernels of the engine (openwurli_tpu_torch/kernels/engine.py)
// and of the offline render paths (openwurli_tpu_torch/kernels/render.py):
//
//   E1 engine_voices      the 64 main + 64 steal voice slots over one chunk
//   E2 engine_chain       the mono chain over that chunk, a template over
//                         the preamp (DK or melange) and the power amp
//                         (circuit or behavioral)
//   E3 tremolo_settle     the tremolo oscillator's step, n times
//   E4 voice_render       G voices over n samples (voice.render); with
//                         TAP, the reed alone into the pickup, the reed's
//                         output kept (calibrate.run_calibrate's T1, T2)
//   E5 preamp_scan        G preamp streams over n samples: the DI path's
//                         2x-oversampled DK preamp, or the melange preamp
//   E6 pa_speaker_scan    G streams over n samples: volume², the power amp
//                         with rail sag, the speaker, the post-speaker gain
//                         (calibrate.run_calibrate's T5)
//
// Replaces: the reference's jitted lax.scans of its float64 engine
// (openwurli_tpu/engine.py:452 `_render`), of its tremolo settle
// (openwurli_tpu/circuits/tremolo.py:160), of voice.render
// (openwurli_tpu/voice.py:140), of di.preamp_di (openwurli_tpu/di.py:29),
// of the melange preamp's step
// (openwurli_tpu/circuits/melange_preamp.py:177) and of run_calibrate's tap
// scans (openwurli_tpu/calib/calibrate.py:80-138); none is a Pallas kernel.
//
// Bound: latency. A chunk is a serial recurrence: E1 advances each voice
// slot by one thread (a block of 128), E4, E5 and E6 each voice or stream
// by one thread, E2 and E3 are one thread walking the chain's data-dependent
// Newton solves sample by sample. The bytes are
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
// from double (mna.ge_solve_numpy). The melange preamp's noise is JAX's
// threefry2x32 stream (integer, exact) through XLA's erfinv polynomial,
// written op for op in prng.normal_f64.

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
  CH_SM_CHAR = 142, CH_MEL_V = 146, CH_MEL_I = 172, CH_MEL_VNL = 182,
  CH_MEL_GPREV = 192, CH_MEL_KEY = 193, CH_MEL_WPREV = 195, CHAIN_ROWS = 205
};
// the DK preamp's rows, relative to CH_PRE_V (the chain's and E5's)
enum PreState {
  PS_V = 0, PS_I = 16, PS_VNL = 20, PS_JCIN = 24, PS_CINPREV = 26,
  PS_GPREV = 28, PS_ROWS = 29
};
// the melange preamp's rows, relative to CH_MEL_V (the chain's and E5's)
enum MelState {
  MS_V = 0, MS_I = 26, MS_VNL = 36, MS_GPREV = 46, MS_KEY = 47,
  MS_WPREV = 49, MS_ROWS = 59
};
static_assert(CH_PRE_GPREV - CH_PRE_V == PS_GPREV, "DK preamp rows");
static_assert(CHAIN_ROWS - CH_MEL_V == MS_ROWS, "melange rows");
constexpr int OS_ROWS = 13;  // the oversampler's rows, from CH_OS_UP_A

// chain constants (kernels/engine.py chain_params): block offsets, then
// the preamp block and the misc scalars
enum ConstOffset {
  C_TREM = 0, C_PA = 440, C_PRE = 4420, C_MISC = 4607, C_TOTAL = 4623
};
constexpr int C_MEL = C_TOTAL;  // a melange engine's melange block
// the melange preamp's constants (kernels/engine.py MEL_SPEC)
enum MelOffset {
  ML_A_HIST = 0, ML_S = 169, ML_N_V = 338, ML_N_I = 403, ML_S_NI = 468,
  ML_K = 533, ML_WS_W = 558, ML_V_DC = 571, ML_I_DC = 584, ML_V_NL_DC = 589,
  ML_S_FB_COL = 594, ML_S_FB_FB = 607, ML_K_OUTER = 608, ML_SFB_NI = 633,
  ML_INJECT = 638, ML_SIGMA = 768, ML_CUR = 778, ML_DER = 804,
  ML_DIODE = 830, ML_IDX = 832, ML_SIZE = 835
};
enum Models { PRE_DK = 0, PRE_MELANGE = 1, PA_CIRCUIT = 0, PA_BEHAVIORAL = 1 };
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

// ═══════════════════════ E1 and E4: voices ═══════════════════════

__device__ __forceinline__ long long lcg(long long s) {
  return (s * 1664525LL + 1013904223LL) & 0xFFFFFFFFLL;
}

// one voice's note-on constants and state (the vpar / vst / vsti rows)
struct Voice {
  double cos_inc[NM], sin_inc[NM], phase_inc[NM], amp[NM], decay[NM];
  double s[NM], c[NM], env[NM], drift[NM], drate[NM], dmult[NM];
  double ramp_n, ramp_inc, shape, revert, diffusion, ndecay;
  double b0, b1, b2, a1, a2, beta, ds, gain;
  double dramp, dcount, namp, z1, z2, q;
  long long jst, nn, nrem, nfade, nrng;
  bool dact, ddone;
};

// column j of the packed voice rows, `stride` columns per row
__device__ __forceinline__ void voice_load(Voice& v, const double* vpar,
                                           const double* vst,
                                           const long long* vsti,
                                           int stride, int j) {
#define PAR(r) vpar[(size_t)(r) * stride + j]
#define ST(r) vst[(size_t)(r) * stride + j]
#define STI(r) vsti[(size_t)(r) * stride + j]
  for (int k = 0; k < NM; ++k) {
    v.cos_inc[k] = PAR(P_COS + k);
    v.sin_inc[k] = PAR(P_SIN + k);
    v.phase_inc[k] = PAR(P_PHASE + k);
    v.amp[k] = PAR(P_AMP + k);
    v.decay[k] = PAR(P_DECAY + k);
    v.s[k] = ST(S_S + k);
    v.c[k] = ST(S_C + k);
    v.env[k] = ST(S_ENV + k);
    v.drift[k] = ST(S_DRIFT + k);
    v.drate[k] = ST(S_DRATE + k);
    v.dmult[k] = ST(S_DMULT + k);
  }
  v.ramp_n = PAR(P_RAMP_N);
  v.ramp_inc = PAR(P_RAMP_INC);
  v.shape = PAR(P_SHAPE);
  v.revert = PAR(P_REVERT);
  v.diffusion = PAR(P_DIFF);
  v.ndecay = PAR(P_NDECAY);
  v.b0 = PAR(P_BPF);
  v.b1 = PAR(P_BPF + 1);
  v.b2 = PAR(P_BPF + 2);
  v.a1 = PAR(P_BPF + 3);
  v.a2 = PAR(P_BPF + 4);
  v.beta = PAR(P_BETA);
  v.ds = PAR(P_DS);
  v.gain = PAR(P_GAIN);
  v.dramp = ST(S_DRAMP);
  v.dcount = ST(S_DCOUNT);
  v.namp = ST(S_NAMP);
  v.z1 = ST(S_Z1);
  v.z2 = ST(S_Z2);
  v.q = ST(S_Q);
  v.jst = STI(I_JST);
  v.nn = STI(I_N);
  v.nrem = STI(I_NREM);
  v.nfade = STI(I_NFADE);
  v.nrng = STI(I_NRNG);
  v.dact = STI(I_DACT) != 0;
  v.ddone = STI(I_DDONE) != 0;
}

// the state rows a sample moves (the damper's constants do not move)
__device__ __forceinline__ void voice_store(const Voice& v, double* vst,
                                            long long* vsti, int stride,
                                            int j) {
  for (int k = 0; k < NM; ++k) {
    ST(S_S + k) = v.s[k];
    ST(S_C + k) = v.c[k];
    ST(S_ENV + k) = v.env[k];
    ST(S_DRIFT + k) = v.drift[k];
  }
  ST(S_DCOUNT) = v.dcount;
  ST(S_NAMP) = v.namp;
  ST(S_Z1) = v.z1;
  ST(S_Z2) = v.z2;
  ST(S_Q) = v.q;
  STI(I_JST) = v.jst;
  STI(I_N) = v.nn;
  STI(I_DDONE) = v.ddone ? 1 : 0;
  STI(I_NREM) = v.nrem;
  STI(I_NFADE) = v.nfade;
  STI(I_NRNG) = v.nrng;
#undef PAR
#undef ST
#undef STI
}

// hammer.noise_step; returns the noise sample
__device__ __forceinline__ double noise_sample(Voice& v) {
  const bool active = v.nrem > 0;
  const bool in_fade = v.nfade > 0;
  const double tf = (double)(16 - v.nfade) / 16.0;
  const double nenv = in_fade ? 0.5 * (1.0 - cos(M_PI * tf)) : 1.0;
  const long long r = lcg(v.nrng);
  const double noise =
      (double)(r >= 2147483648LL ? r - 4294967296LL : r) / 2147483647.0;
  const double y = v.b0 * noise + v.z1;
  const double nz1 = v.b1 * noise - v.a1 * y + v.z2;
  const double nz2 = v.b2 * noise - v.a2 * y;
  const double noise_out = active ? v.namp * nenv * y : 0.0;
  if (active) {
    v.namp = v.namp * v.ndecay;
    v.nrem = v.nrem - 1;
    if (in_fade) v.nfade = v.nfade - 1;
    v.z1 = nz1;
    v.z2 = nz2;
    v.nrng = r;
  }
  return noise_out;
}

// voice.step: reed → attack noise → pickup → post-pickup gain; returns
// the voice's output sample. With TAP (run_calibrate's T1 and T2): the
// reed alone into the pickup, without the attack noise (not even a zero
// added) and without the post-pickup gain; the reed's sample goes to
// *reed_tap.
template <bool TAP>
__device__ __forceinline__ double voice_sample(Voice& v, double* reed_tap) {
  // ── reed.step: damper → onset → jitter → output/rotation → renorm
  const double rel = v.dact ? v.dcount + 1.0 : v.dcount;
  const bool past = rel > v.dramp;
  const bool in_ramp = v.dact && !v.ddone && !past;
  const bool done2 = v.ddone || (v.dact && past);
  const double ratio = rel / jmax(v.dramp, 1e-30);
  for (int k = 0; k < NM; ++k) {
    const double inst = v.drate[k] * ratio;
    v.env[k] = v.env[k] * (in_ramp ? exp(-inst) : 1.0);
    v.env[k] = v.env[k] * ((v.dact && done2) ? v.dmult[k] : 1.0);
  }
  const double cosine = 0.5 * (1.0 - cos((double)v.nn * v.ramp_inc));
  double shaped;
  if (v.shape <= 1.001) shaped = cosine;
  else if (v.shape >= 1.999) shaped = cosine * cosine;
  else shaped = pow(jmax(cosine, 0.0), v.shape);
  const double onset = ((double)v.nn < v.ramp_n) ? shaped : 1.0;
  if ((v.nn & 15) == 0) {
    long long js = v.jst;
    for (int k = 0; k < NM; ++k) {
      js = lcg(js);
      const double u = (double)(js >> 1) / 2147483647.5;
      const double nz = (u * 2.0 - 1.0) * 1.7320508080;
      v.drift[k] = v.revert * v.drift[k] + v.diffusion * nz;
    }
    v.jst = js;
  }
  double reed_out = 0.0;
  for (int k = 0; k < NM; ++k) {
    const double term = v.amp[k] * v.s[k] * onset * v.env[k];
    reed_out = (k == 0) ? term : reed_out + term;
  }
  const bool renorm = ((v.nn & 1023) == 0) && v.nn > 0;
  for (int k = 0; k < NM; ++k) {
    const double dp = v.drift[k] * v.phase_inc[k];
    const double ci = v.cos_inc[k] - dp * v.sin_inc[k];
    const double si = v.sin_inc[k] + dp * v.cos_inc[k];
    const double s_new = v.s[k] * ci + v.c[k] * si;
    const double c_new = v.c[k] * ci - v.s[k] * si;
    v.env[k] = v.env[k] * v.decay[k];
    const double scale =
        renorm ? 1.0 / sqrt(s_new * s_new + c_new * c_new) : 1.0;
    v.s[k] = s_new * scale;
    v.c[k] = c_new * scale;
  }
  v.nn += 1;
  v.dcount = rel;
  v.ddone = done2;

  // ── hammer.noise_step, then pickup.step
  double yy;
  if constexpr (TAP) {
    *reed_tap = reed_out;
    yy = reed_out * v.ds;
  } else {
    const double noise_out = noise_sample(v);
    yy = (reed_out + noise_out) * v.ds;
  }
  const double ay = fabs(yy);
  const double rng = 0.98 - 0.94;
  double ys = yy;
  if (!(ay < 0.94)) {
    const double sat = 0.94 + rng * tanh((ay - 0.94) / rng);
    ys = yy >= 0.0 ? sat : -sat;
  }
  const double omy = 1.0 - ys;
  const double alpha = v.beta * omy;
  v.q = (v.q * (1.0 - alpha) + 2.0 * v.beta) / (1.0 + alpha);
  if constexpr (TAP) return (v.q * omy - 1.0) * 1.8375;
  return (v.q * omy - 1.0) * 1.8375 * v.gain;
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
  Voice v;
  voice_load(v, vpar, vst, vsti, SLOTS, j);
  long long gate = eng_i[j];  // slot state (main) or steal fade (steal)
  if (j == 0) fires = 0;

  for (int t0 = 0; t0 < n; t0 += TILE) {
    const int tn = min(TILE, n - t0);
    if (j < TILE) bad_tile[j] = 0;
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      const double out = voice_sample<false>(v, nullptr);
      // ── gates and NaN guard #1
      double g;
      bool bad;
      if (main_slot) {
        const double x = gate != 0 ? out : 0.0;
        bad = !finite(x);
        g = bad ? 0.0 : x;
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
    const double rel_s = v.dact ? v.dcount / sample_rate : 0.0;
    bool silent = v.dact && rel_s > 10.0;
    bool quiet = true;
    for (int k = 0; k < NM; ++k)
      quiet = quiet && fabs(v.amp[k] * v.env[k]) <= 1e-4;
    if (silent || quiet) gate = 0;
  }
  voice_store(v, vst, vsti, SLOTS, j);
  eng_i[j] = gate;
  __syncthreads();
  if (j == 0) eng_i[EI_FIRES] += (long long)fires;
}

// E4: a thread per voice; out (n, G) time major, so that a warp's voices
// store one coalesced row per sample. With TAP, reed (n, G) gets the
// reed's samples.
constexpr int E4_BLOCK = 32;

template <bool TAP>
__global__ void __launch_bounds__(E4_BLOCK)
voice_render_kernel(const double* __restrict__ vpar, double* vst,
                    long long* vsti, double* out, double* reed, int g,
                    int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  Voice v;
  voice_load(v, vpar, vst, vsti, g, j);
  for (int t = 0; t < n; ++t) {
    double r;
    out[(size_t)t * g + j] = voice_sample<TAP>(v, &r);
    if constexpr (TAP) reed[(size_t)t * g + j] = r;
  }
  voice_store(v, vst, vsti, g, j);
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

// dk_preamp.step on the DK preamp's rows `ps` (PreState); returns
// main − shadow
__device__ __noinline__ double preamp_step(const double* pc, double* ps, double g,
                              double x) {
  double* v = ps + PS_V;       // (2, 8)
  double* inl = ps + PS_I;     // (2, 2)
  double* vnl = ps + PS_VNL;   // (2, 2)
  double* jcin = ps + PS_JCIN;
  double* cinprev = ps + PS_CINPREV;
  const double gprev = ps[PS_GPREV];
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
  ps[PS_GPREV] = g;
  return bad ? 0.0 : out;
}

__device__ void init_preamp(const double* pc, double* ps) {
  for (int r = 0; r < 2; ++r) {
    for (int n = 0; n < 8; ++n) ps[PS_V + 8 * r + n] = pc[PR_V_DC + n];
    for (int k = 0; k < 2; ++k) {
      ps[PS_I + 2 * r + k] = pc[PR_I_NL_DC + k];
      ps[PS_VNL + 2 * r + k] = pc[PR_V_NL_DC + k];
    }
    ps[PS_JCIN + r] = pc[PR_J_CIN_DC];
    ps[PS_CINPREV + r] = pc[PR_J_CIN_DC];
  }
  ps[PS_GPREV] = 1.0 / 1000000.0;
}

// ═══════════════════════ the melange preamp ═══════════════════════

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (prng.threefry2x32)
__device__ __noinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t c1,
                                      uint32_t c2, uint32_t* o1,
                                      uint32_t* o2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = c1 + ks[0], x1 = c2 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 = x0 + x1;
      x1 = x0 ^ rotl32(x1, rot[i % 2][r]);
    }
    x0 = x0 + ks[(i + 1) % 3];
    x1 = x1 + ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *o1 = x0;
  *o2 = x1;
}

// XLA's float64 erf_inv (prng.erfinv): coefficients from the highest
// power, for w < 6.25, w < 16 and w >= 16
__constant__ double kErfinvLt625[23] = {
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
    6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
    1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.0060336708714301491,
    0.24015818242558962, 1.6536545626831027};
__constant__ double kErfinvLt16[19] = {
    2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
    0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
    -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
    3.0838856104922208};
__constant__ double kErfinvGt16[17] = {
    -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
    7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.849906401408584};

__device__ __noinline__ double erfinv_xla(double x) {
  const double w = -log1p(x * -x);
  const bool lt625 = w < 6.25, lt16 = w < 16.0;
  const double sqrt_w = sqrt(w);
  const double t = lt625 ? w + -3.125 : sqrt_w - (lt16 ? 3.25 : 5.0);
  const double* c = lt625 ? kErfinvLt625 : (lt16 ? kErfinvLt16 : kErfinvGt16);
  const int terms = lt625 ? 23 : (lt16 ? 19 : 17);
  double p = c[0];
#pragma unroll 1
  for (int i = 1; i < terms; ++i) p = i < 19 ? c[i] + p * t : p * t + c[i];
  return fabs(x) == 1.0 ? x * INFINITY : p * x;
}

// jax.random.normal(sub, (10,), float64)[i]: 64 random bits (the hash of
// the counts (0, i)), their top 52 as a uniform on [nextafter(-1, 0), 1),
// then sqrt(2) erfinv
__device__ __forceinline__ double normal_draw(uint32_t s1, uint32_t s2,
                                              uint32_t i) {
  constexpr double lo = -0x1.fffffffffffffp-1;  // nextafter(-1, 0)
  uint32_t b1, b2;
  threefry(s1, s2, 0u, i, &b1, &b2);
  const unsigned long long mant =
      ((unsigned long long)b1 << 20) | (unsigned long long)(b2 >> 12);
  const double floats = (double)mant * 0x1p-52;
  const double u = jmax(floats * 2.0 + lo, lo);
  return 1.4142135623730951 * erfinv_xla(u);
}

// the 2N5089s' Gummel-Poon currents and the 1N4148's
__device__ __forceinline__ void mel_currents(const double* mc,
                                             const double* vnl, double* i) {
  currents<5, 2>(mc + ML_CUR, vnl, i);
  i[4] = mc[ML_DIODE] * (limexp(vnl[4] / mc[ML_DIODE + 1]) - 1.0);
}

// I − K_corr dI/dV (melange_preamp.newton_jacobian)
__device__ __noinline__ void mel_jacobian(const double* mc, const double* kc,
                                          const double* vnl, double* jac) {
  double top[5], bot[5];
  derivs<5, 2>(mc + ML_DER, vnl, top, bot);
  double val, dval;
  limexp_d(vnl[4] / mc[ML_DIODE + 1], &val, &dval);
  const double g_d = mc[ML_DIODE] * dval / mc[ML_DIODE + 1];
  for (int r = 0; r < 5; ++r) {
    for (int k = 0; k < 4; ++k) {
      const int r0 = 2 * (k / 2);
      jac[r * 5 + k] = (r == k ? 1.0 : 0.0) -
                       (kc[r * 5 + r0] * top[k] + kc[r * 5 + r0 + 1] * bot[k]);
    }
    jac[r * 5 + 4] = (r == 4 ? 1.0 : 0.0) - kc[r * 5 + 4] * g_d;
  }
}

// melange_preamp.step on the melange rows `ms` (MelState); returns
// main − shadow. `scale` is noise_enabled · noise_gain.
__device__ __noinline__ double melange_step(const double* mc, double* ms,
                                            double g, double x,
                                            double scale) {
  constexpr int N = 13, M = 5, NR = 10;
  const int fb = (int)mc[ML_IDX], outn = (int)mc[ML_IDX + 1];
  const int row_in = (int)mc[ML_IDX + 2];
  // the key advances on every step; the noise enters the main row only
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
  const double gprev = ms[MS_GPREV];
  const double sm_k = g / (1.0 + mc[ML_S_FB_FB] * g);
  double v_pred[2][N], p[2][M];
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const double* v = ms + MS_V + N * r;
    double rhs[N], t[N], vpb[N];
    matvec(mc + ML_A_HIST, v, rhs, N, N);
    rhs[fb] = rhs[fb] + (-gprev) * v[fb];
#pragma unroll 1
    for (int n = 0; n < N; ++n) rhs[n] = rhs[n] + mc[ML_WS_W + n];
    rhs[row_in] = rhs[row_in] + (r == 0 ? x : 0.0);
    matvec(mc + ML_N_I, ms + MS_I + M * r, t, N, M);
#pragma unroll 1
    for (int n = 0; n < N; ++n) rhs[n] = rhs[n] + t[n];
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
  // at most 12 Newton iterations; a converged row stays put, and the loop
  // ends once both have (the rest would change nothing)
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
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
  return bad ? 0.0 : out;
}

// the melange rows at the DC point, the key at PRNGKey(0x5EED)
__device__ void init_melange(const double* mc, double* ms) {
  for (int r = 0; r < 2; ++r) {
    for (int n = 0; n < 13; ++n) ms[MS_V + 13 * r + n] = mc[ML_V_DC + n];
    for (int m = 0; m < 5; ++m) {
      ms[MS_I + 5 * r + m] = mc[ML_I_DC + m];
      ms[MS_VNL + 5 * r + m] = mc[ML_V_NL_DC + m];
    }
  }
  ms[MS_GPREV] = 1.0 / 1000000.0;
  ms[MS_KEY] = 0.0;
  ms[MS_KEY + 1] = 24301.0;  // 0x5EED
  for (int r = 0; r < 10; ++r) ms[MS_WPREV + r] = 0.0;
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

// power_amp.behavioral_process: 8 Newton iterations on
// y = f(A(x − βy)), memoryless; output normalised to ±1
__device__ __noinline__ double behavioral(double x) {
  constexpr double A = 19000.0;
  constexpr double beta = 220.0 / (220.0 + 15000.0);
  constexpr double vt_sq = 0.013 * 0.013;
  constexpr double q = 0.1;
  const double clg = A / (1.0 + A * beta);
  double y = jclip(x * clg, -22.0 + 1e-6, 22.0 - 1e-6);
#pragma unroll 1
  for (int it = 0; it < 8; ++it) {
    const double v = A * (x - beta * y);
    const double exp_term = exp(-v * v / vt_sq);
    const double cross_gain = q + (1.0 - q) * (1.0 - exp_term);
    const double v_cross = v * cross_gain;
    const double dcross_dv =
        cross_gain + v * (1.0 - q) * (2.0 * v / vt_sq) * exp_term;
    const double tanh_val = tanh(v_cross / 22.0);
    const double f_val = 22.0 * tanh_val;
    const double f_deriv = (1.0 - tanh_val * tanh_val) * dcross_dv;
    const double residual = y - f_val;
    const double jacobian = 1.0 + A * beta * f_deriv;
    y = y - residual / jacobian;
  }
  return y / 22.0;
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

// speaker.coeffs_for_character: the filters and the polynomial of one
// character at rate sr
struct Speaker {
  Biquad hpf, lpf;
  double a2, a3, thermal_coeff, character;
};

__device__ __noinline__ void speaker_design(double chr, double sr,
                                            Speaker* k) {
  const double cc = jclip(chr, 0.0, 1.0);
  k->hpf = design(false, 20.0 * pow(30.0 / 20.0, cc), 0.75, sr);
  k->lpf = design(true, 20000.0 * pow(5500.0 / 20000.0, cc), 0.707, sr);
  k->a2 = 0.2 * cc;
  k->a3 = 0.6 * cc;
  k->thermal_coeff = 2.0 * cc;
  k->character = cc;
}

// speaker.step on its 5 rows (hpf z1 z2, lpf z1 z2, thermal); alpha the
// thermal smoother's coefficient
__device__ __forceinline__ double speaker_step(const Speaker& k, double* spk,
                                               double x, double alpha) {
  const double x2 = x * x;
  const double shaped = (x + k.a2 * x2 + k.a3 * x2 * x) / (1.0 + k.a2 + k.a3);
  const double limited = k.character < 0.001 ? shaped : tanh(shaped);
  const double thermal = spk[4] + (x2 - spk[4]) * alpha;
  spk[4] = thermal;
  const double tg = 1.0 / (1.0 + k.thermal_coeff * sqrt(thermal));
  const double filtered = biquad(k.hpf, spk, limited * tg);
  return biquad(k.lpf, spk + 2, filtered);
}

// one oversampled step of the nonlinear chain: tremolo → LDR → preamp
// (DK or melange) → power amp (circuit or behavioral)
template <int PRE, int PA>
__device__ __forceinline__ double nonlinear_step(const double* c,
                                                 const double* misc,
                                                 double* ch, double depth,
                                                 double u, bool sag,
                                                 double noise_scale) {
  const double shunt = tremolo_step(c, misc, ch, depth);
  const double g = 1.0 / jmax(shunt, 1000.0);
  double pre;
  if constexpr (PRE == PRE_DK)
    pre = preamp_step(c + C_PRE, ch + CH_PRE_V, g, u);
  else
    pre = melange_step(c + C_MEL, ch + CH_MEL_V, g, u, noise_scale);
  const double drive = 0.25;  // tables.FIXED_CIRCUIT_DRIVE
  if constexpr (PA == PA_CIRCUIT)
    return power_amp_step(c, misc, ch, pre * drive, sag);
  else
    return behavioral(pre * drive);
}

// the whole chain of one base sample (engine.py's render body after the
// voice sum); returns the f64 output before the cast
template <int PRE, int PA>
__device__ __noinline__ double chain_sample(const double* c, double* ch, double mono,
                               bool sag, double noise_scale,
                               double* last_char, Speaker* spk_k) {
  const double* misc = c + C_MISC;
  const double depth = smoother_next(ch + CH_SM_DEPTH);
  const double vol = smoother_next(ch + CH_SM_VOLUME);
  const double chr = smoother_next(ch + CH_SM_CHAR);
  double amp_out;
  if (misc[M_OVERSAMPLE] != 0.0) {
    const double e = branch_step(kBranchA, ch + CH_OS_UP_A, mono);
    const double o = branch_step(kBranchB, ch + CH_OS_UP_B, mono);
    double y[2];
    const double us[2] = {e, o};
#pragma unroll 1
    for (int h = 0; h < 2; ++h)
      y[h] = nonlinear_step<PRE, PA>(c, misc, ch, depth, us[h], sag,
                                     noise_scale);
    const double a = branch_step(kBranchA, ch + CH_OS_DOWN_A, y[0]);
    const double b = branch_step(kBranchB, ch + CH_OS_DOWN_B, y[1]);
    amp_out = (a + ch[CH_OS_DELAY]) * 0.5;
    ch[CH_OS_DELAY] = b;
  } else {
    amp_out = nonlinear_step<PRE, PA>(c, misc, ch, depth, mono, sag,
                                      noise_scale);
  }
  // speaker: coefficients redesigned only when the character moved
  if (__double_as_longlong(chr) != __double_as_longlong(*last_char)) {
    *last_char = chr;
    speaker_design(chr, misc[M_SPK_SR], spk_k);
  }
  double* spk = ch + CH_SPK;
  const double y = speaker_step(*spk_k, spk, amp_out, misc[M_SPK_ALPHA]);
  const double out = y * misc[M_POST_GAIN] * vol;
  if (!finite(out)) {
    // NaN guard #2: preamp (the melange one's noise key and draws
    // included), oversampler, power amp and speaker reset
    for (int k = 0; k < OS_ROWS; ++k) ch[CH_OS_UP_A + k] = 0.0;
    if constexpr (PRE == PRE_DK)
      init_preamp(c + C_PRE, ch + CH_PRE_V);
    else
      init_melange(c + C_MEL, ch + CH_MEL_V);
    init_power_amp(c + C_PA, ch);
    for (int k = 0; k < 5; ++k) spk[k] = 0.0;
    return 0.0;
  }
  return out;
}

template <int PRE, int PA>
__global__ void engine_chain_kernel(const double* __restrict__ c,
                                    const double* __restrict__ mono,
                                    double* chain, float* out, int n,
                                    int sag, double noise_scale) {
  double ch[CHAIN_ROWS];
  for (int k = 0; k < CHAIN_ROWS; ++k) ch[k] = chain[k];
  double last_char = __longlong_as_double(0x7ff8dead0000beefLL);  // NaN
  Speaker spk_k;
  for (int t = 0; t < n; ++t)
    out[t] = (float)chain_sample<PRE, PA>(c, ch, mono[t], sag != 0,
                                          noise_scale, &last_char, &spk_k);
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

// ═══════════════════════════ E5: preamp scan ═══════════════════════════

// a thread per stream, columns of the (rows, G) state; x and out (n, G)
// time major
constexpr int E5_BLOCK = 32;

template <int PRE>
__global__ void __launch_bounds__(E5_BLOCK)
preamp_scan_kernel(const double* __restrict__ c, const double* __restrict__ x,
                   double* state, const double* __restrict__ g_ldr,
                   const double* __restrict__ noise_scale, double* out, int n,
                   int g) {
  constexpr int ROWS = PRE == PRE_DK ? OS_ROWS + PS_ROWS : MS_ROWS;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double s[ROWS];
  for (int k = 0; k < ROWS; ++k) s[k] = state[(size_t)k * g + j];
  const double gl = g_ldr[j];
  const double scale = PRE == PRE_MELANGE ? noise_scale[j] : 0.0;
  for (int t = 0; t < n; ++t) {
    const double xt = x[(size_t)t * g + j];
    double y;
    if constexpr (PRE == PRE_DK) {
      // di.preamp_di: allpass up, the twin DK step twice, allpass down
      const double e = branch_step(kBranchA, s + 0, xt);
      const double o = branch_step(kBranchB, s + 3, xt);
      const double y0 = preamp_step(c, s + OS_ROWS, gl, e);
      const double y1 = preamp_step(c, s + OS_ROWS, gl, o);
      const double a = branch_step(kBranchA, s + 6, y0);
      const double b = branch_step(kBranchB, s + 9, y1);
      y = (a + s[12]) * 0.5;
      s[12] = b;
    } else {
      y = melange_step(c, s, gl, xt, scale);
    }
    out[(size_t)t * g + j] = y;
  }
  for (int k = 0; k < ROWS; ++k) state[(size_t)k * g + j] = s[k];
}

// ═══════════════════════ E6: power amp and speaker ═══════════════════════

// run_calibrate's T5, a thread per stream: x · volume · volume → the power
// amp (the chain's step, rail sag on) → the speaker (its filters designed
// once, from `character`) → × POST_SPEAKER_GAIN. No smoothers, no NaN
// guard, no volume after the speaker. The constants have the chain's
// layout (C_PA, C_MISC; the tremolo and preamp blocks unused); the state
// (E6_ROWS, G) holds the chain's rows CH_PA_V .. CH_SPK + 4 of each stream.
constexpr int E6_BLOCK = 32;
constexpr int E6_ROWS = CH_SPK + 5 - CH_PA_V;

__global__ void __launch_bounds__(E6_BLOCK)
pa_speaker_scan_kernel(const double* __restrict__ c,
                       const double* __restrict__ x, double* state,
                       double* out, int n, int g, double volume,
                       double character) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= g) return;
  double ch[CHAIN_ROWS];  // only the power amp's and the speaker's rows
  for (int k = 0; k < E6_ROWS; ++k) ch[CH_PA_V + k] = state[(size_t)k * g + j];
  const double* misc = c + C_MISC;
  Speaker spk;
  speaker_design(character, misc[M_SPK_SR], &spk);
  for (int t = 0; t < n; ++t) {
    const double xt = x[(size_t)t * g + j] * volume * volume;
    const double y = power_amp_step(c, misc, ch, xt, true);
    const double z = speaker_step(spk, ch + CH_SPK, y, misc[M_SPK_ALPHA]);
    out[(size_t)t * g + j] = z * misc[M_POST_GAIN];
  }
  for (int k = 0; k < E6_ROWS; ++k) state[(size_t)k * g + j] = ch[CH_PA_V + k];
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

extern "C" int ow_voice_render(const double* vpar, double* vst,
                               long long* vsti, double* out, int g, int n,
                               cudaStream_t stream) {
  if (g < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  voice_render_kernel<false>
      <<<(g + E4_BLOCK - 1) / E4_BLOCK, E4_BLOCK, 0, stream>>>(
          vpar, vst, vsti, out, nullptr, g, n);
  return (int)cudaGetLastError();
}

extern "C" int ow_voice_render_tap(const double* vpar, double* vst,
                                   long long* vsti, double* out,
                                   double* reed, int g, int n,
                                   cudaStream_t stream) {
  if (g < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  voice_render_kernel<true>
      <<<(g + E4_BLOCK - 1) / E4_BLOCK, E4_BLOCK, 0, stream>>>(
          vpar, vst, vsti, out, reed, g, n);
  return (int)cudaGetLastError();
}

extern "C" int ow_pa_speaker_scan(const double* consts, int n_consts,
                                  const double* x, double* state,
                                  double* out, int n, int g, double volume,
                                  double character, cudaStream_t stream) {
  if (n_consts != C_TOTAL || n < 0 || g < 0)
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  pa_speaker_scan_kernel<<<(g + E6_BLOCK - 1) / E6_BLOCK, E6_BLOCK, 0,
                           stream>>>(consts, x, state, out, n, g, volume,
                                     character);
  return (int)cudaGetLastError();
}

extern "C" int ow_engine_chain(const double* consts, int n_consts,
                               const double* mono, double* chain, float* out,
                               int n, int rail_sag, int pre_model,
                               int pa_model, double noise_scale,
                               cudaStream_t stream) {
  const int want = C_TOTAL + (pre_model == PRE_MELANGE ? ML_SIZE : 0);
  if (n_consts != want || n < 0 || pre_model < 0 || pre_model > 1 ||
      pa_model < 0 || pa_model > 1)
    return (int)cudaErrorInvalidValue;
  if (pre_model == PRE_DK && pa_model == PA_CIRCUIT)
    engine_chain_kernel<PRE_DK, PA_CIRCUIT><<<1, 1, 0, stream>>>(
        consts, mono, chain, out, n, rail_sag, noise_scale);
  else if (pre_model == PRE_DK)
    engine_chain_kernel<PRE_DK, PA_BEHAVIORAL><<<1, 1, 0, stream>>>(
        consts, mono, chain, out, n, rail_sag, noise_scale);
  else if (pa_model == PA_CIRCUIT)
    engine_chain_kernel<PRE_MELANGE, PA_CIRCUIT><<<1, 1, 0, stream>>>(
        consts, mono, chain, out, n, rail_sag, noise_scale);
  else
    engine_chain_kernel<PRE_MELANGE, PA_BEHAVIORAL><<<1, 1, 0, stream>>>(
        consts, mono, chain, out, n, rail_sag, noise_scale);
  return (int)cudaGetLastError();
}

extern "C" int ow_preamp_scan(int kind, const double* consts, int n_consts,
                              const double* x, double* state,
                              const double* g_ldr, const double* noise_scale,
                              double* out, int n, int g,
                              cudaStream_t stream) {
  if (n < 0 || g < 0 || kind < 0 || kind > 1 ||
      n_consts != (kind == PRE_DK ? PR_J_CIN_DC + 1 : ML_SIZE))
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const int blocks = (g + E5_BLOCK - 1) / E5_BLOCK;
  if (kind == PRE_DK)
    preamp_scan_kernel<PRE_DK><<<blocks, E5_BLOCK, 0, stream>>>(
        consts, x, state, g_ldr, noise_scale, out, n, g);
  else
    preamp_scan_kernel<PRE_MELANGE><<<blocks, E5_BLOCK, 0, stream>>>(
        consts, x, state, g_ldr, noise_scale, out, n, g);
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
