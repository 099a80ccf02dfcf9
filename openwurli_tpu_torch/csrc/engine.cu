// The f64 kernels of the engine (openwurli_tpu_torch/kernels/engine.py)
// and of the offline render paths (openwurli_tpu_torch/kernels/render.py):
//
//   E1 engine_voices      the 64 main + 64 steal voice slots over one chunk,
//                         of B engines: a cluster of eight blocks per
//                         engine, eight threads per slot, up to the
//                         wrapper's crossover, a thread per slot above
//                         (its libm behind warp votes)
//   E2 engine_chain       the mono chain over that chunk, of B engines, a
//                         template over the preamp (DK or melange) and the
//                         power amp (circuit or behavioral): a warp per
//                         engine, a half-warp per engine (two engines to a
//                         warp) or a thread per engine, in the wrapper's
//                         bands of width
//   E3 tremolo_settle     the tremolo oscillator's step, n times, on one
//                         warp
//   E4 voice_render       G voices over n samples (voice.render), eight
//                         threads per voice; with TAP, the reed alone into
//                         the pickup, the reed's output kept
//                         (calibrate.run_calibrate's T1, T2)
//   E5 preamp_scan        G preamp streams over n samples, a warp per
//                         stream: the DI path's 2x-oversampled DK preamp,
//                         or the melange preamp
//   E6 pa_speaker_scan    G streams over n samples, a warp per stream:
//                         volume², the power amp with rail sag, the
//                         speaker, the post-speaker gain
//                         (calibrate.run_calibrate's T5)
//   E7 dk_scan            G streams over n samples of the twin DK preamp
//                         at the input's rate, a warp per stream, each
//                         sample at its own LDR resistance: the CLI's
//                         gain, harmonics and pump measurements
//   E8 tremolo_scan       G tremolo circuits over n steps at the
//                         tremolo's own rate, a warp per circuit: the
//                         oscillator, the vactrol and the divider's shunt
//                         at a depth per circuit
//                         (tools/torch_stage_bench.py's "tremolo")
//   E9 power_amp_scan     G power-amp streams over n samples at the input's
//                         rate, rail sag on, a warp per stream (the stage
//                         bench's "power amp")
//
// Replaces: the reference's jitted lax.scans of its float64 engine
// (openwurli_tpu/engine.py:452 `_render`), of its tremolo settle
// (openwurli_tpu/circuits/tremolo.py:160), of voice.render
// (openwurli_tpu/voice.py:140), of di.preamp_di (openwurli_tpu/di.py:29),
// of the melange preamp's step
// (openwurli_tpu/circuits/melange_preamp.py:177) and of run_calibrate's tap
// scans (openwurli_tpu/calib/calibrate.py:80-138) and of the CLI's DK
// measurement scans (openwurli_tpu/cli.py:34-63, :87-118, :388-417) and of
// the stage benchmark's tremolo and power-amp scans
// (tools/stage_bench.py:82-83); none is a Pallas kernel.
//
// Bound: latency. A chunk is a serial recurrence: E1 and E4 advance each
// voice (slot) by eight threads (its seven modes on threads, then its
// group's samples on threads; E1 a cluster of eight blocks per engine, and
// a thread per slot above its crossover, where a full card's throughput
// favours one thread per voice), every other kernel each stream, circuit
// or engine through the data-dependent Newton solves sample by sample.
// The bytes are a few
// hundred per sample and the operations some 10^4-10^5 f64 per base
// sample, far from the card's rates; what bounds the time is the length of
// the dependent chain of f64 operations and libm calls per sample. E6, E9,
// E3, E8 and E2's circuit instantiations shorten that chain with a warp per
// stream, settle, circuit or engine (mna_step_warp: the rows of every matvec, BJT,
// Jacobian row, pivot update and junction limit on their own lanes, the
// solver block staged in shared memory, no local memory in the solve);
// E5<melange> and E2<melange, *> run the melange preamp's step on a
// warp too (melange_step_warp: the twins on the two half-warps, the ten
// noise draws at once, the block staged in shared memory), and E5<dk>, E7
// and E2<dk, *> the DK preamp's (dk_step_warp: the twins on the two
// half-warps, each junction's exp on a lane of its own). At width E2 runs
// the same steps on half-warps, two engines to a warp, whose lanes the
// warp form leaves idle (engine_chain_half_kernel), or a thread per engine
// (32 engines per warp; the behavioral instantiations with every value of
// a step in registers and the engine's rows in shared memory). The design takes two exact savings: each Newton loop
// ends once every row has converged (the masked iterations of the
// reference change nothing), and E2 reuses the
// speaker's coefficients while the character is unchanged.
//
// Every kernel equals its plain torch version bit for bit: compiled with
// -fmad=false, sums in the plain version's index order, every max/min/clip
// a select that keeps NaN (jmax/jmin below, exact.maximum in the plain
// version), and the f32 Newton elimination with each update rounded once
// from double (mna.ge_solve_numpy). The melange preamp's noise is JAX's
// threefry2x32 stream (integer, exact) through XLA's erfinv polynomial,
// written op for op in prng.normal_f64.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int MAXV = 64;
constexpr int SLOTS = 128;
constexpr int NM = 7;

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
constexpr unsigned FULL = 0xffffffffu;

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

// One voice on one thread: Voice, voice_load / voice_store and
// voice_sample: E1's thread form (above the wrapper's crossover), and E4
// as it ran before its lane redesign (tools/voice_breakdown.cu's
// one-thread oracle); E4 and E1's cluster form run VoiceLanes below.

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

// voice_sample with its libm calls behind warp votes (VoiceLanes' rule),
// E1's thread form: cos, pow, exp, sqrt and tanh run only where a voice
// (`valid`) of the warp selects their value, and the attack noise only
// where one is in its burst; every multiply and add stays, so NaN and inf
// voices keep their bits (tools/voice_breakdown.cu holds it to
// voice_sample bit for bit). Every thread of the warp takes each vote.

// hammer.noise_step with the fade's cos only where a voice of the warp is
// in its burst and its fade, and nothing where none is in its burst
__device__ __forceinline__ double noise_sample_guarded(Voice& v,
                                                       bool valid) {
  const bool active = v.nrem > 0;
  if (!__any_sync(FULL, valid && active)) return 0.0;
  const bool in_fade = v.nfade > 0;
  double nenv = 1.0;
  if (__any_sync(FULL, valid && active && in_fade)) {
    const double tf = (double)(16 - v.nfade) / 16.0;
    nenv = in_fade ? 0.5 * (1.0 - cos(M_PI * tf)) : 1.0;
  }
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

template <bool TAP>
__device__ __forceinline__ double voice_sample_guarded(Voice& v,
                                                       double* reed_tap,
                                                       bool valid) {
  const double rel = v.dact ? v.dcount + 1.0 : v.dcount;
  const bool past = rel > v.dramp;
  const bool in_ramp = v.dact && !v.ddone && !past;
  const bool done2 = v.ddone || (v.dact && past);
  const bool damp = __any_sync(FULL, valid && in_ramp);
  const double ratio = damp ? rel / jmax(v.dramp, 1e-30) : 0.0;
  for (int k = 0; k < NM; ++k) {
    double f = 1.0;
    if (damp) {
      const double inst = v.drate[k] * ratio;
      f = in_ramp ? exp(-inst) : 1.0;
    }
    v.env[k] = v.env[k] * f;
    v.env[k] = v.env[k] * ((v.dact && done2) ? v.dmult[k] : 1.0);
  }
  const bool ramping = (double)v.nn < v.ramp_n;
  double onset = 1.0;
  if (__any_sync(FULL, valid && ramping)) {
    const double cosine = 0.5 * (1.0 - cos((double)v.nn * v.ramp_inc));
    const bool lin = v.shape <= 1.001, sq = v.shape >= 1.999;
    double pw = 0.0;
    if (__any_sync(FULL, valid && ramping && !lin && !sq))
      pw = pow(jmax(cosine, 0.0), v.shape);
    const double shaped = lin ? cosine : sq ? cosine * cosine : pw;
    onset = ramping ? shaped : 1.0;
  }
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
  const bool any_renorm = __any_sync(FULL, valid && renorm);
  for (int k = 0; k < NM; ++k) {
    const double dp = v.drift[k] * v.phase_inc[k];
    const double ci = v.cos_inc[k] - dp * v.sin_inc[k];
    const double si = v.sin_inc[k] + dp * v.cos_inc[k];
    const double s_new = v.s[k] * ci + v.c[k] * si;
    const double c_new = v.c[k] * ci - v.s[k] * si;
    v.env[k] = v.env[k] * v.decay[k];
    double scale = 1.0;
    if (any_renorm)
      scale = renorm ? 1.0 / sqrt(s_new * s_new + c_new * c_new) : 1.0;
    v.s[k] = s_new * scale;
    v.c[k] = c_new * scale;
  }
  v.nn += 1;
  v.dcount = rel;
  v.ddone = done2;

  double yy;
  if constexpr (TAP) {
    *reed_tap = reed_out;
    yy = reed_out * v.ds;
  } else {
    const double noise_out = noise_sample_guarded(v, valid);
    yy = (reed_out + noise_out) * v.ds;
  }
  const double ay = fabs(yy);
  double ys = yy;
  if (__any_sync(FULL, valid && !(ay < 0.94))) {
    const double rng = 0.98 - 0.94;
    const double sat = 0.94 + rng * tanh((ay - 0.94) / rng);
    if (!(ay < 0.94)) ys = yy >= 0.0 ? sat : -sat;
  }
  const double omy = 1.0 - ys;
  const double alpha = v.beta * omy;
  v.q = (v.q * (1.0 - alpha) + 2.0 * v.beta) / (1.0 + alpha);
  if constexpr (TAP) return (v.q * omy - 1.0) * 1.8375;
  return (v.q * omy - 1.0) * 1.8375 * v.gain;
}

// E4: eight threads per voice, four voices per warp (K1's design in f64).
// out (n, G) time major; with TAP, reed (n, G) gets the reed's samples.
//  * Modes on threads: thread m < 7 of a voice owns mode m (its s, c, env,
//    drift and constants) and advances it through an 8-sample group,
//    sample by sample: the damper, the jitter tick (its draw, the voice's
//    LCG word stepped m + 1 times, by an exact jump-ahead mod 2^32), the
//    term's share amp·s and env into the warp's scratch, the rotation, the
//    decay and the renorm. Thread 7 runs mode 6's arithmetic into a row
//    that nobody reads and stores nothing of it.
//  * Samples on threads: thread j computes sample j's onset, then, after a
//    __syncwarp, sums its seven terms (amp·s)·onset·env in index order.
//  * The serial tail on every thread of the voice: the attack noise over
//    the group (its fade for sample j taken ahead by thread j, read by a
//    shuffle), then each thread's saturation and charge factors for its
//    sample, published, and the charge recurrence over the group, each
//    thread keeping sample j's charge; thread j stores sample j.
// The voice's own counters (nn, the damper's, the jitter and noise words,
// the charge) advance alike on its eight threads. cos, pow, exp, sqrt and
// tanh run only on the path whose value is selected, and a warp takes
// such a path for all its voices when one needs it (a vote); every
// multiply and add of voice_sample stays, the env · 1.0 of an unselected
// damper among them, so NaN and inf voices keep their bits. A warp whose
// voices all lie past G returns; in any other warp every thread takes part
// in every sync, shuffle and vote, and threads of voices past G load and
// store nothing.
constexpr int E4_TPV = 8;        // threads per voice
constexpr int E4_GROUP = 8;      // samples per group
constexpr int E4_MAX_BLOCK = 128;
// threads per block in ow_voice_render*: as fast as 32 at 512 voices
// (tools/torch_voice_breakdown.py), and a block's E4Scratch serves four
// warps, where a block of 32 would hold it for one
constexpr int E4_BLOCK = 128;
// scratch rows: 8 (7 modes, a padding row) × 8 samples per voice, padded
constexpr int E4_ROW = E4_GROUP + 1, E4_VOICE = E4_TPV * E4_ROW;
struct E4Scratch {
  double share[4 * E4_VOICE], env[4 * E4_VOICE];  // amp·s, env
  double pn[4][E4_GROUP], den[4][E4_GROUP];        // 1 − α, 1 + α
};
// the jitter LCG stepped k + 1 times: A^(k+1) · s + C_(k+1) mod 2^32
__constant__ uint32_t kJitterA[NM] = {
    1664525u, 389569705u, 2940799637u, 158984081u, 2862450781u,
    3211393721u, 1851289957u};
__constant__ uint32_t kJitterC[NM] = {
    1013904223u, 1196435762u, 3519870697u, 2868466484u, 1649599747u,
    2670642822u, 1476291629u};

// Variants for tools/voice_breakdown.cu; the library builds VARIANT = 0.
enum : int {
  E4_STAGED = 1,  // exact: a block's rows stored whole through shared memory
  E4_STAMPED = 2  // exact: each part's cycles (clock64) into parts (4, G)
};
enum E4Part { E4P_MODES, E4P_SUM, E4P_TAIL, E4P_STORE, E4_PARTS };

// One voice on each of its eight threads (E4 and E1): thread k holds mode
// km's constants and state (km = min(k, 6)) and the voice's own, which
// advance alike on the eight threads.
template <bool TAP>
struct VoiceLanes {
  // mode km
  double cos_inc, sin_inc, phase_inc, amp, decay, drate, dmult;
  double s, c, env, drift;
  uint32_t jit_a, jit_c, jit_a7, jit_c7;
  // the voice
  double ramp_n, ramp_inc, shape, revert, diffusion, beta, ds, dramp;
  bool dact;
  double dcount, q;
  long long jst, nn;
  bool ddone;
  // the attack noise and the post-pickup gain (not with TAP)
  double ndecay, b0, b1, b2, a1, a2, gain, namp, z1, z2;
  long long nrem, nfade, nrng;

  // voice j's column of the packed rows, `stride` columns per row; a
  // thread of no voice (valid false) loads zeros
  __device__ __forceinline__ void load(const double* vpar, const double* vst,
                                       const long long* vsti, size_t stride,
                                       int j, bool valid, int km) {
    auto PAR = [&](int r) { return valid ? vpar[(size_t)r * stride + j] : 0.0; };
    auto ST = [&](int r) { return valid ? vst[(size_t)r * stride + j] : 0.0; };
    auto STI = [&](int r) { return valid ? vsti[(size_t)r * stride + j] : 0LL; };
    cos_inc = PAR(P_COS + km);
    sin_inc = PAR(P_SIN + km);
    phase_inc = PAR(P_PHASE + km);
    amp = PAR(P_AMP + km);
    decay = PAR(P_DECAY + km);
    drate = ST(S_DRATE + km);
    dmult = ST(S_DMULT + km);
    s = ST(S_S + km);
    c = ST(S_C + km);
    env = ST(S_ENV + km);
    drift = ST(S_DRIFT + km);
    jit_a = kJitterA[km];
    jit_c = kJitterC[km];
    jit_a7 = kJitterA[NM - 1];
    jit_c7 = kJitterC[NM - 1];
    ramp_n = PAR(P_RAMP_N);
    ramp_inc = PAR(P_RAMP_INC);
    shape = PAR(P_SHAPE);
    revert = PAR(P_REVERT);
    diffusion = PAR(P_DIFF);
    beta = PAR(P_BETA);
    ds = PAR(P_DS);
    dramp = ST(S_DRAMP);
    dact = STI(I_DACT) != 0;
    dcount = ST(S_DCOUNT);
    q = ST(S_Q);
    jst = STI(I_JST);
    nn = STI(I_N);
    ddone = STI(I_DDONE) != 0;
    ndecay = b0 = b1 = b2 = a1 = a2 = gain = namp = z1 = z2 = 0.0;
    nrem = nfade = nrng = 0;
    if constexpr (!TAP) {
      ndecay = PAR(P_NDECAY);
      b0 = PAR(P_BPF);
      b1 = PAR(P_BPF + 1);
      b2 = PAR(P_BPF + 2);
      a1 = PAR(P_BPF + 3);
      a2 = PAR(P_BPF + 4);
      gain = PAR(P_GAIN);
      namp = ST(S_NAMP);
      z1 = ST(S_Z1);
      z2 = ST(S_Z2);
      nrem = STI(I_NREM);
      nfade = STI(I_NFADE);
      nrng = STI(I_NRNG);
    }
  }

  // one group of cnt <= E4_GROUP samples, on thread k = lane % 8 of the
  // warp's voice lane / 8, w the warp's scratch; → sample k's output (the
  // post-pickup gain applied, unless TAP) and its reed output in
  // *reed_out. stamp(part) closes a part's time (E4_STAMPED).
  template <class Stamp>
  __device__ __forceinline__ double group(E4Scratch& w, int lane, int cnt,
                                          bool valid, double* reed_out,
                                          Stamp&& stamp) {
    const int wv = lane / E4_TPV;  // the voice within the warp
    const int k = lane % E4_TPV;   // mode k (7: padding); sample k
    double* const share_row = w.share + wv * E4_VOICE + k * E4_ROW;
    double* const env_row = w.env + wv * E4_VOICE + k * E4_ROW;
    const double* const share_col = w.share + wv * E4_VOICE + k;
    const double* const env_col = w.env + wv * E4_VOICE + k;
    const bool mine = valid && k < cnt;  // sample k is this group's
    // ── sample k's onset and (E4) its noise fade, ahead of the modes
    const long long nk = nn + k;
    const bool ramping = (double)nk < ramp_n;
    double onset = 1.0;
    if (__any_sync(FULL, mine && ramping)) {
      const double cosine = 0.5 * (1.0 - cos((double)nk * ramp_inc));
      const bool lin = shape <= 1.001, sq = shape >= 1.999;
      double pw = 0.0;
      if (__any_sync(FULL, mine && ramping && !lin && !sq))
        pw = pow(jmax(cosine, 0.0), shape);
      const double shaped = lin ? cosine : sq ? cosine * cosine : pw;
      onset = ramping ? shaped : 1.0;
    }
    double nenv = 1.0;
    if constexpr (!TAP) {
      // sample k is in the burst while k < nrem; nfade counts down from
      // the group's start once per sample in the burst
      const long long nf = nfade > 0 ? nfade - (k < nfade ? k : nfade)
                                     : nfade;
      const bool in_fade = nf > 0;
      if (__any_sync(FULL, mine && k < nrem && in_fade)) {
        const double tf = (double)(16 - nf) / 16.0;
        nenv = in_fade ? 0.5 * (1.0 - cos(M_PI * tf)) : 1.0;
      }
    }
    stamp(E4P_SUM);

    // ── modes on threads: mode km through the group's samples
    for (int i = 0; i < cnt; ++i) {
      const long long ni = nn + i;
      const double rel = dact ? dcount + 1.0 : dcount;
      const bool past = rel > dramp;
      const bool in_ramp = dact && !ddone && !past;
      const bool done2 = ddone || (dact && past);
      double damp = 1.0;
      if (__any_sync(FULL, valid && in_ramp)) {
        const double ratio = rel / jmax(dramp, 1e-30);
        const double inst = drate * ratio;
        damp = in_ramp ? exp(-inst) : 1.0;
      }
      env = env * damp;
      env = env * ((dact && done2) ? dmult : 1.0);
      if ((ni & 15) == 0) {
        const uint32_t js = (uint32_t)jst;
        const uint32_t draw = jit_a * js + jit_c;
        const double u = (double)(draw >> 1) / 2147483647.5;
        const double nz = (u * 2.0 - 1.0) * 1.7320508080;
        drift = revert * drift + diffusion * nz;
        jst = (long long)(jit_a7 * js + jit_c7);
      }
      share_row[i] = amp * s;
      env_row[i] = env;
      const bool renorm = ((ni & 1023) == 0) && ni > 0;
      const double dp = drift * phase_inc;
      const double ci = cos_inc - dp * sin_inc;
      const double si = sin_inc + dp * cos_inc;
      const double s_new = s * ci + c * si;
      const double c_new = c * ci - s * si;
      env = env * decay;
      double scale = 1.0;
      if (__any_sync(FULL, valid && renorm))
        scale = renorm ? 1.0 / sqrt(s_new * s_new + c_new * c_new) : 1.0;
      s = s_new * scale;
      c = c_new * scale;
      dcount = rel;
      ddone = done2;
    }
    nn += cnt;
    __syncwarp();
    stamp(E4P_MODES);

    // ── samples on threads: sample k's reed output, modes in index order
    double reed = share_col[0] * onset * env_col[0];
#pragma unroll
    for (int m = 1; m < NM; ++m)
      reed = reed + share_col[m * E4_ROW] * onset * env_col[m * E4_ROW];
    *reed_out = reed;
    stamp(E4P_SUM);

    // ── the attack noise, serial over the group on every thread
    double yy;
    if constexpr (TAP) {
      yy = reed * ds;
    } else {
      double noise_out = 0.0;
      if (__any_sync(FULL, valid && nrem > 0)) {
        for (int i = 0; i < cnt; ++i) {
          const double ne = __shfl_sync(FULL, nenv, (lane & ~7) | i);
          const bool active = nrem > 0;
          const bool in_fade = nfade > 0;
          const long long r = lcg(nrng);
          const double noise =
              (double)(r >= 2147483648LL ? r - 4294967296LL : r) /
              2147483647.0;
          const double y = b0 * noise + z1;
          const double nz1 = b1 * noise - a1 * y + z2;
          const double nz2 = b2 * noise - a2 * y;
          const double o = active ? namp * ne * y : 0.0;
          noise_out = i == k ? o : noise_out;
          if (active) {
            namp = namp * ndecay;
            nrem = nrem - 1;
            if (in_fade) nfade = nfade - 1;
            z1 = nz1;
            z2 = nz2;
            nrng = r;
          }
        }
      }
      yy = (reed + noise_out) * ds;
    }
    // ── the pickup: sample k's saturation and charge factors, then the
    // charge recurrence over the group on every thread
    const double ay = fabs(yy);
    double ys = yy;
    if (__any_sync(FULL, mine && !(ay < 0.94))) {
      const double rng = 0.98 - 0.94;
      const double sat = 0.94 + rng * tanh((ay - 0.94) / rng);
      if (!(ay < 0.94)) ys = yy >= 0.0 ? sat : -sat;
    }
    const double omy = 1.0 - ys;
    const double alpha = beta * omy;
    w.pn[wv][k] = 1.0 - alpha;
    w.den[wv][k] = 1.0 + alpha;
    __syncwarp();
    double q_k = q;
    for (int i = 0; i < cnt; ++i) {
      q = (q * w.pn[wv][i] + 2.0 * beta) / w.den[wv][i];
      q_k = i == k ? q : q_k;
    }
    double y_out = (q_k * omy - 1.0) * 1.8375;
    if constexpr (!TAP) y_out = y_out * gain;
    stamp(E4P_TAIL);
    return y_out;
  }

  // the state rows a group moves, into voice j's column: the mode rows
  // from their threads (k < 7), the voice's from thread 7
  __device__ __forceinline__ void store(double* vst, long long* vsti,
                                        size_t stride, int j, int k) const {
#define STW(r) vst[(size_t)(r) * stride + j]
#define STIW(r) vsti[(size_t)(r) * stride + j]
    if (k < NM) {
      STW(S_S + k) = s;
      STW(S_C + k) = c;
      STW(S_ENV + k) = env;
      STW(S_DRIFT + k) = drift;
    } else {
      STW(S_DCOUNT) = dcount;
      STW(S_Q) = q;
      STIW(I_JST) = jst;
      STIW(I_N) = nn;
      STIW(I_DDONE) = ddone ? 1 : 0;
      if constexpr (!TAP) {
        STW(S_NAMP) = namp;
        STW(S_Z1) = z1;
        STW(S_Z2) = z2;
        STIW(I_NREM) = nrem;
        STIW(I_NFADE) = nfade;
        STIW(I_NRNG) = nrng;
      }
    }
#undef STW
#undef STIW
  }
};

template <bool TAP, int VARIANT = 0>
__global__ void __launch_bounds__(E4_MAX_BLOCK)
voice_lanes_kernel(const double* __restrict__ vpar, double* vst,
                   long long* vsti, double* out, double* reed, int g, int n,
                   long long* parts) {
  constexpr bool STAGED = VARIANT & E4_STAGED;
  constexpr bool STAMPED = VARIANT & E4_STAMPED;
  __shared__ E4Scratch scratch[E4_MAX_BLOCK / 32];
  __shared__ double staged[STAGED ? (TAP ? 2 : 1) * E4_MAX_BLOCK : 1];
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  // A warp whose voices all lie past g has nothing to do.
  if (!STAGED && (gt & ~31) / E4_TPV >= g) return;
  const int lane = threadIdx.x & 31;
  const int k = lane % E4_TPV;   // mode k (7: padding); sample k
  const int j = gt / E4_TPV;     // the voice
  const bool valid = j < g;
  E4Scratch& w = scratch[threadIdx.x >> 5];
  VoiceLanes<TAP> v;
  v.load(vpar, vst, vsti, g, j, valid, k < NM ? k : NM - 1);

  long long acc[E4_PARTS] = {0, 0, 0, 0};
  long long t_clk = 0;
  auto stamp = [&](int part) {
    if constexpr (STAMPED) {
      const long long now = clock64();
      acc[part] += now - t_clk;
      t_clk = now;
    }
  };
  if constexpr (STAMPED) t_clk = clock64();

  for (int t0 = 0; t0 < n; t0 += E4_GROUP) {
    const int cnt = min(E4_GROUP, n - t0);
    const bool mine = valid && k < cnt;  // sample k is this group's
    double reed_out;
    const double y_out = v.group(w, lane, cnt, valid, &reed_out, stamp);

    // ── stores: sample k of voice j
    if constexpr (STAGED) {
      // the block's voices × the group's samples through shared memory,
      // each row's voices stored contiguously
      const int vb = blockDim.x / E4_TPV;
      staged[k * vb + threadIdx.x / E4_TPV] = y_out;
      if constexpr (TAP)
        staged[E4_MAX_BLOCK + k * vb + threadIdx.x / E4_TPV] = reed_out;
      __syncthreads();
      const int row = threadIdx.x / vb, col = threadIdx.x % vb;
      const int jv = blockIdx.x * vb + col;
      if (jv < g && row < cnt) {
        out[(size_t)(t0 + row) * g + jv] = staged[row * vb + col];
        if constexpr (TAP)
          reed[(size_t)(t0 + row) * g + jv] =
              staged[E4_MAX_BLOCK + row * vb + col];
      }
      __syncthreads();
    } else if (mine) {
      out[(size_t)(t0 + k) * g + j] = y_out;
      if constexpr (TAP) reed[(size_t)(t0 + k) * g + j] = reed_out;
    }
    stamp(E4P_STORE);
  }

  if (!valid) return;
  v.store(vst, vsti, g, j, k);
  if constexpr (STAMPED)
    if (k == 0)
      for (int p = 0; p < E4_PARTS; ++p) parts[(size_t)p * g + j] = acc[p];
}

// E4's launch: blocks of `block` threads (a multiple of 32), a warp at
// least, eight threads per voice
template <bool TAP, int VARIANT = 0>
int launch_voice_lanes(const double* vpar, double* vst, long long* vsti,
                       double* out, double* reed, int g, int n,
                       long long* parts, int block, cudaStream_t stream) {
  if (g < 0 || n < 0 || g > (1 << 27) || block <= 0 || block % 32 ||
      block > E4_MAX_BLOCK)
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const int threads = g * E4_TPV;
  const int warps = (threads + 31) / 32;
  const int t = warps * 32 < block ? warps * 32 : block;
  voice_lanes_kernel<TAP, VARIANT><<<(threads + t - 1) / t, t, 0, stream>>>(
      vpar, vst, vsti, out, reed, g, n, parts);
  return (int)cudaGetLastError();
}

// E1's cluster form, up to the wrapper's crossover (kernels/engine.py
// VOICES_LANES_MAX_ENGINES): a cluster of E1_CLUSTER blocks per engine,
// eight threads per voice slot (E4's lanes and group body,
// VoiceLanes<false>), 16 slots to a block of 128 threads: block r of
// engine b's cluster runs slots 16r .. 16r + 15 (ranks 0-3 the main
// slots, 4-7 the steal slots); the engine's tensors
// are rows b of vpar (B, NPAR, SLOTS), vst, vsti, eng_i (B, ENG_I) and mono
// (B, n). Per 8-sample group, after E4's body:
//  * the gates and NaN guard #1 on the slot's eight threads, sample k on
//    thread k: a main slot passes its output while its gate is set, a
//    steal slot its output times its fade (gate − k) / fade_len while that
//    is positive; the first sample that is not finite is bad, found by a
//    ballot over the slot's threads, and ends the slot's gate; it and
//    every later sample of the group pass 0;
//  * each gated sample into the leader block's tile (distributed shared
//    memory), a flag per sample where any slot was bad;
//  * one cluster barrier, then on the leader's first eight threads the
//    slot sum of sample k in index order, mono = (main slots 0..63) +
//    (steal slots 64..127), and the fires. The tile is double buffered,
//    so a group's writes never meet the sum of the group before.
// The chunk-end cleanup's `quiet` is a vote over the slot's mode threads.
// Every multiply, add and select is the thread form's, so mono, the slot
// states and the fire count are its bits.
constexpr int E1_CLUSTER = 8;                    // blocks per engine
constexpr int E1_SLOTS = SLOTS / E1_CLUSTER;     // slots per block
constexpr int E1_BLOCK = E1_SLOTS * E4_TPV;      // threads per block
static_assert(MAXV % E1_SLOTS == 0, "a block's slots all main or all steal");
// the leader's tile: per buffer, the group's samples of every slot, and
// whether any slot was bad in each sample
struct E1Tile {
  double g[2][E4_GROUP][SLOTS];
  int bad[2][E4_GROUP];
};
// Knock-outs for tools/voice_breakdown.cu, timed only (not exact); the
// library builds VARIANT = 0.
enum : int {
  E1_NO_SUM = 1,      // the leader sums nothing: mono is not written
  E1_NO_CLUSTER = 2   // no tile, no cluster barrier, no sum: blocks alone
};

template <int VARIANT = 0>
__global__ void __cluster_dims__(E1_CLUSTER, 1, 1) __launch_bounds__(E1_BLOCK)
engine_voices_kernel(const double* __restrict__ vpar, double* vst,
                     long long* vsti, long long* eng_i, double* mono, int n,
                     double fade_len, double sample_rate) {
  constexpr bool CLUSTER = !(VARIANT & E1_NO_CLUSTER);
  constexpr bool SUM = CLUSTER && !(VARIANT & E1_NO_SUM);
  __shared__ E4Scratch scratch[E1_BLOCK / 32];
  __shared__ E1Tile tile;  // the leader's serves the cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const size_t e = blockIdx.x / E1_CLUSTER;
  vpar += e * NPAR * SLOTS;
  vst += e * NST * SLOTS;
  vsti += e * NSTI * SLOTS;
  eng_i += e * ENG_I;
  mono += e * (size_t)n;
  const int lane = threadIdx.x & 31;
  const int k = lane % E4_TPV;  // mode k (7: padding); sample k
  const int j = rank * E1_SLOTS + (int)threadIdx.x / E4_TPV;  // the slot
  const bool main_slot = j < MAXV;
  const unsigned slot_bits = 0xffu << (lane & ~7);
  E4Scratch& w = scratch[threadIdx.x >> 5];
  VoiceLanes<false> v;
  v.load(vpar, vst, vsti, SLOTS, j, true, k < NM ? k : NM - 1);
  long long gate = eng_i[j];  // slot state (main) or steal fade (steal)
  E1Tile* const lead = cluster.map_shared_rank(&tile, 0);
  if (rank == 0 && threadIdx.x < 2 * E4_GROUP)
    tile.bad[threadIdx.x / E4_GROUP][threadIdx.x % E4_GROUP] = 0;
  long long fires = 0;  // the leader's first eight threads
  if constexpr (CLUSTER) cluster.sync();  // every block runs, flags clear

  for (int t0 = 0, buf = 0; t0 < n; t0 += E4_GROUP, buf ^= 1) {
    const int cnt = min(E4_GROUP, n - t0);
    double reed_out;
    const double out = v.group(w, lane, cnt, true, &reed_out, [](int) {});
    // ── gates and NaN guard #1: sample k's gated value, the first bad
    // sample of the slot's group
    const long long gk = gate - k;  // a steal slot's fade before sample k
    const double x = main_slot ? (gate != 0 ? out : 0.0)
                               : (gk > 0 ? out * ((double)gk / fade_len)
                                         : 0.0);
    const unsigned bad = (__ballot_sync(FULL, k < cnt && !finite(x))
                          & slot_bits) >> (lane & ~7);
    const int first = bad ? __ffs((int)bad) - 1 : E4_GROUP;
    if constexpr (CLUSTER) {
      if (k < cnt) lead->g[buf][k][j] = k < first ? x : 0.0;
      if (k == first) lead->bad[buf][k] = 1;
    }
    if (first < E4_GROUP) gate = 0;
    else if (!main_slot) gate = gate - cnt > 0 ? gate - cnt : 0;
    if constexpr (CLUSTER) cluster.sync();
    // ── the slot sum of sample k in index order, on the leader
    if (SUM && rank == 0 && (int)threadIdx.x < cnt) {
      const double* gt = tile.g[buf][threadIdx.x];
      double m = gt[0], st = gt[MAXV];
      for (int s = 1; s < MAXV; ++s) {
        m = m + gt[s];
        st = st + gt[MAXV + s];
      }
      mono[t0 + threadIdx.x] = m + st;
      fires += tile.bad[buf][threadIdx.x] != 0;
      tile.bad[buf][threadIdx.x] = 0;
    }
  }

  // chunk-end cleanup: a silent main voice goes FREE (quiet: every mode's
  // |amp·env| small, a vote over the mode threads; thread 7 repeats mode 6)
  const bool small = fabs(v.amp * v.env) <= 1e-4;
  const bool quiet = (__ballot_sync(FULL, small) & slot_bits) == slot_bits;
  if (main_slot && gate != 0) {
    const double rel_s = v.dact ? v.dcount / sample_rate : 0.0;
    const bool silent = v.dact && rel_s > 10.0;
    if (silent || quiet) gate = 0;
  }
  v.store(vst, vsti, SLOTS, j, k);
  if (k == 0) eng_i[j] = gate;
  if (rank == 0 && threadIdx.x < 32) {
    long long total = fires;
    for (int i = 1; i < E4_GROUP; ++i) total += __shfl_sync(FULL, fires, i);
    if (threadIdx.x == 0) eng_i[EI_FIRES] += total;
  }
}

// E1's thread form, above the wrapper's crossover (kernels/engine.py
// VOICES_LANES_MAX_ENGINES): block b runs engine b's 128 slots, a thread
// per slot (voice_sample_guarded: a warp is 32 slots of one engine, and
// once the attacks are over its votes skip nearly every libm call), the
// gates sample by sample and the slot sum through a shared tile of
// E1_TILE samples. On a full card its 128 voices per block render more
// engine-samples per second than the cluster form's eight threads per
// voice, whose serial tail runs on every thread. One block per SM in the
// launch bound: at 3 or 4 ptxas spills (tools/voice_breakdown.cu times
// them, and the kernel without its votes).
constexpr int E1_TILE = 32;

__global__ void __launch_bounds__(SLOTS, 1)
engine_voices_thread_kernel(const double* __restrict__ vpar, double* vst,
                            long long* vsti, long long* eng_i, double* mono,
                            int n, double fade_len, double sample_rate) {
  __shared__ double tile[E1_TILE][SLOTS];
  __shared__ int bad_tile[E1_TILE];
  __shared__ unsigned long long fires;
  const size_t e = blockIdx.x;
  vpar += e * NPAR * SLOTS;
  vst += e * NST * SLOTS;
  vsti += e * NSTI * SLOTS;
  eng_i += e * ENG_I;
  mono += e * (size_t)n;
  const int j = threadIdx.x;
  const bool main_slot = j < MAXV;
  Voice v;
  voice_load(v, vpar, vst, vsti, SLOTS, j);
  long long gate = eng_i[j];  // slot state (main) or steal fade (steal)
  if (j == 0) fires = 0;

  for (int t0 = 0; t0 < n; t0 += E1_TILE) {
    const int tn = min(E1_TILE, n - t0);
    if (j < E1_TILE) bad_tile[j] = 0;
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      const double out = voice_sample_guarded<false>(v, nullptr, true);
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

// E1's launch: a cluster of E1_CLUSTER blocks per engine
template <int VARIANT = 0>
int launch_engine_voices(const double* vpar, double* vst, long long* vsti,
                         long long* eng_i, double* mono, int n, int b,
                         double fade_len, double sample_rate,
                         cudaStream_t stream) {
  if (n < 0 || b < 0 || b > (1 << 27)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  engine_voices_kernel<VARIANT><<<b * E1_CLUSTER, E1_BLOCK, 0, stream>>>(
      vpar, vst, vsti, eng_i, mono, n, fade_len, sample_rate);
  return (int)cudaGetLastError();
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

// one BJT's two port currents (gp.bjt_currents) from its 13 parameters,
// parameter j at p[j * stride]
__device__ __forceinline__ void bjt_currents(const double* p, int stride,
                                             double vbe, double vbc,
                                             double* i0, double* i1) {
  const double is_ = p[0], nf_vt = p[stride], nr_vt = p[2 * stride],
               inv_vaf = p[3 * stride], inv_var = p[4 * stride],
               inv_ikf = p[5 * stride], inv_ikr = p[6 * stride],
               bf = p[7 * stride], br = p[8 * stride], ise = p[9 * stride],
               ne_vt = p[10 * stride], isc = p[11 * stride],
               nc_vt = p[12 * stride];
  const double i_f = is_ * (limexp(vbe / nf_vt) - 1.0);
  const double i_r = is_ * (limexp(vbc / nr_vt) - 1.0);
  const double q1 = 1.0 / jmax(1.0 - vbc * inv_vaf - vbe * inv_var, 1e-4);
  const double q2 = i_f * inv_ikf + i_r * inv_ikr;
  const double qb = q1 * 0.5 * (1.0 + sqrt(1.0 + 4.0 * jmax(q2, 0.0)));
  const double ict = (i_f - i_r) / qb;
  const double ibe = i_f / bf + ise * (limexp(vbe / ne_vt) - 1.0);
  const double ibc = i_r / br + isc * (limexp(vbc / nc_vt) - 1.0);
  *i0 = ibe + ibc;
  *i1 = ict - ibc;
}

// the reference's mna.bjt_currents (gp.bjt_currents), per BJT
template <int M, int NB>
__device__ __noinline__ void currents(const double* gpc, const double* vnl, double* i) {
  for (int b = 0; b < NB; ++b)
    bjt_currents(gpc + 13 * b, 1, vnl[2 * b], vnl[2 * b + 1], &i[2 * b],
                 &i[2 * b + 1]);
}

__device__ __forceinline__ void limexp_d(double x, double* val, double* dv) {
  const double e = exp(jmin(x, XC));
  const bool lin = x < XC;
  *val = lin ? e : EXC * (1.0 + (x - XC));
  *dv = lin ? e : EXC;
}

// one BJT's closed-form GP derivatives (gp.bjt_currents_derivs_packed)
// from its 13 parameters, parameter j at p[j * stride]: the two entries
// of its Jacobian columns inside its block, top[k] = dI[0]/dV[k], bot[k] =
// dI[1]/dV[k] for its ports k = 0, 1
__device__ __forceinline__ void bjt_derivs(const double* p, int stride,
                                           double vbe, double vbc,
                                           double* top, double* bot) {
  const double is_ = p[0], inv_nfvt = p[stride], inv_nrvt = p[2 * stride],
               inv_vaf = p[3 * stride], inv_var = p[4 * stride],
               inv_ikf = p[5 * stride], inv_ikr = p[6 * stride],
               ise = p[7 * stride], inv_nevt = p[8 * stride],
               isc = p[9 * stride], inv_ncvt = p[10 * stride],
               inv_bf = p[11 * stride], inv_br = p[12 * stride];
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
  top[0] = dibe_be;
  top[1] = dibc_bc;
  bot[0] = dict_be;
  bot[1] = dict_bc - dibc_bc;
}

// closed-form GP derivatives (gp.bjt_currents_derivs_packed): the two
// entries of each Jacobian column inside its block, top = dI[2b]/dV[k],
// bot = dI[2b+1]/dV[k]
template <int M, int NB>
__device__ __noinline__ void derivs(const double* gpd, const double* vnl, double* top,
                       double* bot) {
  for (int b = 0; b < NB; ++b)
    bjt_derivs(gpd + 13 * b, 1, vnl[2 * b], vnl[2 * b + 1], top + 2 * b,
               bot + 2 * b);
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

// ═══════════════════ the warp-cooperative mna step ═══════════════════
//
// mna_step's step run by the 32 lanes of one warp (E2's circuit
// instantiations, E6). Lane r holds node row r of v (r < N) and nonlinear
// row r of i and v_nl (r < M); during Newton also its residual f[r], its
// Jacobian row and its augmented f32 row, in registers. Between the
// broadcasts every row is independent: the matvecs (lane r walks row r in
// column order over a vector published in shared memory), the BJTs'
// currents and derivatives (lanes 2b and 2b + 1 both compute BJT b and keep
// their own row), the Jacobian rows, the row updates of each pivot step
// (pivot row k broadcast by __shfl_sync) and the junction limit. The
// convergence test, the failure test and the NaN test are votes; the
// reductions whose value is kept or used (max_abs of f, of dv) are taken in
// index order on every lane from the published vector, so every lane holds
// the values and takes the branches that mna_step does, and each value is
// the same function of the same operands as there.
//
// The solver block is staged in shared memory once per block, every
// matrix transposed, so that the lanes' row walks read consecutive
// addresses: a stride of M = 16 doubles would put every lane of a
// row-major walk on one bank.

// one lane's rows of a circuit's solver state; resid and the counters
// (cooldown, nr_fail, nan_reset, damp, be_steps) are the same on every lane
struct LaneState {
  double v, i, v_nl, resid, diag[5];
};

// a warp's vectors in shared memory, published by their owning lanes
struct WarpScratch {
  double a[32], b[32];
};

// where element k of a block sits once each of its n_seg segments
// {offset, rows, cols} (row-major) is stored transposed
__device__ __forceinline__ int transposed_index(const int (*seg)[3],
                                                int n_seg, int k) {
  for (int s = 0; s < n_seg; ++s) {
    const int q = k - seg[s][0];
    if (q >= 0 && q < seg[s][1] * seg[s][2])
      return seg[s][0] + (q % seg[s][2]) * seg[s][1] + q / seg[s][2];
  }
  return k;
}

// where element k of the row-major solver block sits once staged
template <int N, int M, int NB>
__device__ int staged_index(int k) {
  using L = SL<N, M, NB>;
  const int seg[12][3] = {
      {L::S, N, N},      {L::AH, N, N},    {L::NV, M, N},   {L::NI, N, M},
      {L::SNI, N, M},    {L::K, M, M},     {L::SBE, N, N},  {L::AHBE, N, N},
      {L::SNIBE, N, M},  {L::KBE, M, M},   {L::GPD, NB, 13},
      {L::GPC, NB, 13}};
  return transposed_index(seg, 12, k);
}

// the block's threads copy `src` (row-major, SL's layout) into `dst`
template <int N, int M, int NB>
__device__ void stage_block(const double* __restrict__ src, double* dst) {
  for (int k = threadIdx.x; k < SL<N, M, NB>::SIZE; k += blockDim.x)
    dst[staged_index<N, M, NB>(k)] = src[k];
}

// every lane's x (rows below n of each W-lane segment) into buf[lane];
// after it every lane reads buf (its segment's W entries)
template <int W = 32>
__device__ __forceinline__ void publish(double* buf, double x, int lane,
                                        int n) {
  __syncwarp();  // every lane has read buf's previous contents
  if ((lane & (W - 1)) < n) buf[lane] = x;
  __syncwarp();
}

// row r of a staged R × C matrix (a[c * R + r]) times buf, in column order
template <int R, int C>
__device__ __forceinline__ double row_dot(const double* a, const double* x,
                                          int r) {
  double acc = a[r] * x[0];
#pragma unroll
  for (int c = 1; c < C; ++c) acc = acc + a[c * R + r] * x[c];
  return acc;
}

// max_abs of the lanes' x over rows below n, in index order on every lane
__device__ __forceinline__ double max_abs_warp(double* buf, double x,
                                               int lane, int n) {
  publish(buf, x, lane, n);
  return max_abs(buf, n);
}

// The lane helpers below work on a segment of W lanes (the warp, or a
// half-warp that holds one of two systems): `row` is the lane's index in
// its segment, and every shuffle stays inside the segment.

// this lane's current of `currents`: BJT row / 2, its row `row`
template <int NB, int W = 32>
__device__ __forceinline__ double current_lane(const double* gpc,
                                               double v_nl, int row) {
  const int b = min(row >> 1, NB - 1);
  const double vbe = __shfl_sync(FULL, v_nl, row & ~1, W);
  const double vbc = __shfl_sync(FULL, v_nl, row | 1, W);
  double i0, i1;  // staged: parameter j at gpc[j * NB + b]
  bjt_currents(gpc + b, NB, vbe, vbc, &i0, &i1);
  return (row & 1) ? i1 : i0;
}

// this lane's column of `derivs`: top = dI[2b]/dV[row], bot =
// dI[2b+1]/dV[row] for BJT b = row / 2
template <int NB, int W = 32>
__device__ __forceinline__ void derivs_lane(const double* gpd, double v_nl,
                                            int row, double* top,
                                            double* bot) {
  const int b = min(row >> 1, NB - 1);
  const double vbe = __shfl_sync(FULL, v_nl, row & ~1, W);
  const double vbc = __shfl_sync(FULL, v_nl, row | 1, W);
  double t[2], u[2];
  bjt_derivs(gpd + b, NB, vbe, vbc, t, u);
  *top = (row & 1) ? t[1] : t[0];
  *bot = (row & 1) ? u[1] : u[0];
}

// ge_solve_f32 on a segment: the lane of row r holds row r of the
// augmented f32 system; step k broadcasts pivot row k, every row below it
// updates itself, each update rounded once from double as there; back
// substitution in the same order. → this row's x
template <int M, int W = 32>
__device__ __forceinline__ float ge_solve_f32_warp(float (&aug)[M + 1],
                                                   int row) {
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float piv = __shfl_sync(FULL, aug[k], k, W);
    const float inv = 1.0f / (fabsf(piv) > 1e-30f ? piv : 1e-30f);
    const double fac = (double)aug[k];
#pragma unroll
    for (int c = k + 1; c <= M; ++c) {
      const float pk = __shfl_sync(FULL, aug[c], k, W) * inv;
      const float upd = (float)((double)aug[c] - fac * (double)pk);
      aug[c] = row == k ? pk : (row > k ? upd : aug[c]);
    }
  }
  float x[M], own = 0.0f;
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float acc = aug[M];
#pragma unroll
    for (int j = i + 1; j < M; ++j)
      acc = (float)((double)acc - (double)aug[j] * (double)x[j]);
    x[i] = __shfl_sync(FULL, acc, i, W);
    own = row == i ? x[i] : own;
  }
  return own;
}

// nr_solve on a warp: Newton on this lane's row of v_nl = p + K i(v_nl),
// K the staged k_eff; leaves the row's current in i; → the final residual
// (the same on every lane)
template <int N, int M, int NB, int ITERS>
__device__ __forceinline__ double nr_solve_warp(const double* s,
                                                const double* k_eff, double p,
                                                double& v_nl, double& i,
                                                WarpScratch* w, int lane) {
  using L = SL<N, M, NB>;
  const int r = min(lane, M - 1);
  const double nvt = s[L::NVT + r], vcrit = s[L::VCRIT + r];
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
    i = current_lane<NB>(s + L::GPC, v_nl, lane);
    publish(w->a, i, lane, M);
    const double f = v_nl - p - row_dot<M, M>(k_eff, w->a, r);
    if (__all_sync(FULL, lane >= M || fabs(f) < 1e-9))
      return max_abs_warp(w->b, f, lane, M);
    double top, bot;
    derivs_lane<NB>(s + L::GPD, v_nl, lane, &top, &bot);
    __syncwarp();  // every lane has read a's currents and b's last max
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
    const double dv = (double)ge_solve_f32_warp<M>(aug, lane);
    const double v_old = v_nl;
    const double v_new = v_old - jclip(dv, -2.0, 2.0);
    const double delta = v_new - v_old;
    const double lim = v_old + nvt * log1p(jmax(delta, 0.0) / nvt);
    const bool apply = (v_new > vcrit) && (delta > 2.0 * nvt);
    v_nl = apply ? lim : v_new;
  }
  i = current_lane<NB>(s + L::GPC, v_nl, lane);
  publish(w->a, i, lane, M);
  const double f = v_nl - p - row_dot<M, M>(k_eff, w->a, r);
  return max_abs_warp(w->b, f, lane, M);
}

// failed() on a warp: votes, equal to the thread's test (a NaN row makes
// both the ringing max NaN, false, and the non-finite test true)
template <int N>
__device__ __forceinline__ bool failed_warp(double v, double resid,
                                            int n_nodes, int lane) {
  const bool ring = __any_sync(FULL, lane < n_nodes && fabs(v) > 55.0);
  const bool nonfin = __any_sync(FULL, lane < N && !finite(v));
  return resid > 1e-3 || ring || nonfin;
}

// mna_step on a warp, on the staged block `s`; w_extra this lane's row of
// the extra source vector
template <int N, int M, int NB, int ITERS>
__device__ __noinline__ void mna_step_warp(const double* s, LaneState& st,
                                           double w_extra, WarpScratch* w) {
  using L = SL<N, M, NB>;
  const int lane = threadIdx.x & 31;
  const int rn = min(lane, N - 1), rm = min(lane, M - 1);
  const int n_nodes = (int)s[L::N_NODES];
  const bool trap_primary = s[L::TRAP_PRIMARY] != 0.0;
  double v = 0.0, i_new = 0.0, v_nl = 0.0, resid = 0.0;
  bool need_be = false;
  // solve_once: the trapezoidal pass, then the BE replay where needed
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const bool be = pass == 1;
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
    publish(w->a, rhs, lane, N);
    const double v_lin = row_dot<N, N>(s_mat, w->a, rn);
    publish(w->a, v_lin, lane, N);
    const double p = row_dot<M, N>(s + L::NV, w->a, rm);
    v_nl = st.v_nl;
    resid = nr_solve_warp<N, M, NB, ITERS>(s, k_eff, p, v_nl, i_new, w,
                                           lane);
    publish(w->a, i_new, lane, M);
    v = v_lin + row_dot<N, M>(s_ni, w->a, rn);
    if (be) break;
    need_be = trap_primary &&
              (failed_warp<N>(v, resid, n_nodes, lane) || st.diag[0] > 0.0);
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
}

// the lane's rows of a solver state whose rows v (N), i (M), v_nl (M),
// resid, diag (5) follow one another from row 0 of `rows`, row k at
// rows[k * stride]
template <int N, int M>
__device__ void load_lane(LaneState& st, const double* rows, size_t stride,
                          int lane) {
  const int rn = min(lane, N - 1), rm = min(lane, M - 1);
  st.v = rows[rn * stride];
  st.i = rows[(N + rm) * stride];
  st.v_nl = rows[(N + M + rm) * stride];
  st.resid = rows[(N + 2 * M) * stride];
  for (int k = 0; k < 5; ++k) st.diag[k] = rows[(N + 2 * M + 1 + k) * stride];
}

template <int N, int M>
__device__ void store_lane(const LaneState& st, double* rows, size_t stride,
                           int lane) {
  if (lane < N) rows[lane * stride] = st.v;
  if (lane < M) {
    rows[(N + lane) * stride] = st.i;
    rows[(N + M + lane) * stride] = st.v_nl;
  }
  if (lane == 0) {
    rows[(N + 2 * M) * stride] = st.resid;
    for (int k = 0; k < 5; ++k) rows[(N + 2 * M + 1 + k) * stride] = st.diag[k];
  }
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

// ═════════════════════ the warp-cooperative DK step ═════════════════════
//
// preamp_step run by the 32 lanes of one warp (E5<dk>, E7, E2<dk,
// circuit>'s warp form). The twins run side by side on the two half-warps:
// lane l serves twin r = l / 16 and node row q = l % 16 (rows above 7
// repeat row 7), and holds v[r][q]; the twin's junction currents and
// voltages, its input capacitor's companion current and its last source
// term are the same on every lane of its half, the last LDR conductance on
// every lane. The history and the predictor
// are a row per lane in column order over a vector the half published in
// shared memory (row_dot), each row's own source terms added in
// preamp_step's order. Newton's 2 × 2 system is small enough to run on
// every lane of the half: lanes 0 and 1 evaluate the two junctions' exps
// at once and shuffle them to the half, which then forms the residuals,
// the Jacobian and the masked update identically on every lane. Each
// half's convergence is preamp_step's own test; a ballot leaves the loop
// once both halves have converged (a converged half keeping its voltages,
// as the thread's masked update does), with the final currents in hand.
// Each value is the same function of the same operands as in preamp_step,
// so the two agree bit for bit.
//
// The preamp block is staged in shared memory once per block with A_neg
// and S_base transposed, so that the lanes' row walks read consecutive
// addresses.

constexpr int PR_SIZE = PR_J_CIN_DC + 1;
static_assert(C_MISC - C_PRE == PR_SIZE, "the chain's DK block is E5's");

// the block's threads copy the preamp block `src` into `dst`, staged
__device__ void stage_dk(const double* __restrict__ src, double* dst) {
  const int seg[2][3] = {{PR_A_NEG, 8, 8}, {PR_S_BASE, 8, 8}};
  for (int k = threadIdx.x; k < PR_SIZE; k += blockDim.x)
    dst[transposed_index(seg, 2, k)] = src[k];
}

// a warp's DK preamp: this lane's node row, its twin's scalars, and the
// LDR conductance of the last step
struct DkWarp {
  double v, i_nl[2], v_nl[2], j_cin, cin_prev, g_prev;
};

// the lane's rows of the DK rows (PreState) from row 0 of `rows`, row k at
// rows[k * stride]
__device__ void load_dk(DkWarp& st, const double* rows, size_t stride,
                        int lane) {
  const int r = lane >> 4, q = lane & 15;
  st.v = rows[(PS_V + 8 * r + min(q, 7)) * stride];
  for (int k = 0; k < 2; ++k) {
    st.i_nl[k] = rows[(PS_I + 2 * r + k) * stride];
    st.v_nl[k] = rows[(PS_VNL + 2 * r + k) * stride];
  }
  st.j_cin = rows[(PS_JCIN + r) * stride];
  st.cin_prev = rows[(PS_CINPREV + r) * stride];
  st.g_prev = rows[PS_GPREV * stride];
}

__device__ void store_dk(const DkWarp& st, double* rows, size_t stride,
                         int lane) {
  const int r = lane >> 4, q = lane & 15;
  if (q < 8) rows[(PS_V + 8 * r + q) * stride] = st.v;
  if (q < 2) {
    rows[(PS_I + 2 * r + q) * stride] = q ? st.i_nl[1] : st.i_nl[0];
    rows[(PS_VNL + 2 * r + q) * stride] = q ? st.v_nl[1] : st.v_nl[0];
  }
  if (q == 2) rows[(PS_JCIN + r) * stride] = st.j_cin;
  if (q == 3) rows[(PS_CINPREV + r) * stride] = st.cin_prev;
  if (lane == 0) rows[PS_GPREV * stride] = st.g_prev;
}

// init_preamp on a warp (the staged block's DC point)
__device__ __forceinline__ void init_dk_warp(const double* s, DkWarp& st,
                                             int lane) {
  st.v = s[PR_V_DC + min(lane & 15, 7)];
  for (int k = 0; k < 2; ++k) {
    st.i_nl[k] = s[PR_I_NL_DC + k];
    st.v_nl[k] = s[PR_V_NL_DC + k];
  }
  st.j_cin = s[PR_J_CIN_DC];
  st.cin_prev = s[PR_J_CIN_DC];
  st.g_prev = 1.0 / 1000000.0;
}

// both junctions' (ic, gm) at (v0, v1) on every lane of the twin's W
// lanes: its lane 0 evaluates v0's, its lane 1 v1's
template <int W = 16>
__device__ __forceinline__ void bjt_pair(double v0, double v1, int q,
                                         double* ic, double* gm) {
  double c, g;
  bjt_ic_gm(q & 1 ? v1 : v0, &c, &g);
  ic[0] = __shfl_sync(FULL, c, 0, W);
  ic[1] = __shfl_sync(FULL, c, 1, W);
  gm[0] = __shfl_sync(FULL, g, 0, W);
  gm[1] = __shfl_sync(FULL, g, 1, W);
}

// preamp_step on a warp, on the staged block `s`; g and x the same on every
// lane; → main − shadow, the same on every lane
__device__ __noinline__ double dk_step_warp(const double* s, DkWarp& st,
                                            double g, double x,
                                            WarpScratch* w) {
  const int lane = threadIdx.x & 31, r = lane >> 4, q = lane & 15;
  const int n = min(q, 7);
  const double* a = w->a + 16 * r;  // this half's published vector
  // the history, fb's LDR term, the sources, the input, two_w
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
  // the predictor, its LDR correction, the ports' p
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
  // Newton, both twins at once: at most 6 iterations, leaving once both
  // have converged with the currents of the final v_nl in hand
  double v0 = st.v_nl[0], v1 = st.v_nl[1], ic[2], gm[2];
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
    bjt_pair(v0, v1, q, ic, gm);
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
  if (!done) bjt_pair(v0, v1, q, ic, gm);
  // the corrector, the input capacitor, the reset to the DC point on a
  // non-finite output
  const double dot = s[PR_SFB_NI] * ic[0] + s[PR_SFB_NI + 1] * ic[1];
  const double s_ni = ic[0] * s[PR_NI_COL0 + n] + ic[1] * s[PR_NI_COL1 + n];
  const double v_new = v_pred + s_ni - (sm_k * dot) * s[PR_S_FB_COL + n];
  const double jc = -s[PR_GC_1PC] * (u - __shfl_sync(FULL, v_new, B1, 16)) -
                    s[PR_C_CIN] * st.j_cin;
  const double out = __shfl_sync(FULL, v_new, OUTN) -
                     __shfl_sync(FULL, v_new, 16 + OUTN);
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
  return bad ? 0.0 : out;
}

// ═══════════════════════ the melange preamp ═══════════════════════

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (prng.threefry2x32): inline (threefry_pair)
// and as a call (threefry)
__device__ __forceinline__ uint2 threefry_pair(uint32_t k1, uint32_t k2,
                                               uint32_t c1, uint32_t c2) {
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
  return make_uint2(x0, x1);
}

__device__ __noinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t c1,
                                      uint32_t c2, uint32_t* o1,
                                      uint32_t* o2) {
  const uint2 h = threefry_pair(k1, k2, c1, c2);
  *o1 = h.x;
  *o2 = h.y;
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

__device__ __forceinline__ double erfinv_core(double x) {
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

__device__ __noinline__ double erfinv_xla(double x) { return erfinv_core(x); }

// jax.random.normal(sub, (10,), float64)[i]: 64 random bits (the hash of
// the counts (0, i)), their top 52 as a uniform on [nextafter(-1, 0), 1),
// then sqrt(2) erfinv; INLINE: the hash and erfinv inline, not calls
template <bool INLINE = false>
__device__ __forceinline__ double normal_draw(uint32_t s1, uint32_t s2,
                                              uint32_t i) {
  constexpr double lo = -0x1.fffffffffffffp-1;  // nextafter(-1, 0)
  uint32_t b1, b2;
  if constexpr (INLINE) {
    const uint2 h = threefry_pair(s1, s2, 0u, i);
    b1 = h.x;
    b2 = h.y;
  } else {
    threefry(s1, s2, 0u, i, &b1, &b2);
  }
  const unsigned long long mant =
      ((unsigned long long)b1 << 20) | (unsigned long long)(b2 >> 12);
  const double floats = (double)mant * 0x1p-52;
  const double u = jmax(floats * 2.0 + lo, lo);
  return 1.4142135623730951 * (INLINE ? erfinv_core(u) : erfinv_xla(u));
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

// ═══════════════════ the warp-cooperative melange step ═══════════════════
//
// melange_step run by the 32 lanes of one warp (E5<melange>, E2<melange,
// circuit>'s warp form). The twins run side by side on the two
// half-warps: lane l serves twin r = l / 16 and row q = l % 16, and holds
// v[r][q] (q < 13), i[r][q] and v_nl[r][q] (q < 5) and draw q of the last
// step (q < 10). Lanes q < 10 each draw one of the step's ten normals
// (both halves the same ones), so the draws cost the latency of one. Every
// matrix product is a row per lane in column order over a vector its half
// published in shared memory (row_dot); the BJTs' currents and
// derivatives, the Jacobian rows and the 5-pivot elimination run on the
// five rows of each half, shuffling inside the half. Each half's
// convergence is a ballot of its rows, equal to the thread's max_abs test
// (a NaN residual is no convergence there and here); both halves run the
// elimination until both have converged, a converged half keeping its
// rows, as the thread skips it. The output, and so the reset, is the same
// value on every lane. Each value is the same function of the same
// operands as in melange_step, so the two agree bit for bit.
//
// The melange block is staged in shared memory once per block with every
// matrix transposed (a 13 × 10 row-major walk puts lanes 0 and 8 on one
// bank), so that the lanes' row walks read consecutive addresses.

constexpr int MEL_SEGS = 10;

// where element k of the melange block sits once staged
__device__ int mel_staged_index(int k) {
  const int seg[MEL_SEGS][3] = {
      {ML_A_HIST, 13, 13}, {ML_S, 13, 13},      {ML_N_V, 5, 13},
      {ML_N_I, 13, 5},     {ML_S_NI, 13, 5},    {ML_K, 5, 5},
      {ML_K_OUTER, 5, 5},  {ML_INJECT, 13, 10}, {ML_CUR, 2, 13},
      {ML_DER, 2, 13}};
  return transposed_index(seg, MEL_SEGS, k);
}

// the block's threads copy the melange block `src` into `dst`, staged
__device__ void stage_melange(const double* __restrict__ src, double* dst) {
  for (int k = threadIdx.x; k < ML_SIZE; k += blockDim.x)
    dst[mel_staged_index(k)] = src[k];
}

// a warp's melange preamp: this lane's rows (see above); the LDR
// conductance of the last step and the noise key the same on every lane
struct MelWarp {
  double v, i, v_nl, w_prev, g_prev, key[2];
};

// the lane's rows of the melange rows (MelState) from row 0 of `rows`,
// row k at rows[k * stride]
__device__ void load_mel(MelWarp& st, const double* rows, size_t stride,
                         int lane) {
  const int r = lane >> 4, q = lane & 15;
  st.v = rows[(MS_V + 13 * r + min(q, 12)) * stride];
  st.i = rows[(MS_I + 5 * r + min(q, 4)) * stride];
  st.v_nl = rows[(MS_VNL + 5 * r + min(q, 4)) * stride];
  st.w_prev = rows[(MS_WPREV + min(q, 9)) * stride];
  st.g_prev = rows[MS_GPREV * stride];
  st.key[0] = rows[MS_KEY * stride];
  st.key[1] = rows[(MS_KEY + 1) * stride];
}

__device__ void store_mel(const MelWarp& st, double* rows, size_t stride,
                          int lane) {
  const int r = lane >> 4, q = lane & 15;
  if (q < 13) rows[(MS_V + 13 * r + q) * stride] = st.v;
  if (q < 5) {
    rows[(MS_I + 5 * r + q) * stride] = st.i;
    rows[(MS_VNL + 5 * r + q) * stride] = st.v_nl;
  }
  if (lane < 10) rows[(MS_WPREV + lane) * stride] = st.w_prev;
  if (lane == 0) {
    rows[MS_GPREV * stride] = st.g_prev;
    rows[MS_KEY * stride] = st.key[0];
    rows[(MS_KEY + 1) * stride] = st.key[1];
  }
}

// init_melange on a warp (the staged block's DC point)
__device__ __forceinline__ void init_melange_warp(const double* s,
                                                  MelWarp& st, int lane) {
  const int q = lane & 15;
  st.v = s[ML_V_DC + min(q, 12)];
  st.i = s[ML_I_DC + min(q, 4)];
  st.v_nl = s[ML_V_NL_DC + min(q, 4)];
  st.w_prev = 0.0;
  st.g_prev = 1.0 / 1000000.0;
  st.key[0] = 0.0;
  st.key[1] = 24301.0;  // 0x5EED
}

// mel_currents' row q: the 2N5089s' ports 0-3, the 1N4148's port 4; the
// twin on W lanes
template <int W = 16>
__device__ __forceinline__ double mel_current_lane(const double* s,
                                                   double v_nl, int q) {
  const double ib = current_lane<2, W>(s + ML_CUR, v_nl, q);
  const double id = s[ML_DIODE] * (limexp(v_nl / s[ML_DIODE + 1]) - 1.0);
  return q == 4 ? id : ib;
}

// mel_jacobian's column q: the BJTs' two entries (top, bot) for q < 4, the
// diode's conductance (top) for q = 4; the twin on W lanes
template <int W = 16>
__device__ __forceinline__ void mel_derivs_lane(const double* s, double v_nl,
                                                int q, double* top,
                                                double* bot) {
  derivs_lane<2, W>(s + ML_DER, v_nl, q, top, bot);
  double val, dval;
  limexp_d(v_nl / s[ML_DIODE + 1], &val, &dval);
  const double g_d = s[ML_DIODE] * dval / s[ML_DIODE + 1];
  if (q == 4) *top = g_d;
}

// melange_step on a warp, on the staged block `s`; g, x and scale the same
// on every lane; → main − shadow, the same on every lane
__device__ __noinline__ double melange_step_warp(const double* s,
                                                 MelWarp& st, double g,
                                                 double x, double scale,
                                                 WarpScratch* w) {
  constexpr int N = 13, M = 5, NR = 10;
  const int lane = threadIdx.x & 31, r = lane >> 4, q = lane & 15;
  const int rn = min(q, N - 1), rm = min(q, M - 1);
  const int fb = (int)s[ML_IDX], outn = (int)s[ML_IDX + 1];
  const int row_in = (int)s[ML_IDX + 2];
  const double* a = w->a + 16 * r;  // this half's published vectors
  const double* b = w->b + 16 * r;
  // the key's two hashes: the next key on lane NR of each half, the
  // draws' key on every other lane; one normal on each lane q < NR
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
  // the history, fb's LDR term, the sources, the input, the device
  // currents, the noise (main twin only)
  __syncwarp();  // every lane has read b's draws
  if (q < N) w->a[lane] = st.v;
  if (q < M) w->b[lane] = st.i;
  __syncwarp();
  double rhs = row_dot<N, N>(s + ML_A_HIST, a, rn);
  rhs = q == fb ? rhs + (-st.g_prev) * st.v : rhs;
  rhs = rhs + s[ML_WS_W + rn];
  rhs = q == row_in ? rhs + (r == 0 ? x : 0.0) : rhs;
  rhs = rhs + row_dot<N, M>(s + ML_N_I, b, rn);
  rhs = rhs + (r == 0 ? i_noise : 0.0);
  // the predictor, its LDR correction, the ports' p, this row of K_corr
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
  // Newton, both twins at once: at most 12 iterations, leaving once both
  // have converged with the currents of the final v_nl in hand
  double v_nl = st.v_nl, i_nl = 0.0;
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
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
    double top, bot;
    mel_derivs_lane(s, v_nl, q, &top, &bot);
    __syncwarp();  // every lane has read b's currents
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
  // the corrector, the reset to the DC point on a non-finite output
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
  return bad ? 0.0 : out;
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

// tremolo.step after the oscillator: vactrol (its envelope *env) → CdS R
// (*r_ldr) → divider at `depth`; returns the shunt
__device__ __forceinline__ double vactrol_shunt(const double* misc,
                                                double v_out, double depth,
                                                double* env, double* r_ldr) {
  const double led = jclip((10.95 - v_out) / (10.95 - 0.70), 0.0, 1.0);
  const double env0 = *env;
  const double coeff = led > env0 ? misc[M_TREM_ATT] : misc[M_TREM_REL];
  const double env1 = led + coeff * (env0 - led);
  const double drive = jclip(env1, 0.0, 1.0);
  const double log_r =
      misc[M_LN_RMAX] + misc[M_LN_SPAN] * pow(jmax(drive, 1e-30), 0.9);
  const double r = drive < 1e-6 ? 1000000.0 : exp(log_r);
  *env = env1;
  *r_ldr = r;
  const double r_upper = 50000.0 * (1.0 - depth);
  const double r_lower = 50000.0 * depth;
  const double top =
      r_upper > 0.0 ? r_upper * 18000.0 / (r_upper + 18000.0) : 0.0;
  const double br = 680.0 + r;
  const double low = r_lower > 0.0 ? r_lower * br / (r_lower + br) : 0.0;
  return top + low;
}

// tremolo.step: oscillator → vactrol → CdS R → divider; returns the shunt
__device__ __noinline__ double tremolo_step(const double* c, const double* misc,
                               double* ch, double depth) {
  SolverState st{ch + CH_TREM_V, ch + CH_TREM_I, ch + CH_TREM_VNL,
                 ch + CH_TREM_RESID, ch + CH_TREM_DIAG};
  const double w0[7] = {0, 0, 0, 0, 0, 0, 0};
  mna_step<7, 4, 2, 4>(c + C_TREM, st, w0);
  const double v_out = ch[CH_TREM_V + (int)misc[M_TREM_OUT]];
  return vactrol_shunt(misc, v_out, depth, ch + CH_TREM_ENV,
                       ch + CH_TREM_RLDR);
}

// power_amp.step's rail sag after the solve: back to rest after a bad
// step, else toward the load of the output `raw`
__device__ __forceinline__ void rails_after(const double* misc, double* rails,
                                            double raw, bool bad) {
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
  if (sag) rails_after(misc, rails, raw, bad);
  return out;
}

// a warp's power amp: its solver rows (LaneState), the rails and the last
// output (the same on every lane); the chain's rows CH_PA_V .. CH_PA_LAST
struct PaWarp {
  LaneState s;
  double rails[4], last;
};
using PaL = SL<21, 16, 8>;
constexpr int PA_BLOCK = PaL::SIZE;
constexpr int PA_RAILS = CH_PA_RAILS - CH_PA_V;  // rows from CH_PA_V

__device__ void load_pa(PaWarp& pa, const double* rows, size_t stride,
                        int lane) {
  load_lane<21, 16>(pa.s, rows, stride, lane);
  for (int k = 0; k < 4; ++k) pa.rails[k] = rows[(PA_RAILS + k) * stride];
  pa.last = rows[(PA_RAILS + 4) * stride];
}

__device__ void store_pa(const PaWarp& pa, double* rows, size_t stride,
                         int lane) {
  store_lane<21, 16>(pa.s, rows, stride, lane);
  if (lane == 0) {
    for (int k = 0; k < 4; ++k) rows[(PA_RAILS + k) * stride] = pa.rails[k];
    rows[(PA_RAILS + 4) * stride] = pa.last;
  }
}

// init_power_amp on a warp (the staged block's DC point)
__device__ __forceinline__ void init_power_amp_warp(const double* pa,
                                                    PaWarp& st, int lane) {
  const int rn = min(lane, 20), rm = min(lane, 15);
  st.s.v = pa[PaL::VDC + rn];
  st.s.i = pa[PaL::IDC + rm];
  st.s.v_nl = pa[PaL::VNLDC + rm];
  st.s.resid = 0.0;
  for (int k = 0; k < 5; ++k) st.s.diag[k] = 0.0;
  st.rails[0] = st.rails[1] = 22.5;
  st.rails[2] = st.rails[3] = 0.0;
  st.last = 0.0;
}

// power_amp_step on a warp: pa the staged solver block, x the same on
// every lane; → the output, the same on every lane
__device__ __noinline__ double power_amp_step_warp(const double* pa,
                                                   const double* misc,
                                                   PaWarp& st, double x,
                                                   bool sag, WarpScratch* w) {
  const int lane = threadIdx.x & 31;
  const double sag_f = sag ? 1.0 : 0.0;
  double* rails = st.rails;
  // the sources, in power_amp_step's order of assignment
  const double w1 = (rails[0] - 22.5) * sag_f;
  const double w2 = (rails[1] - 22.5) * sag_f;
  const double wx = lane == (int)misc[M_PA_IN]   ? x
                    : lane == (int)misc[M_PA_V2] ? w2
                    : lane == (int)misc[M_PA_V1] ? w1
                                                 : 0.0;
  mna_step_warp<21, 16, 8, 16>(pa, st.s, wx, w);
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
  return out;
}

// a warp's tremolo: its solver rows, the vactrol's envelope and the LDR
// resistance (the same on every lane); the chain's rows CH_TREM_V ..
// CH_TREM_RLDR
struct TremWarp {
  LaneState s;
  double env, r_ldr;
};
constexpr int TREM_BLOCK = SL<7, 4, 2>::SIZE;

// tremolo_step on a warp: trem the staged solver block; → the shunt, the
// same on every lane
__device__ __noinline__ double tremolo_step_warp(const double* trem,
                                                 const double* misc,
                                                 TremWarp& st, double depth,
                                                 WarpScratch* w) {
  mna_step_warp<7, 4, 2, 4>(trem, st.s, 0.0, w);
  const double v_out = __shfl_sync(FULL, st.s.v, (int)misc[M_TREM_OUT]);
  return vactrol_shunt(misc, v_out, depth, &st.env, &st.r_ldr);
}

// power_amp.behavioral_process: 8 Newton iterations on
// y = f(A(x − βy)), memoryless; output normalised to ±1; inline
// (behavioral_core) and as a call (behavioral)
__device__ __forceinline__ double behavioral_core(double x) {
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

__device__ __noinline__ double behavioral(double x) {
  return behavioral_core(x);
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

// E2's thread form: a thread per engine, blocks of E2_BLOCK, in the
// wrapper's widest band (kernels/engine.py chain_form; the behavioral
// instantiations at width, the circuit ones in none). Thread e runs
// engine e's chain: row e of chain (B, CHAIN_ROWS), mono (B, n) and out
// (B, n), its own noise scale, its own speaker coefficients; the
// constants are shared. Each row is one thread's alone, so the layout is
// engine-major as render_states returns it; a thread reads one mono word
// and writes one output word per sample, against some 10^4-10^5 float64
// operations of the sample's chain. The behavioral instantiations run
// chain_thread_behavioral below (their working set in registers and
// shared memory); the circuit ones, whose 16 × 16 power-amp Newton does
// not fit in registers, run chain_sample on the engine's rows in a local
// array `ch`. Across each chain_sample call (not inlined) the loop keeps
// only e and t: the row offsets come again from the kernel's parameters
// and the flags from memory each sample (the flags' pointers are not
// __restrict__, so the loads stay in the loop), which keeps the live
// values, and so the spills, of a kernel that took one engine's flags as
// parameters.
constexpr int E2_BLOCK = 32;

// ═══════════ E2's thread form of the behavioral power amp ═══════════
//
// engine_chain_kernel<PRE, PA_BEHAVIORAL>: a thread per engine, as the
// thread form has always been (its lane efficiency is what wins at width),
// with nothing of the sample's recurrence in local memory. The constant
// blocks that it reads (the oscillator's solver block, the DK or melange
// block, the misc scalars) are staged in shared memory once per block as
// the warp forms stage them; every thread reads the same address, so the
// reads broadcast. The chain rows that the behavioral models use (the
// oversampler, the tremolo, the speaker, the smoothers, the preamp) live
// in a shared-memory frame laid out row-major across the block's engines
// (row k of engine e at frame[k * E2_BLOCK + e], so a warp's access to
// one row touches 32 consecutive words); the power amp's rows, memoryless
// here, stay in the chain in global memory, where only guard #2 writes
// them, and the speaker's coefficients in registers (with the melange
// preamp in the frame, as they would spill around its step). Each step (the
// tremolo's mna step, the twin DK or melange step) is a function of fixed
// size that takes the frame and scalars, and no per-thread array: it
// loads its rows into register arrays, runs its loops over rows and
// columns fully unrolled (only the Newton, pass and twin loops stay
// loops, and a twin's values enter and leave them by selects, so no array
// is addressed at run time), reads its constants where it uses them
// (opaque_zero), and stores its rows back; the melange preamp's rows
// chosen at run time (fb, out, the input) are selects over the unrolled
// rows. The steps stay calls, so that each is allocated alone
// (tools/torch_chain_breakdown.py's thread section times the form). Every
// value and branch is the one-thread step's (mna_step, preamp_step,
// melange_step, behavioral), in the same order, so the form equals the
// old thread form, the half and warp forms and chain_plain bit for bit.

// a thread's rows in its block's frame: row k at p[k * E2_BLOCK]
struct Rows {
  double* p;
  __device__ __forceinline__ double& operator[](int k) const {
    return p[k * E2_BLOCK];
  }
  __device__ __forceinline__ Rows at(int k) const {
    return Rows{p + k * E2_BLOCK};
  }
};

// the frame's rows: the chain's rows CH_OS_UP_A .. CH_TREM_RLDR and
// CH_SPK .. the character smoother's last, then the preamp's rows
// (PreState or MelState); with the melange preamp, then the speaker's
// coefficients (SPK_COEFFS rows, Speaker's fields in order), which in
// registers would live across the melange step's calls and spill
enum ThreadRow {
  TR_TREM = CH_TREM_V, TR_SPK = CH_TREM_RLDR + 1,
  TR_SM_VOLUME = TR_SPK + CH_SM_VOLUME - CH_SPK,
  TR_SM_DEPTH = TR_SPK + CH_SM_DEPTH - CH_SPK,
  TR_SM_CHAR = TR_SPK + CH_SM_CHAR - CH_SPK, TR_PRE = TR_SM_CHAR + 4
};
constexpr int SPK_COEFFS = sizeof(Speaker) / sizeof(double);
static_assert(SPK_COEFFS * sizeof(double) == sizeof(Speaker),
              "Speaker: doubles only");
template <int PRE>
struct ThreadRows {
  static constexpr bool SPK_IN_FRAME = PRE == PRE_MELANGE;
  static constexpr int SPK_K =
      TR_PRE + (PRE == PRE_MELANGE ? (int)MS_ROWS : (int)PS_ROWS);
  static constexpr int N = SPK_K + (SPK_IN_FRAME ? SPK_COEFFS : 0);
};

// the frame row of chain row k, or -1 (the power amp's rows and the other
// preamp's)
template <int PRE>
__device__ __forceinline__ int thread_row(int k) {
  constexpr int pre = PRE == PRE_MELANGE ? CH_MEL_V : CH_PRE_V;
  constexpr int pre_n = PRE == PRE_MELANGE ? (int)MS_ROWS : (int)PS_ROWS;
  if (k < TR_SPK) return k;
  if (k >= CH_SPK && k < CH_SM_CHAR + 4) return TR_SPK + k - CH_SPK;
  if (k >= pre && k < pre + pre_n) return TR_PRE + k - pre;
  return -1;
}

// An opaque 0 (the compiler cannot see its value): a loop that reads its
// constants through `s + opaque_zero()` reads each where it is used, in
// every iteration, rather than having them all hoisted into registers
// before the loop, which would spill.
__device__ __forceinline__ int opaque_zero() {
  int z = 0;
  asm volatile("" : "+r"(z));
  return z;
}

// ── the generic mna step in registers (the staged block: every matrix
// transposed, a[c * R + r]) ──

// the staged R × C matrix a times x, columns summed in index order
template <int R, int C>
__device__ __forceinline__ void matvec_reg(const double* a,
                                           const double (&x)[C],
                                           double (&y)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    double acc = a[r] * x[0];
#pragma unroll
    for (int c = 1; c < C; ++c) acc = acc + a[c * R + r] * x[c];
    y[r] = acc;
  }
}

// max_abs over the first n entries (n ≥ 1)
template <int K>
__device__ __forceinline__ double max_abs_reg(const double (&x)[K],
                                              int n = K) {
  double m = fabs(x[0]);
#pragma unroll
  for (int i = 1; i < K; ++i) {
    const double a = fabs(x[i]);
    if (i < n && (a != a || a > m)) m = a;
  }
  return m;
}

// ge_solve_f32 on the rounded system aug, unrolled
template <int M>
__device__ __forceinline__ void ge_solve_f32_reg(float (&aug)[M][M + 1],
                                                 double (&x_out)[M]) {
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const float piv = aug[k][k];
    const float inv = 1.0f / (fabsf(piv) > 1e-30f ? piv : 1e-30f);
#pragma unroll
    for (int c = k + 1; c <= M; ++c) aug[k][c] = aug[k][c] * inv;
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const double fac = (double)aug[i][k];
#pragma unroll
      for (int c = k + 1; c <= M; ++c)
        aug[i][c] = (float)((double)aug[i][c] - fac * (double)aug[k][c]);
    }
  }
  float x[M];
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float acc = aug[i][M];
#pragma unroll
    for (int j = i + 1; j < M; ++j)
      acc = (float)((double)acc - (double)aug[i][j] * (double)x[j]);
    x[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < M; ++i) x_out[i] = (double)x[i];
}

// the currents of NB BJTs on staged parameters (parameter j of BJT b at
// gp[j * NB + b]), their ports' voltages v[2b], v[2b + 1]
template <int NB>
__device__ __forceinline__ void currents_reg(const double* gp,
                                             const double* v, double* i) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    double i0, i1;
    bjt_currents(gp + b, NB, v[2 * b], v[2 * b + 1], &i0, &i1);
    i[2 * b] = i0;
    i[2 * b + 1] = i1;
  }
}

// their derivatives (derivs)
template <int NB>
__device__ __forceinline__ void derivs_reg(const double* gp, const double* v,
                                           double* top, double* bot) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    double t[2], u[2];
    bjt_derivs(gp + b, NB, v[2 * b], v[2 * b + 1], t, u);
    top[2 * b] = t[0];
    top[2 * b + 1] = t[1];
    bot[2 * b] = u[0];
    bot[2 * b + 1] = u[1];
  }
}

// nr_solve in registers; k_eff staged
template <int N, int M, int NB, int ITERS>
__device__ __forceinline__ double nr_solve_reg(const double* s,
                                               const double* k_eff,
                                               const double (&p)[M],
                                               double (&v_nl)[M],
                                               double (&i)[M]) {
  using L = SL<N, M, NB>;
  double f[M], ki[M];
#pragma unroll 1
  for (int it = 0; it < ITERS; ++it) {
    const int z = opaque_zero();
    currents_reg<NB>(s + z + L::GPC, v_nl, i);
    matvec_reg<M, M>(k_eff + z, i, ki);
    bool conv = true;
#pragma unroll
    for (int r = 0; r < M; ++r) {
      f[r] = v_nl[r] - p[r] - ki[r];
      conv = conv && fabs(f[r]) < 1e-9;
    }
    if (conv) return max_abs_reg(f);
    double top[M], bot[M], dv[M];
    derivs_reg<NB>(s + z + L::GPD, v_nl, top, bot);
    float aug[M][M + 1];
#pragma unroll
    for (int r = 0; r < M; ++r) {
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int r0 = 2 * (k / 2);
        aug[r][k] = (float)((r == k ? 1.0 : 0.0) -
                            (k_eff[z + r0 * M + r] * top[k] +
                             k_eff[z + (r0 + 1) * M + r] * bot[k]));
      }
      aug[r][M] = (float)f[r];
    }
    ge_solve_f32_reg<M>(aug, dv);
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const double v_old = v_nl[r];
      const double v_new = v_old - jclip(dv[r], -2.0, 2.0);
      const double nvt = s[z + L::NVT + r];
      const double delta = v_new - v_old;
      const double lim = v_old + nvt * log1p(jmax(delta, 0.0) / nvt);
      const bool apply = (v_new > s[z + L::VCRIT + r]) && (delta > 2.0 * nvt);
      v_nl[r] = apply ? lim : v_new;
    }
  }
  currents_reg<NB>(s + L::GPC, v_nl, i);
  matvec_reg<M, M>(k_eff, i, ki);
#pragma unroll
  for (int r = 0; r < M; ++r) f[r] = v_nl[r] - p[r] - ki[r];
  return max_abs_reg(f);
}

template <int N>
__device__ __forceinline__ bool failed_reg(const double (&v)[N],
                                           double resid, int n_nodes) {
  bool nonfin = false;
#pragma unroll
  for (int r = 0; r < N; ++r) nonfin = nonfin || !finite(v[r]);
  return resid > 1e-3 || max_abs_reg(v, n_nodes) > 55.0 || nonfin;
}

// mna_step in registers with no extra sources (the tremolo's), on the
// solver rows v (N), i (M), v_nl (M), resid, diag (5) from row 0 of st
template <int N, int M, int NB, int ITERS>
__device__ __forceinline__ void mna_step_reg(const double* s_in, Rows st) {
  using L = SL<N, M, NB>;
  constexpr int RESID = N + 2 * M, DIAG = RESID + 1;
  double v0[N], i0[M], vnl0[M];
#pragma unroll
  for (int r = 0; r < N; ++r) v0[r] = st[r];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    i0[r] = st[N + r];
    vnl0[r] = st[N + M + r];
  }
  const double cooldown = st[DIAG];
  const int n_nodes = (int)s_in[L::N_NODES];
  const bool trap_primary = s_in[L::TRAP_PRIMARY] != 0.0;
  double v[N], i_new[M], v_nl[M], resid = 0.0;
  bool need_be = false;
  // solve_once: the trapezoidal pass, then the BE replay where needed
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const double* s = s_in + opaque_zero();
    const bool be = pass == 1;
    const double* a_hist = s + (be ? L::AHBE : L::AH);
    const double* s_mat = s + (be ? L::SBE : L::S);
    const double* s_ni = s + (be ? L::SNIBE : L::SNI);
    const double* k_eff = s + (be ? L::KBE : L::K);
    const double* w_sc = s + (be ? L::WSBE : L::WS);
    const double trap_i = be ? 0.0 : s[L::TRAP_I];
    double rhs[N], t[N], v_lin[N], p[M];
    matvec_reg<N, N>(a_hist, v0, rhs);
#pragma unroll
    for (int r = 0; r < N; ++r)
      rhs[r] = rhs[r] + w_sc[r] * s[L::W + r] + 0.0;  // w_extra = 0
    matvec_reg<N, M>(s + L::NI, i0, t);
#pragma unroll
    for (int r = 0; r < N; ++r) rhs[r] = rhs[r] + trap_i * t[r];
    matvec_reg<N, N>(s_mat, rhs, v_lin);
    matvec_reg<M, N>(s + L::NV, v_lin, p);
#pragma unroll
    for (int r = 0; r < M; ++r) v_nl[r] = vnl0[r];
    resid = nr_solve_reg<N, M, NB, ITERS>(s, k_eff, p, v_nl, i_new);
    matvec_reg<N, M>(s_ni, i_new, t);
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = v_lin[r] + t[r];
    if (be) break;
    need_be = trap_primary &&
              (failed_reg<N>(v, resid, n_nodes) || cooldown > 0.0);
    if (!need_be) break;
  }
  const double* s = s_in + opaque_zero();
  const bool fail = failed_reg<N>(v, resid, n_nodes);
  double dv[N];
#pragma unroll
  for (int r = 0; r < N; ++r) dv[r] = v[r] - v0[r];
  const double dv_max = max_abs_reg(dv);
  const bool damp_hit = finite(dv_max) && dv_max > 30.0;
  const double scale = damp_hit ? 30.0 / jmax(dv_max, 1e-30) : 1.0;
  bool bad = false;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    v[r] = v0[r] + dv[r] * scale;
    bad = bad || !finite(v[r]);
  }
#pragma unroll
  for (int r = 0; r < N; ++r) st[r] = bad ? s[L::VDC + r] : v[r];
#pragma unroll
  for (int r = 0; r < M; ++r) {
    st[N + r] = bad ? s[L::IDC + r] : i_new[r];
    st[N + M + r] = bad ? s[L::VNLDC + r] : v_nl[r];
  }
  st[RESID] = resid;
  st[DIAG] = fail ? 64.0 : (cooldown - 1.0 > 0.0 ? cooldown - 1.0 : 0.0);
  st[DIAG + 1] = st[DIAG + 1] + (fail ? 1.0 : 0.0);
  st[DIAG + 2] = st[DIAG + 2] + (bad ? 1.0 : 0.0);
  st[DIAG + 3] = st[DIAG + 3] + (damp_hit ? 1.0 : 0.0);
  st[DIAG + 4] = st[DIAG + 4] + (need_be ? 1.0 : 0.0);
}

// tremolo_step in registers on the frame's tremolo rows; s the staged
// oscillator block, misc the staged scalars
__device__ __noinline__ double tremolo_step_reg(const double* s,
                                                const double* misc, Rows f,
                                                double depth) {
  const Rows tr = f.at(TR_TREM);
  mna_step_reg<7, 4, 2, 4>(s, tr);
  const double v_out = tr[(int)misc[M_TREM_OUT]];
  double env = tr[CH_TREM_ENV - CH_TREM_V], r_ldr;
  const double shunt = vactrol_shunt(misc, v_out, depth, &env, &r_ldr);
  tr[CH_TREM_ENV - CH_TREM_V] = env;
  tr[CH_TREM_RLDR - CH_TREM_V] = r_ldr;
  return shunt;
}

// ── the twin DK preamp in registers (the staged block: A_neg and S_base
// transposed) ──

// init_preamp on the PreState rows
__device__ __forceinline__ void init_dk_rows(const double* pc, Rows ps) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int n = 0; n < 8; ++n) ps[PS_V + 8 * r + n] = pc[PR_V_DC + n];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      ps[PS_I + 2 * r + k] = pc[PR_I_NL_DC + k];
      ps[PS_VNL + 2 * r + k] = pc[PR_V_NL_DC + k];
    }
    ps[PS_JCIN + r] = pc[PR_J_CIN_DC];
    ps[PS_CINPREV + r] = pc[PR_J_CIN_DC];
  }
  ps[PS_GPREV] = 1.0 / 1000000.0;
}

// preamp_step on the PreState rows ps, each twin's predictor and
// corrector in a loop of its own (the twin's rows in registers, its
// predictor parked in its v rows, its corrected values in its rows until
// the reset test); → main − shadow
__device__ __noinline__ double dk_step_reg(const double* pc, Rows ps,
                                           double g, double x) {
  const double gprev = ps[PS_GPREV];
  const double sm_k = g / (1.0 + pc[PR_S_FB_FB] * g);
  double cin[2] = {0.0, 0.0}, p0[2] = {0.0, 0.0}, p1[2] = {0.0, 0.0};
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const double* pz = pc + opaque_zero();
    const Rows tw = ps.at(8 * r);
    double v[8], rhs[8], vpb[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) v[n] = tw[PS_V + n];
    matvec_reg<8, 8>(pz + PR_A_NEG, v, rhs);
    rhs[FB] = rhs[FB] + (-gprev) * v[FB];
    const double u = r == 0 ? x : 0.0;
    const double cin_now = pz[PR_G_CIN] * u + ps[PS_JCIN + r];
    rhs[B1] = rhs[B1] + (cin_now + ps[PS_CINPREV + r]);
    const double i0 = ps[PS_I + 2 * r], i1 = ps[PS_I + 2 * r + 1];
    rhs[E1] = rhs[E1] + i0;
    rhs[C1] = rhs[C1] + (-i0);
    rhs[E2] = rhs[E2] + i1;
    rhs[C2] = rhs[C2] + (-i1);
#pragma unroll
    for (int n = 0; n < 8; ++n) rhs[n] = rhs[n] + pz[PR_TWO_W + n];
    matvec_reg<8, 8>(pz + PR_S_BASE, rhs, vpb);
    double vp[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      vp[n] = vpb[n] - (sm_k * vpb[FB]) * pz[PR_S_FB_COL + n];
      tw[PS_V + n] = vp[n];  // the old v is read no more
    }
    const double q0 = vp[B1] - vp[E1], q1 = vp[C1] - vp[E2];
    cin[0] = r == 0 ? cin_now : cin[0];
    cin[1] = r == 0 ? cin[1] : cin_now;
    p0[0] = r == 0 ? q0 : p0[0];
    p0[1] = r == 0 ? p0[1] : q0;
    p1[0] = r == 0 ? q1 : p1[0];
    p1[1] = r == 0 ? p1[1] : q1;
  }
  double kc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) kc[k] = pc[PR_K + k] - sm_k * pc[PR_K_OUTER + k];
  double v0[2], v1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    v0[r] = ps[PS_VNL + 2 * r];
    v1[r] = ps[PS_VNL + 2 * r + 1];
  }
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
    double f0[2], f1[2], gm0[2], gm1[2];
    bool conv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      double ic0, ic1;
      bjt_ic_gm(v0[r], &ic0, &gm0[r]);
      bjt_ic_gm(v1[r], &ic1, &gm1[r]);
      f0[r] = v0[r] - p0[r] - kc[0] * ic0 - kc[1] * ic1;
      f1[r] = v1[r] - p1[r] - kc[2] * ic0 - kc[3] * ic1;
      conv[r] = fabs(f0[r]) < 1e-9 && fabs(f1[r]) < 1e-9;
    }
    if (conv[0] && conv[1]) break;
#pragma unroll
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
  // the corrector, twin by twin, into the twin's rows; then the reset to
  // the DC point on a non-finite output
  double out_n[2] = {0.0, 0.0};
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const double* pz = pc + opaque_zero();
    const Rows tw = ps.at(8 * r);
    const double a0 = r == 0 ? v0[0] : v0[1];
    const double a1 = r == 0 ? v1[0] : v1[1];
    double ic0, ic1, gm;
    bjt_ic_gm(a0, &ic0, &gm);
    bjt_ic_gm(a1, &ic1, &gm);
    const double dot = pz[PR_SFB_NI] * ic0 + pz[PR_SFB_NI + 1] * ic1;
    double b1 = 0.0, o = 0.0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const double s_ni = ic0 * pz[PR_NI_COL0 + n] + ic1 * pz[PR_NI_COL1 + n];
      const double v_new =
          tw[PS_V + n] + s_ni - (sm_k * dot) * pz[PR_S_FB_COL + n];
      tw[PS_V + n] = v_new;
      b1 = n == B1 ? v_new : b1;
      o = n == OUTN ? v_new : o;
    }
    const double u = r == 0 ? x : 0.0;
    const double jc =
        -pz[PR_GC_1PC] * (u - b1) - pz[PR_C_CIN] * ps[PS_JCIN + r];
    ps[PS_I + 2 * r] = ic0;
    ps[PS_I + 2 * r + 1] = ic1;
    ps[PS_VNL + 2 * r] = a0;
    ps[PS_VNL + 2 * r + 1] = a1;
    ps[PS_JCIN + r] = jc;
    ps[PS_CINPREV + r] = r == 0 ? cin[0] : cin[1];
    out_n[0] = r == 0 ? o : out_n[0];
    out_n[1] = r == 0 ? out_n[1] : o;
  }
  const double out = out_n[0] - out_n[1];
  const bool bad = !finite(out);
  if (bad) {
    init_dk_rows(pc, ps);
  }
  ps[PS_GPREV] = g;
  return bad ? 0.0 : out;
}

// ── the twin melange preamp in registers (the staged block: every
// matrix transposed, the BJTs' parameters too) ──

// x[sel] of an unrolled array, sel chosen at run time (x[0] if none)
template <int K>
__device__ __forceinline__ double pick(const double (&x)[K], int sel) {
  double y = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) y = k == sel ? x[k] : y;
  return y;
}

// K_corr = K − sm_k · K_outer (melange_step's kc), entry (r, c), from the
// staged block where it is used: 25 values are too many to keep live
// through Newton
__device__ __forceinline__ double kcorr(const double* mc, double sm_k, int r,
                                        int c) {
  return mc[ML_K + c * 5 + r] - sm_k * mc[ML_K_OUTER + c * 5 + r];
}

// mel_currents on the staged block
__device__ __forceinline__ void mel_currents_reg(const double* mc,
                                                 const double (&vnl)[5],
                                                 double (&i)[5]) {
  currents_reg<2>(mc + ML_CUR, vnl, i);
  i[4] = mc[ML_DIODE] * (limexp(vnl[4] / mc[ML_DIODE + 1]) - 1.0);
}

// melange_step on the MelState rows ms; `scale` is noise_enabled ·
// noise_gain; → main − shadow. Each twin's predictor, corrector and
// Newton update run in loops over the twins (the twin's rows in
// registers, its predictor parked in its v rows); the residual passes of
// both twins run together.
__device__ __noinline__ double melange_step_reg(const double* mc, Rows ms,
                                                double g, double x,
                                                double scale) {
  constexpr int N = 13, M = 5, NR = 10;
  const int fb = (int)mc[ML_IDX], outn = (int)mc[ML_IDX + 1];
  const int row_in = (int)mc[ML_IDX + 2];
  // the key advances on every step; the noise enters the main row only.
  // Each draw replaces its row of the last draws once read (melange_step
  // writes them all at its end; nothing reads them between).
  const uint32_t k1 = (uint32_t)ms[MS_KEY], k2 = (uint32_t)ms[MS_KEY + 1];
  const uint2 nk = threefry_pair(k1, k2, 0u, 0u);
  const uint2 sk = threefry_pair(k1, k2, 0u, 1u);
  // the noise current inject · (w_new + w_prev), its columns summed in
  // index order as each draw comes
  double i_noise[N];
#pragma unroll 1
  for (int r = 0; r < NR; ++r) {
    const double w_new =
        normal_draw<true>(sk.x, sk.y, (uint32_t)r) * mc[ML_SIGMA + r] * scale;
    const double i_r = w_new + ms[MS_WPREV + r];
    ms[MS_WPREV + r] = w_new;
    const double* col = mc + ML_INJECT + r * N;
#pragma unroll
    for (int n = 0; n < N; ++n)
      i_noise[n] = r == 0 ? col[n] * i_r : i_noise[n] + col[n] * i_r;
  }
  const double gprev = ms[MS_GPREV];
  const double sm_k = g / (1.0 + mc[ML_S_FB_FB] * g);
  // each twin's predictor into its v rows (the old v is read no more),
  // its ports' p
  double p[2][M];
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const double* mz = mc + opaque_zero();
    const Rows tv = ms.at(N * r), ti = ms.at(M * r);
    double v[N], ii[M], rhs[N], t[N], vpb[N], v_pred[N], q[M];
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] = tv[MS_V + n];
#pragma unroll
    for (int m = 0; m < M; ++m) ii[m] = ti[MS_I + m];
    matvec_reg<N, N>(mz + ML_A_HIST, v, rhs);
    const double v_fb = pick(v, fb);
#pragma unroll
    for (int n = 0; n < N; ++n)
      rhs[n] = n == fb ? rhs[n] + (-gprev) * v_fb : rhs[n];
#pragma unroll
    for (int n = 0; n < N; ++n) rhs[n] = rhs[n] + mz[ML_WS_W + n];
#pragma unroll
    for (int n = 0; n < N; ++n)
      rhs[n] = n == row_in ? rhs[n] + (r == 0 ? x : 0.0) : rhs[n];
    matvec_reg<N, M>(mz + ML_N_I, ii, t);
#pragma unroll
    for (int n = 0; n < N; ++n) rhs[n] = rhs[n] + t[n];
#pragma unroll
    for (int n = 0; n < N; ++n) rhs[n] = rhs[n] + (r == 0 ? i_noise[n] : 0.0);
    matvec_reg<N, N>(mz + ML_S, rhs, vpb);
    const double vpb_fb = pick(vpb, fb);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      v_pred[n] = vpb[n] - (sm_k * vpb_fb) * mz[ML_S_FB_COL + n];
      tv[MS_V + n] = v_pred[n];
    }
    matvec_reg<M, N>(mz + ML_N_V, v_pred, q);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      p[0][m] = r == 0 ? q[m] : p[0][m];
      p[1][m] = r == 0 ? p[1][m] : q[m];
    }
  }
  double vnl[2][M];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < M; ++m) vnl[r][m] = ms[MS_VNL + M * r + m];
  // at most 12 Newton iterations; a converged twin stays put, and the
  // loop ends once both have (the rest would change nothing)
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    const double* mz = mc + opaque_zero();
    double f[2][M];
    bool conv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      double i[M];
      mel_currents_reg(mz, vnl[r], i);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        double ki = kcorr(mz, sm_k, m, 0) * i[0];
#pragma unroll
        for (int c = 1; c < M; ++c) ki = ki + kcorr(mz, sm_k, m, c) * i[c];
        f[r][m] = vnl[r][m] - p[r][m] - ki;
      }
      conv[r] = max_abs_reg(f[r]) < 1e-9;
    }
    if (conv[0] && conv[1]) break;
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {
      if (r == 0 ? conv[0] : conv[1]) continue;
      const double* mw = mc + opaque_zero();
      double vv[M], top[4], bot[4], dv[M], val, dval;
#pragma unroll
      for (int m = 0; m < M; ++m) vv[m] = r == 0 ? vnl[0][m] : vnl[1][m];
      derivs_reg<2>(mw + ML_DER, vv, top, bot);
      limexp_d(vv[4] / mw[ML_DIODE + 1], &val, &dval);
      const double g_d = mw[ML_DIODE] * dval / mw[ML_DIODE + 1];
      float aug[M][M + 1];
#pragma unroll
      for (int m = 0; m < M; ++m) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int r0 = 2 * (k / 2);
          aug[m][k] = (float)((m == k ? 1.0 : 0.0) -
                              (kcorr(mw, sm_k, m, r0) * top[k] +
                               kcorr(mw, sm_k, m, r0 + 1) * bot[k]));
        }
        aug[m][4] =
            (float)((m == 4 ? 1.0 : 0.0) - kcorr(mw, sm_k, m, 4) * g_d);
        aug[m][M] = (float)(r == 0 ? f[0][m] : f[1][m]);
      }
      ge_solve_f32_reg<M>(aug, dv);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const double nv = vv[m] - jclip(dv[m], -0.5, 0.5);
        vnl[0][m] = r == 0 ? nv : vnl[0][m];
        vnl[1][m] = r == 0 ? vnl[1][m] : nv;
      }
    }
  }
  // the corrector, twin by twin, into the twin's rows; then the reset to
  // the DC point on a non-finite output
  double out_n[2] = {0.0, 0.0};
#pragma unroll 1
  for (int r = 0; r < 2; ++r) {
    const double* mz = mc + opaque_zero();
    const Rows tv = ms.at(N * r), ti = ms.at(M * r);
    double vv[M], i[M], s_ni[N];
#pragma unroll
    for (int m = 0; m < M; ++m) vv[m] = r == 0 ? vnl[0][m] : vnl[1][m];
    mel_currents_reg(mz, vv, i);
    matvec_reg<N, M>(mz + ML_S_NI, i, s_ni);
    double dot = mz[ML_SFB_NI] * i[0];
#pragma unroll
    for (int c = 1; c < M; ++c) dot = dot + mz[ML_SFB_NI + c] * i[c];
    double o = 0.0;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const double v_new =
          tv[MS_V + n] + s_ni[n] - (sm_k * dot) * mz[ML_S_FB_COL + n];
      tv[MS_V + n] = v_new;
      o = n == outn ? v_new : o;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      ti[MS_I + m] = i[m];
      ti[MS_VNL + m] = vv[m];
    }
    out_n[0] = r == 0 ? o : out_n[0];
    out_n[1] = r == 0 ? out_n[1] : o;
  }
  const double out = out_n[0] - out_n[1];
  const bool bad = !finite(out);
  if (bad) {
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {
      const Rows tv = ms.at(N * r), ti = ms.at(M * r);
#pragma unroll
      for (int n = 0; n < N; ++n) tv[MS_V + n] = mc[ML_V_DC + n];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        ti[MS_I + m] = mc[ML_I_DC + m];
        ti[MS_VNL + m] = mc[ML_V_NL_DC + m];
      }
    }
  }
  ms[MS_GPREV] = g;
  ms[MS_KEY] = (double)nk.x;
  ms[MS_KEY + 1] = (double)nk.y;
  return bad ? 0.0 : out;
}

// init_melange on the MelState rows
__device__ __forceinline__ void init_melange_rows(const double* mc,
                                                  Rows ms) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int n = 0; n < 13; ++n) ms[MS_V + 13 * r + n] = mc[ML_V_DC + n];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      ms[MS_I + 5 * r + m] = mc[ML_I_DC + m];
      ms[MS_VNL + 5 * r + m] = mc[ML_V_NL_DC + m];
    }
  }
  ms[MS_GPREV] = 1.0 / 1000000.0;
  ms[MS_KEY] = 0.0;
  ms[MS_KEY + 1] = 24301.0;  // 0x5EED
#pragma unroll
  for (int r = 0; r < 10; ++r) ms[MS_WPREV + r] = 0.0;
}

// ── the rest of the chain on the frame ──

__device__ __forceinline__ double branch_step_rows(const double* coeffs,
                                                   Rows st, double x) {
  double y = x;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double out = coeffs[k] * y + st[k];
    st[k] = y - coeffs[k] * out;
    y = out;
  }
  return y;
}

__device__ __forceinline__ double smoother_next_rows(Rows s) {
  const bool active = s[3] > 0.0;
  double nxt = active ? s[0] + s[2] : s[0];
  const double rem = active ? s[3] - 1.0 : s[3];
  nxt = (active && rem == 0.0) ? s[1] : nxt;
  s[0] = nxt;
  s[3] = rem;
  return nxt;
}

// speaker_design, inline
__device__ __forceinline__ Speaker speaker_coeffs(double chr, double sr) {
  const double cc = jclip(chr, 0.0, 1.0);
  return Speaker{design(false, 20.0 * pow(30.0 / 20.0, cc), 0.75, sr),
                 design(true, 20000.0 * pow(5500.0 / 20000.0, cc), 0.707, sr),
                 0.2 * cc, 0.6 * cc, 2.0 * cc, cc};
}

// speaker_step on the frame's speaker rows
__device__ __forceinline__ double speaker_step_rows(const Speaker& sk,
                                                    Rows spk, double x,
                                                    double alpha) {
  double z[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) z[q] = spk[q];
  const double y = speaker_step(sk, z, x, alpha);
#pragma unroll
  for (int q = 0; q < 5; ++q) spk[q] = z[q];
  return y;
}

// the speaker's coefficients to and from their frame rows
__device__ __forceinline__ void put_speaker(const Speaker& k, Rows r) {
  const double* q = reinterpret_cast<const double*>(&k);
#pragma unroll
  for (int j = 0; j < SPK_COEFFS; ++j) r[j] = q[j];
}

__device__ __forceinline__ Speaker get_speaker(Rows r) {
  Speaker k;
  double* q = reinterpret_cast<double*>(&k);
#pragma unroll
  for (int j = 0; j < SPK_COEFFS; ++j) q[j] = r[j];
  return k;
}

// chain_sample<PRE, PA_BEHAVIORAL> on the frame f; s_trem, s_pre and misc
// the staged blocks; pa the power amp's constants and row the engine's
// chain row (guard #2's reset of the power amp's rows); last_char and
// spk_k the speaker's character and coefficients of the engine (with the
// melange preamp the coefficients in the frame, spk_k unused)
template <int PRE>
__device__ __forceinline__ double chain_sample_reg(
    const double* s_trem, const double* s_pre, const double* misc,
    const double* pa, double* row, Rows f, double mono, double noise_scale,
    double& last_char, Speaker& spk_k) {
  const double depth = smoother_next_rows(f.at(TR_SM_DEPTH));
  const double vol = smoother_next_rows(f.at(TR_SM_VOLUME));
  const double chr = smoother_next_rows(f.at(TR_SM_CHAR));
  const bool os = misc[M_OVERSAMPLE] != 0.0;
  double u0 = mono, u1 = 0.0;
  if (os) {
    u0 = branch_step_rows(kBranchA, f.at(CH_OS_UP_A), mono);
    u1 = branch_step_rows(kBranchB, f.at(CH_OS_UP_B), mono);
  }
  // the nonlinear step (tremolo → LDR → preamp → behavioral power amp) at
  // one call site: once, or twice oversampled
  double y0 = 0.0, y1 = 0.0;
#pragma unroll 1
  for (int h = 0; h < (os ? 2 : 1); ++h) {
    const double shunt = tremolo_step_reg(s_trem, misc, f, depth);
    const double g = 1.0 / jmax(shunt, 1000.0);
    const double u = h == 0 ? u0 : u1;
    double pre;
    if constexpr (PRE == PRE_DK)
      pre = dk_step_reg(s_pre, f.at(TR_PRE), g, u);
    else
      pre = melange_step_reg(s_pre, f.at(TR_PRE), g, u, noise_scale);
    const double drive = 0.25;  // tables.FIXED_CIRCUIT_DRIVE
    const double y = behavioral_core(pre * drive);
    y0 = h == 0 ? y : y0;
    y1 = h == 0 ? y1 : y;
  }
  double amp_out = y0;
  if (os) {
    const double a = branch_step_rows(kBranchA, f.at(CH_OS_DOWN_A), y0);
    const double b = branch_step_rows(kBranchB, f.at(CH_OS_DOWN_B), y1);
    amp_out = (a + f[CH_OS_DELAY]) * 0.5;
    f[CH_OS_DELAY] = b;
  }
  // speaker: coefficients redesigned only when the character moved
  using TRows = ThreadRows<PRE>;
  if (__double_as_longlong(chr) != __double_as_longlong(last_char)) {
    last_char = chr;
    if constexpr (TRows::SPK_IN_FRAME)
      put_speaker(speaker_coeffs(chr, misc[M_SPK_SR]), f.at(TRows::SPK_K));
    else
      spk_k = speaker_coeffs(chr, misc[M_SPK_SR]);
  }
  if constexpr (TRows::SPK_IN_FRAME) spk_k = get_speaker(f.at(TRows::SPK_K));
  const Rows spk = f.at(TR_SPK);
  const double y = speaker_step_rows(spk_k, spk, amp_out, misc[M_SPK_ALPHA]);
  const double out = y * misc[M_POST_GAIN] * vol;
  if (!finite(out)) {
    // NaN guard #2: preamp (the melange one's noise key and draws
    // included), oversampler, power amp and speaker reset
#pragma unroll
    for (int k = 0; k < OS_ROWS; ++k) f[CH_OS_UP_A + k] = 0.0;
    if constexpr (PRE == PRE_DK)
      init_dk_rows(s_pre, f.at(TR_PRE));
    else
      init_melange_rows(s_pre, f.at(TR_PRE));
    init_power_amp(pa, row);
#pragma unroll
    for (int k = 0; k < 5; ++k) spk[k] = 0.0;
    return 0.0;
  }
  return out;
}

// engine_chain_kernel<PRE, PA_BEHAVIORAL>'s body: the block stages the
// constants and its engines' rows (coalesced: the block's rows are
// consecutive in the chain), each thread runs its engine's samples on its
// column of the frame, and the block stores the rows back
template <int PRE>
__device__ __forceinline__ void chain_thread_behavioral(
    const double* __restrict__ c, const double* __restrict__ mono,
    double* chain, float* out, int n, int b, const double* noise_scale) {
  constexpr int ROWS = ThreadRows<PRE>::N;
  constexpr int PRE_BLOCK = PRE == PRE_MELANGE ? (int)ML_SIZE : PR_SIZE;
  __shared__ double s_trem[TREM_BLOCK];
  __shared__ double s_pre[PRE_BLOCK];
  __shared__ double s_misc[N_MISC];
  __shared__ double frame[ROWS * E2_BLOCK];
  stage_block<7, 4, 2>(c + C_TREM, s_trem);
  if constexpr (PRE == PRE_MELANGE)
    stage_melange(c + C_MEL, s_pre);
  else
    stage_dk(c + C_PRE, s_pre);
  for (int k = threadIdx.x; k < N_MISC; k += blockDim.x)
    s_misc[k] = c[C_MISC + k];
  const int e0 = blockIdx.x * E2_BLOCK;
  const int nb = min(E2_BLOCK, b - e0);
  double* rows = chain + (size_t)e0 * CHAIN_ROWS;
  for (int q = threadIdx.x; q < nb * CHAIN_ROWS; q += blockDim.x) {
    const int r = thread_row<PRE>(q % CHAIN_ROWS);
    if (r >= 0) frame[r * E2_BLOCK + q / CHAIN_ROWS] = rows[q];
  }
  __syncthreads();
  if ((int)threadIdx.x < nb) {
    const int e = e0 + threadIdx.x;
    const Rows f{frame + threadIdx.x};
    double last_char = __longlong_as_double(0x7ff8dead0000beefLL);  // NaN
    Speaker spk_k;
    const double ns = noise_scale[e];
    double* row = chain + (size_t)e * CHAIN_ROWS;
    for (int t = 0; t < n; ++t) {
      const size_t i = (size_t)e * n + t;
      const int z = opaque_zero();
      out[i] = (float)chain_sample_reg<PRE>(
          s_trem + z, s_pre + z, s_misc + z, c + C_PA, row, f, mono[i], ns,
          last_char, spk_k);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nb * CHAIN_ROWS; q += blockDim.x) {
    const int r = thread_row<PRE>(q % CHAIN_ROWS);
    if (r >= 0) rows[q] = frame[r * E2_BLOCK + q / CHAIN_ROWS];
  }
}

template <int PRE, int PA>
__global__ void engine_chain_kernel(const double* __restrict__ c,
                                    const double* __restrict__ mono,
                                    double* chain, float* out, int n, int b,
                                    const unsigned char* sag,
                                    const double* noise_scale) {
  if constexpr (PA == PA_BEHAVIORAL) {
    chain_thread_behavioral<PRE>(c, mono, chain, out, n, b, noise_scale);
  } else {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= b) return;
    double ch[CHAIN_ROWS];
    for (int k = 0; k < CHAIN_ROWS; ++k)
      ch[k] = chain[(size_t)e * CHAIN_ROWS + k];
    double last_char = __longlong_as_double(0x7ff8dead0000beefLL);  // NaN
    Speaker spk_k;
    for (int t = 0; t < n; ++t) {
      const size_t i = (size_t)e * n + t;
      out[i] = (float)chain_sample<PRE, PA>(c, ch, mono[i], sag[e] != 0,
                                            noise_scale[e], &last_char,
                                            &spk_k);
    }
    for (int k = 0; k < CHAIN_ROWS; ++k)
      chain[(size_t)e * CHAIN_ROWS + k] = ch[k];
  }
}

// E2's warp form: a warp per engine. Lane 0 runs what has no parallel
// rows: the smoothers, the oversampler's allpass branches, the speaker and
// guard #2's test, on the chain rows it holds in `ch`. The whole warp runs
// the tremolo's mna step (mna_step_warp), the preamp's step (dk_step_warp
// or melange_step_warp) and, for the circuit power amp, its mna step, their
// constant blocks staged in shared memory per block, and guard #2's reset
// of their rows; the preamp's input goes from lane 0 to the warp by
// __shfl_sync. The behavioral power amp is memoryless and scalar:
// behavioral() runs on every lane with the same input, its rows stay in
// lane 0's `ch` (guard #2 resets them there, as the thread form does), and
// no power-amp block is staged. Every value and branch is the thread
// kernel's, so the two forms agree bit for bit.
constexpr int E2_WARPS = 4;  // engines (warps) per block

// a warp's preamp rows, and its staged block's size
template <int PRE> struct PreWarpOf {
  using T = DkWarp;
  static constexpr int BLOCK = PR_SIZE;
};
template <> struct PreWarpOf<PRE_MELANGE> {
  using T = MelWarp;
  static constexpr int BLOCK = ML_SIZE;
};
template <int PRE> using PreWarp = typename PreWarpOf<PRE>::T;

// a warp's power-amp rows: PaWarp for the circuit; none for the
// behavioral power amp, which is memoryless (its rows stay in lane 0's
// `ch`, where only guard #2 writes them)
struct NoPa {};
template <int PA> struct PaWarpOf { using T = PaWarp; };
template <> struct PaWarpOf<PA_BEHAVIORAL> { using T = NoPa; };
template <int PA> using PaWarpT = typename PaWarpOf<PA>::T;

// the chain rows that the warp's states hold, not lane 0's `ch`
template <int PRE, int PA>
__device__ __forceinline__ bool warp_row(int k) {
  return (k >= CH_TREM_V && k <= CH_TREM_RLDR) ||
         (PA == PA_CIRCUIT && k >= CH_PA_V && k <= CH_PA_LAST) ||
         (PRE == PRE_MELANGE ? k >= CH_MEL_V
                             : k >= CH_PRE_V && k <= CH_PRE_GPREV);
}

// Where the behavioral warp form runs behavioral(): on every lane with
// the same input (1, the library) or on lane 0 alone (0); the bits are the
// same, tools/torch_chain_breakdown.py times the two
#ifndef OW_BEHAVIORAL_ALL_LANES
#define OW_BEHAVIORAL_ALL_LANES 1
#endif

// pre and s_pre: the preamp's rows and staged block; u lane 0's input;
// → the power amp's output (on every lane; with OW_BEHAVIORAL_ALL_LANES
// 0, the behavioral one on lane 0 alone)
template <int PRE, int PA>
__device__ __forceinline__ double nonlinear_step_warp(
    const double* misc, TremWarp& tr, PaWarpT<PA>& pa, PreWarp<PRE>& pre,
    const double* s_trem, const double* s_pa, const double* s_pre,
    WarpScratch* w, double depth, double u, bool sag, double noise_scale) {
  const double shunt = tremolo_step_warp(s_trem, misc, tr, depth, w);
  const double g = 1.0 / jmax(shunt, 1000.0);
  const double x = __shfl_sync(FULL, u, 0);
  double y;
  if constexpr (PRE == PRE_DK)
    y = dk_step_warp(s_pre, pre, g, x, w);
  else
    y = melange_step_warp(s_pre, pre, g, x, noise_scale, w);
  const double drive = 0.25;  // tables.FIXED_CIRCUIT_DRIVE
  if constexpr (PA == PA_CIRCUIT) {
    return power_amp_step_warp(s_pa, misc, pa, y * drive, sag, w);
  } else {
    if (OW_BEHAVIORAL_ALL_LANES || (threadIdx.x & 31) == 0)
      return behavioral(y * drive);
    return 0.0;
  }
}

// chain_sample on a warp; → the output on lane 0
template <int PRE, int PA>
__device__ __noinline__ double chain_sample_warp(
    const double* c, double* ch, TremWarp& tr, PaWarpT<PA>& pa,
    PreWarp<PRE>& pre, const double* s_trem, const double* s_pa,
    const double* s_pre, WarpScratch* w, double mono, bool sag,
    double noise_scale, double* last_char, Speaker* spk_k) {
  const int lane = threadIdx.x & 31;
  const double* misc = c + C_MISC;
  double depth = 0.0, vol = 0.0, chr = 0.0;
  if (lane == 0) {
    depth = smoother_next(ch + CH_SM_DEPTH);
    vol = smoother_next(ch + CH_SM_VOLUME);
    chr = smoother_next(ch + CH_SM_CHAR);
  }
  depth = __shfl_sync(FULL, depth, 0);
  double amp_out = 0.0;
  if (misc[M_OVERSAMPLE] != 0.0) {
    double us[2] = {0.0, 0.0}, y[2];
    if (lane == 0) {
      us[0] = branch_step(kBranchA, ch + CH_OS_UP_A, mono);
      us[1] = branch_step(kBranchB, ch + CH_OS_UP_B, mono);
    }
#pragma unroll 1
    for (int h = 0; h < 2; ++h)
      y[h] = nonlinear_step_warp<PRE, PA>(misc, tr, pa, pre, s_trem, s_pa,
                                          s_pre, w, depth, us[h], sag,
                                          noise_scale);
    if (lane == 0) {
      const double a = branch_step(kBranchA, ch + CH_OS_DOWN_A, y[0]);
      const double b = branch_step(kBranchB, ch + CH_OS_DOWN_B, y[1]);
      amp_out = (a + ch[CH_OS_DELAY]) * 0.5;
      ch[CH_OS_DELAY] = b;
    }
  } else {
    amp_out = nonlinear_step_warp<PRE, PA>(misc, tr, pa, pre, s_trem, s_pa,
                                           s_pre, w, depth, mono, sag,
                                           noise_scale);
  }
  double out = 0.0;
  int bad = 0;
  if (lane == 0) {
    if (__double_as_longlong(chr) != __double_as_longlong(*last_char)) {
      *last_char = chr;
      speaker_design(chr, misc[M_SPK_SR], spk_k);
    }
    double* spk = ch + CH_SPK;
    const double y = speaker_step(*spk_k, spk, amp_out, misc[M_SPK_ALPHA]);
    out = y * misc[M_POST_GAIN] * vol;
    bad = !finite(out);
    if (bad) {
      // NaN guard #2: the oversampler and speaker here (and the
      // behavioral power amp's rows, as the thread form resets them); the
      // preamp (the melange one's noise key and draws included) and the
      // circuit power amp below
      for (int k = 0; k < OS_ROWS; ++k) ch[CH_OS_UP_A + k] = 0.0;
      if constexpr (PA == PA_BEHAVIORAL) init_power_amp(c + C_PA, ch);
      for (int k = 0; k < 5; ++k) spk[k] = 0.0;
      out = 0.0;
    }
  }
  if (__shfl_sync(FULL, bad, 0)) {
    if constexpr (PRE == PRE_DK)
      init_dk_warp(s_pre, pre, lane);
    else
      init_melange_warp(s_pre, pre, lane);
    if constexpr (PA == PA_CIRCUIT) init_power_amp_warp(s_pa, pa, lane);
  }
  return out;
}

template <int PRE, int PA>
__global__ void __launch_bounds__(E2_WARPS * 32)
engine_chain_warp_kernel(const double* __restrict__ c,
                         const double* __restrict__ mono, double* chain,
                         float* out, int n, int b, const unsigned char* sag,
                         const double* noise_scale) {
  constexpr bool MEL = PRE == PRE_MELANGE;
  constexpr bool CIRCUIT = PA == PA_CIRCUIT;
  constexpr int PRE_ROW = MEL ? CH_MEL_V : CH_PRE_V;
  __shared__ double s_trem[TREM_BLOCK];
  __shared__ double s_pa[CIRCUIT ? PA_BLOCK : 1];
  __shared__ double s_pre[PreWarpOf<PRE>::BLOCK];
  __shared__ WarpScratch scratch[E2_WARPS];
  if constexpr (CIRCUIT) stage_block<21, 16, 8>(c + C_PA, s_pa);
  stage_block<7, 4, 2>(c + C_TREM, s_trem);
  if constexpr (MEL)
    stage_melange(c + C_MEL, s_pre);
  else
    stage_dk(c + C_PRE, s_pre);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = blockIdx.x * (blockDim.x >> 5) + warp;
  if (e >= b) return;  // the whole warp: no block-wide sync follows
  double* row = chain + (size_t)e * CHAIN_ROWS;
  double ch[CHAIN_ROWS];  // lane 0's rows
  if (lane == 0)
    for (int k = 0; k < CHAIN_ROWS; ++k)
      ch[k] = warp_row<PRE, PA>(k) ? 0.0 : row[k];
  TremWarp tr;
  load_lane<7, 4>(tr.s, row + CH_TREM_V, 1, lane);
  tr.env = row[CH_TREM_ENV];
  tr.r_ldr = row[CH_TREM_RLDR];
  PaWarpT<PA> pa;
  if constexpr (CIRCUIT) load_pa(pa, row + CH_PA_V, 1, lane);
  PreWarp<PRE> pre;
  if constexpr (MEL)
    load_mel(pre, row + PRE_ROW, 1, lane);
  else
    load_dk(pre, row + PRE_ROW, 1, lane);
  double last_char = __longlong_as_double(0x7ff8dead0000beefLL);  // NaN
  Speaker spk_k;
  WarpScratch* w = &scratch[warp];
  for (int t = 0; t < n; ++t) {
    const size_t i = (size_t)e * n + t;
    const double y = chain_sample_warp<PRE, PA>(
        c, ch, tr, pa, pre, s_trem, s_pa, s_pre, w, mono[i], sag[e] != 0,
        noise_scale[e], &last_char, &spk_k);
    if (lane == 0) out[i] = (float)y;
  }
  if (lane == 0)
    for (int k = 0; k < CHAIN_ROWS; ++k)
      if (!warp_row<PRE, PA>(k)) row[k] = ch[k];
  if constexpr (MEL)
    store_mel(pre, row + PRE_ROW, 1, lane);
  else
    store_dk(pre, row + PRE_ROW, 1, lane);
  store_lane<7, 4>(tr.s, row + CH_TREM_V, 1, lane);
  if (lane == 0) {
    row[CH_TREM_ENV] = tr.env;
    row[CH_TREM_RLDR] = tr.r_ldr;
  }
  if constexpr (CIRCUIT) store_pa(pa, row + CH_PA_V, 1, lane);
}

// ═══════════════════ E2's half form: a half-warp per engine ═══════════════════
//
// engine_chain_half_kernel<PRE, PA>: two engines to a warp, each on a
// 16-lane segment (lane q = threadIdx.x % 16 of segment threadIdx.x / 16),
// on the blocks that the warp form stages. A segment runs what the warp
// form's warp runs, on this row map:
//  * the tremolo's mna step (mna_step_seg): node rows 0-6 and Newton rows
//    0-3 on lanes 0-6 and 0-3;
//  * the power amp's: its 16 Newton rows one per lane, its 21 node rows on
//    lanes 0-15 and, a second row on lanes 0-4 (v2), rows 16-20 for the
//    history matvec, v_lin and v;
//  * the DK twins (dk_step_seg) on the segment's two 8-lane quarters, 8
//    node rows each;
//  * the melange twins (melange_step_seg) on the segment's two quarters,
//    13 node rows each (8, and 5 as a second row) and 5 Newton rows;
//  * lane 0 of the segment runs what lane 0 runs in the warp form.
// The two engines of a warp diverge: Newton's early exit, the BE replay,
// the power amp's reset and guard #2 decide per engine. Every shuffle and
// __syncwarp needs both segments, so the control flow around them is the
// warp's: a loop runs until both engines are done, a finished engine's
// values frozen by selects (or, in the preamps' Newton, by its own
// convergence mask), a pass that one engine needs runs on both and the
// other keeps its values, and the votes are the segment's bits of a
// ballot. A batch of odd B leaves the last warp's second segment without
// an engine: it runs its neighbour's engine and stores nothing. Every
// value is the warp form's function of the same operands, so the three
// forms agree bit for bit. Each segment has its own WarpScratch: rows
// 0-15 at [q], second rows at [16 + q].

// Stamped parts (tools/chain_breakdown.cu builds the half form with
// -DOW_HALF_STAMPS=1; the library with 0, where half_switch is empty):
// each thread's clock64 cycles by part, in row (thread) of
// g_half_parts: HALF_PARTS sums, then the clock at the last switch and
// the part running since.
#ifndef OW_HALF_STAMPS
#define OW_HALF_STAMPS 0
#endif
enum HalfPart { HP_NEWTON, HP_VOTES, HP_LANE0, HP_REST, HALF_PARTS };
#if OW_HALF_STAMPS
__device__ long long* g_half_parts;
#endif
// the cycles since the last switch to the running part; `part` runs
// from here on; → the part that ran
__device__ __forceinline__ int half_switch(int part) {
#if OW_HALF_STAMPS
  long long* row = g_half_parts + (size_t)(blockIdx.x * blockDim.x +
                                           threadIdx.x) * (HALF_PARTS + 2);
  const long long now = clock64();
  const int prev = (int)row[HALF_PARTS + 1];
  row[prev] += now - row[HALF_PARTS];
  row[HALF_PARTS] = now;
  row[HALF_PARTS + 1] = part;
  return prev;
#else
  return part;
#endif
}

constexpr unsigned SEG = 0xffffu;  // a segment's bits in its own ballot

// this lane's segment's bits of a warp-wide ballot
__device__ __forceinline__ unsigned seg_ballot(bool p) {
  const int prev = half_switch(HP_VOTES);
  const unsigned bits = (__ballot_sync(FULL, p) >> (threadIdx.x & 16)) & SEG;
  half_switch(prev);
  return bits;
}
// the warp's vote (both segments): a loop's exit
__device__ __forceinline__ bool warp_all(bool p) {
  const int prev = half_switch(HP_VOTES);
  const bool all = __all_sync(FULL, p);
  half_switch(prev);
  return all;
}
__device__ __forceinline__ bool warp_any(bool p) {
  const int prev = half_switch(HP_VOTES);
  const bool any = __any_sync(FULL, p);
  half_switch(prev);
  return any;
}
__device__ __forceinline__ bool seg_all(bool p) {
  return seg_ballot(p) == SEG;
}
__device__ __forceinline__ bool seg_any(bool p) {
  return seg_ballot(p) != 0u;
}

// the segment's rows below n into buf: row q from lane q (x) and row
// 16 + q from lane q (x2); after it the segment reads buf
__device__ __forceinline__ void publish_seg(double* buf, double x, double x2,
                                            int q, int n) {
  __syncwarp();  // every lane has read buf's previous contents
  if (q < n) buf[q] = x;
  if (16 + q < n) buf[16 + q] = x2;
  __syncwarp();
}

// a segment's rows of a circuit's solver state: node rows q (v) and
// 16 + q (v2, below N), nonlinear row q (i, v_nl); resid and the counters
// the same on every lane of the segment
struct SegState {
  double v, v2, i, v_nl, resid, diag[5];
};

// nr_solve_warp on a segment. A segment whose rows have converged keeps
// its junction voltages (the select on v_nl), so its currents, residual
// and test stay what they were; the loop runs until both segments have
// converged, as the warp form's returns once its one engine has.
template <int N, int M, int NB, int ITERS>
__device__ __forceinline__ double nr_solve_seg(const double* s,
                                               const double* k_eff, double p,
                                               double& v_nl, double& i,
                                               WarpScratch* w, int q) {
  using L = SL<N, M, NB>;
  static_assert(M <= 16, "a Newton row per lane");
  const int r = min(q, M - 1);
  const double nvt = s[L::NVT + r], vcrit = s[L::VCRIT + r];
  const int outer = half_switch(HP_NEWTON);
  double f = 0.0;
#pragma unroll 1
  for (int it = 0;; ++it) {
    i = current_lane<NB, 16>(s + L::GPC, v_nl, q);
    publish_seg(w->a, i, 0.0, q, M);
    f = v_nl - p - row_dot<M, M>(k_eff, w->a, r);
    if (it == ITERS) break;
    const bool done = seg_all(q >= M || fabs(f) < 1e-9);
    if (warp_all(done)) break;
    double top, bot;
    derivs_lane<NB, 16>(s + L::GPD, v_nl, q, &top, &bot);
    __syncwarp();  // every lane has read a's currents
    if (q < M) {
      w->a[q] = top;
      w->b[q] = bot;
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
    const double dv = (double)ge_solve_f32_warp<M, 16>(aug, q);
    const double v_old = v_nl;
    const double v_new = v_old - jclip(dv, -2.0, 2.0);
    const double delta = v_new - v_old;
    const double lim = v_old + nvt * log1p(jmax(delta, 0.0) / nvt);
    const bool apply = (v_new > vcrit) && (delta > 2.0 * nvt);
    v_nl = done ? v_old : (apply ? lim : v_new);
  }
  publish_seg(w->b, f, 0.0, q, M);
  const double resid = max_abs(w->b, M);
  half_switch(outer);
  return resid;
}

// failed() on a segment: one vote over its node rows
template <int N>
__device__ __forceinline__ bool failed_seg(double v, double v2, double resid,
                                           int n_nodes, int q) {
  constexpr int N2 = N > 16 ? N - 16 : 0;
  const bool row = (q < n_nodes && fabs(v) > 55.0) || (q < N && !finite(v)) ||
                   (q < N2 && ((16 + q < n_nodes && fabs(v2) > 55.0) ||
                               !finite(v2)));
  const bool any = seg_any(row);
  return resid > 1e-3 || any;
}

// mna_step_warp on a segment, on the staged block `s`; w_extra and
// w_extra2 this lane's rows q and 16 + q of the extra source vector. The
// BE replay runs on both segments when either needs it; the other keeps
// its trapezoidal values.
template <int N, int M, int NB, int ITERS>
__device__ __noinline__ void mna_step_seg(const double* s, SegState& st,
                                          double w_extra, double w_extra2,
                                          WarpScratch* w) {
  using L = SL<N, M, NB>;
  constexpr int N2 = N > 16 ? N - 16 : 0;
  static_assert(N <= 32, "at most two node rows per lane");
  const int q = threadIdx.x & 15;
  const int rn = min(q, N - 1), rm = min(q, M - 1);
  const int rn2 = N2 > 0 ? 16 + min(q, N2 - 1) : rn;
  const int n_nodes = (int)s[L::N_NODES];
  const bool trap_primary = s[L::TRAP_PRIMARY] != 0.0;
  double v = 0.0, v2 = 0.0, i_new = 0.0, v_nl = 0.0, resid = 0.0;
  bool need_be = false;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    const bool be = pass == 1;
    const double* a_hist = s + (be ? L::AHBE : L::AH);
    const double* s_mat = s + (be ? L::SBE : L::S);
    const double* s_ni = s + (be ? L::SNIBE : L::SNI);
    const double* k_eff = s + (be ? L::KBE : L::K);
    const double* w_sc = s + (be ? L::WSBE : L::WS);
    const double trap_i = be ? 0.0 : s[L::TRAP_I];
    __syncwarp();
    if (q < N) w->a[q] = st.v;
    if (q < N2) w->a[16 + q] = st.v2;
    if (q < M) w->b[q] = st.i;
    __syncwarp();
    double rhs = row_dot<N, N>(a_hist, w->a, rn);
    rhs = rhs + w_sc[rn] * s[L::W + rn] + w_extra;
    rhs = rhs + trap_i * row_dot<N, M>(s + L::NI, w->b, rn);
    double rhs2 = 0.0;
    if constexpr (N2 > 0) {
      rhs2 = row_dot<N, N>(a_hist, w->a, rn2);
      rhs2 = rhs2 + w_sc[rn2] * s[L::W + rn2] + w_extra2;
      rhs2 = rhs2 + trap_i * row_dot<N, M>(s + L::NI, w->b, rn2);
    }
    publish_seg(w->a, rhs, rhs2, q, N);
    const double lin = row_dot<N, N>(s_mat, w->a, rn);
    double lin2 = 0.0;
    if constexpr (N2 > 0) lin2 = row_dot<N, N>(s_mat, w->a, rn2);
    publish_seg(w->a, lin, lin2, q, N);
    const double p = row_dot<M, N>(s + L::NV, w->a, rm);
    double vn = st.v_nl, in = 0.0;
    const double res = nr_solve_seg<N, M, NB, ITERS>(s, k_eff, p, vn, in,
                                                     w, q);
    publish_seg(w->a, in, 0.0, q, M);
    const double vv = lin + row_dot<N, M>(s_ni, w->a, rn);
    double vv2 = 0.0;
    if constexpr (N2 > 0) vv2 = lin2 + row_dot<N, M>(s_ni, w->a, rn2);
    if (be) {
      v = need_be ? vv : v;
      v2 = need_be ? vv2 : v2;
      i_new = need_be ? in : i_new;
      v_nl = need_be ? vn : v_nl;
      resid = need_be ? res : resid;
      break;
    }
    v = vv;
    v2 = vv2;
    i_new = in;
    v_nl = vn;
    resid = res;
    need_be = trap_primary && (failed_seg<N>(v, v2, resid, n_nodes, q) ||
                               st.diag[0] > 0.0);
    if (!warp_any(need_be)) break;
  }
  const bool fail = failed_seg<N>(v, v2, resid, n_nodes, q);
  const double dv = v - st.v, dv2 = v2 - st.v2;
  publish_seg(w->b, dv, dv2, q, N);
  const double dv_max = max_abs(w->b, N);
  const bool damp_hit = finite(dv_max) && dv_max > 30.0;
  const double scale = damp_hit ? 30.0 / jmax(dv_max, 1e-30) : 1.0;
  v = st.v + dv * scale;
  v2 = st.v2 + dv2 * scale;
  const bool bad =
      seg_any((q < N && !finite(v)) || (q < N2 && !finite(v2)));
  st.v = bad ? s[L::VDC + rn] : v;
  if constexpr (N2 > 0) st.v2 = bad ? s[L::VDC + rn2] : v2;
  st.i = bad ? s[L::IDC + rm] : i_new;
  st.v_nl = bad ? s[L::VNLDC + rm] : v_nl;
  st.resid = resid;
  double* dg = st.diag;
  dg[0] = fail ? 64.0 : (dg[0] - 1.0 > 0.0 ? dg[0] - 1.0 : 0.0);
  dg[1] = dg[1] + (fail ? 1.0 : 0.0);
  dg[2] = dg[2] + (bad ? 1.0 : 0.0);
  dg[3] = dg[3] + (damp_hit ? 1.0 : 0.0);
  dg[4] = dg[4] + (need_be ? 1.0 : 0.0);
}

// the lane's rows of a solver state (load_lane's layout) from `rows`
template <int N, int M>
__device__ void load_seg(SegState& st, const double* rows, int q) {
  constexpr int N2 = N > 16 ? N - 16 : 0;
  st.v = rows[min(q, N - 1)];
  st.v2 = 0.0;
  if constexpr (N2 > 0) st.v2 = rows[16 + min(q, N2 - 1)];
  st.i = rows[N + min(q, M - 1)];
  st.v_nl = rows[N + M + min(q, M - 1)];
  st.resid = rows[N + 2 * M];
  for (int k = 0; k < 5; ++k) st.diag[k] = rows[N + 2 * M + 1 + k];
}

template <int N, int M>
__device__ void store_seg(const SegState& st, double* rows, int q) {
  if (q < N) rows[q] = st.v;
  if (16 + q < N) rows[16 + q] = st.v2;
  if (q < M) {
    rows[N + q] = st.i;
    rows[N + M + q] = st.v_nl;
  }
  if (q == 0) {
    rows[N + 2 * M] = st.resid;
    for (int k = 0; k < 5; ++k) rows[N + 2 * M + 1 + k] = st.diag[k];
  }
}

// a segment's power amp (PaWarp's rows) and tremolo (TremWarp's)
struct PaSeg {
  SegState s;
  double rails[4], last;
};
struct TremSeg {
  SegState s;
  double env, r_ldr;
};

__device__ void load_pa_seg(PaSeg& pa, const double* rows, int q) {
  load_seg<21, 16>(pa.s, rows, q);
  for (int k = 0; k < 4; ++k) pa.rails[k] = rows[PA_RAILS + k];
  pa.last = rows[PA_RAILS + 4];
}

__device__ void store_pa_seg(const PaSeg& pa, double* rows, int q) {
  store_seg<21, 16>(pa.s, rows, q);
  if (q == 0) {
    for (int k = 0; k < 4; ++k) rows[PA_RAILS + k] = pa.rails[k];
    rows[PA_RAILS + 4] = pa.last;
  }
}

// the power amp's node, current and junction rows at the DC point
__device__ __forceinline__ void pa_rows_at_dc(const double* pa, SegState& s,
                                              int q) {
  s.v = pa[PaL::VDC + q];
  s.v2 = pa[PaL::VDC + 16 + min(q, 4)];
  s.i = pa[PaL::IDC + q];
  s.v_nl = pa[PaL::VNLDC + q];
}

// init_power_amp on a segment (the staged block's DC point)
__device__ __forceinline__ void init_power_amp_seg(const double* pa,
                                                   PaSeg& st, int q) {
  pa_rows_at_dc(pa, st.s, q);
  st.s.resid = 0.0;
  for (int k = 0; k < 5; ++k) st.s.diag[k] = 0.0;
  st.rails[0] = st.rails[1] = 22.5;
  st.rails[2] = st.rails[3] = 0.0;
  st.last = 0.0;
}

// power_amp_step_warp on a segment
__device__ __noinline__ double power_amp_step_seg(const double* pa,
                                                  const double* misc,
                                                  PaSeg& st, double x,
                                                  bool sag, WarpScratch* w) {
  const int q = threadIdx.x & 15, q2 = 16 + q;
  const double sag_f = sag ? 1.0 : 0.0;
  double* rails = st.rails;
  // the sources, in power_amp_step's order of assignment
  const double w1 = (rails[0] - 22.5) * sag_f;
  const double w2 = (rails[1] - 22.5) * sag_f;
  const int k_in = (int)misc[M_PA_IN], k_v2 = (int)misc[M_PA_V2],
            k_v1 = (int)misc[M_PA_V1];
  const double wx = q == k_in ? x : q == k_v2 ? w2 : q == k_v1 ? w1 : 0.0;
  const double wx2 =
      q2 == k_in ? x : q2 == k_v2 ? w2 : q2 == k_v1 ? w1 : 0.0;
  mna_step_seg<21, 16, 8, 16>(pa, st.s, wx, wx2, w);
  const int k_out = (int)misc[M_PA_OUT];
  const double raw =
      __shfl_sync(FULL, k_out < 16 ? st.s.v : st.s.v2, k_out, 16);
  const double result = raw / 22.0;
  const bool nr_failed = st.s.resid > 1e-3;
  const bool insane = seg_any(
      !finite(st.s.v) || fabs(st.s.v) > 100.0 ||
      (q < 5 && (!finite(st.s.v2) || fabs(st.s.v2) > 100.0)));
  const bool reset = !finite(result) || insane;
  const bool bad = reset || nr_failed;
  if (reset) pa_rows_at_dc(pa, st.s, q);
  const double out = bad ? st.last : jclip(result, -1.0, 1.0);
  st.last = out;
  if (sag) rails_after(misc, rails, raw, bad);
  return out;
}

// tremolo_step_warp on a segment
__device__ __noinline__ double tremolo_step_seg(const double* trem,
                                                const double* misc,
                                                TremSeg& st, double depth,
                                                WarpScratch* w) {
  mna_step_seg<7, 4, 2, 4>(trem, st.s, 0.0, 0.0, w);
  const double v_out =
      __shfl_sync(FULL, st.s.v, (int)misc[M_TREM_OUT], 16);
  return vactrol_shunt(misc, v_out, depth, &st.env, &st.r_ldr);
}

// The DK rows on a segment (DkWarp, one engine): lane q serves twin
// q / 8 and node row q % 8

__device__ void load_dk_seg(DkWarp& st, const double* rows, int q) {
  const int r = q >> 3, n = q & 7;
  st.v = rows[PS_V + 8 * r + n];
  for (int k = 0; k < 2; ++k) {
    st.i_nl[k] = rows[PS_I + 2 * r + k];
    st.v_nl[k] = rows[PS_VNL + 2 * r + k];
  }
  st.j_cin = rows[PS_JCIN + r];
  st.cin_prev = rows[PS_CINPREV + r];
  st.g_prev = rows[PS_GPREV];
}

__device__ void store_dk_seg(const DkWarp& st, double* rows, int q) {
  const int r = q >> 3, n = q & 7;
  rows[PS_V + 8 * r + n] = st.v;
  if (n < 2) {
    rows[PS_I + 2 * r + n] = n ? st.i_nl[1] : st.i_nl[0];
    rows[PS_VNL + 2 * r + n] = n ? st.v_nl[1] : st.v_nl[0];
  }
  if (n == 2) rows[PS_JCIN + r] = st.j_cin;
  if (n == 3) rows[PS_CINPREV + r] = st.cin_prev;
  if (q == 0) rows[PS_GPREV] = st.g_prev;
}

__device__ __forceinline__ void init_dk_seg(const double* s, DkWarp& st,
                                            int q) {
  init_dk_warp(s, st, q);
  st.v = s[PR_V_DC + (q & 7)];
}

// dk_step_warp on a segment: the twins on its two quarters. Newton's loop
// runs until all four twins of the warp have converged: a converged twin's
// update is masked (as preamp_step's), so its voltages, and the currents
// recomputed from them, stay what they were.
__device__ __noinline__ double dk_step_seg(const double* s, DkWarp& st,
                                           double g, double x,
                                           WarpScratch* w) {
  const int q = threadIdx.x & 15, r = q >> 3, n = q & 7;
  const double* a = w->a + 8 * r;  // this twin's published vector
  // the history, fb's LDR term, the sources, the input, two_w
  publish_seg(w->a, st.v, 0.0, q, 16);
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
  // the predictor, its LDR correction, the ports' p
  publish_seg(w->a, rhs, 0.0, q, 16);
  const double vpb = row_dot<8, 8>(s + PR_S_BASE, a, n);
  const double sm_k = g / (1.0 + s[PR_S_FB_FB] * g);
  const double vpb_fb = __shfl_sync(FULL, vpb, FB, 8);
  const double v_pred = vpb - (sm_k * vpb_fb) * s[PR_S_FB_COL + n];
  const double p0 = __shfl_sync(FULL, v_pred, B1, 8) -
                    __shfl_sync(FULL, v_pred, E1, 8);
  const double p1 = __shfl_sync(FULL, v_pred, C1, 8) -
                    __shfl_sync(FULL, v_pred, E2, 8);
  double kc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) kc[k] = s[PR_K + k] - sm_k * s[PR_K_OUTER + k];
  double v0 = st.v_nl[0], v1 = st.v_nl[1], ic[2], gm[2];
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < 6; ++it) {
    bjt_pair<8>(v0, v1, n, ic, gm);
    const double f0 = v0 - p0 - kc[0] * ic[0] - kc[1] * ic[1];
    const double f1 = v1 - p1 - kc[2] * ic[0] - kc[3] * ic[1];
    const bool conv = fabs(f0) < 1e-9 && fabs(f1) < 1e-9;
    if (warp_all(conv)) {
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
  if (!done) bjt_pair<8>(v0, v1, n, ic, gm);
  // the corrector, the input capacitor, the reset to the DC point on a
  // non-finite output
  const double dot = s[PR_SFB_NI] * ic[0] + s[PR_SFB_NI + 1] * ic[1];
  const double s_ni = ic[0] * s[PR_NI_COL0 + n] + ic[1] * s[PR_NI_COL1 + n];
  const double v_new = v_pred + s_ni - (sm_k * dot) * s[PR_S_FB_COL + n];
  const double jc = -s[PR_GC_1PC] * (u - __shfl_sync(FULL, v_new, B1, 8)) -
                    s[PR_C_CIN] * st.j_cin;
  const double out = __shfl_sync(FULL, v_new, OUTN, 16) -
                     __shfl_sync(FULL, v_new, 8 + OUTN, 16);
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
  return bad ? 0.0 : out;
}

// The melange rows on a segment, the twins side by side on its two 8-lane
// quarters: lane q serves twin r = q / 8, its node rows n = q % 8 (v[0])
// and, on n < 5, 8 + n (v[1]), and its Newton row min(n, 4) (i, v_nl);
// the draws on lanes q < 10. (The twins one after the other on the whole
// segment ran 12-26 % slower from 1 to 32768 engines: PERF.md §6.)
struct MelSeg {
  double v[2], i, v_nl, w_prev, g_prev, key[2];
};

// lane q's node rows (nv[0], nv[1]) as offsets into the melange rows; →
// its Newton row
__device__ __forceinline__ int mel_seg_rows(int q, int* nv) {
  const int r = q >> 3, n = q & 7;
  nv[0] = MS_V + 13 * r + n;
  nv[1] = MS_V + 13 * r + 8 + min(n, 4);
  return 5 * r + min(n, 4);
}

__device__ void load_mel_seg(MelSeg& st, const double* rows, int q) {
  int nv[2];
  const int nm = mel_seg_rows(q, nv);
  st.v[0] = rows[nv[0]];
  st.v[1] = rows[nv[1]];
  st.i = rows[MS_I + nm];
  st.v_nl = rows[MS_VNL + nm];
  st.w_prev = rows[MS_WPREV + min(q, 9)];
  st.g_prev = rows[MS_GPREV];
  st.key[0] = rows[MS_KEY];
  st.key[1] = rows[MS_KEY + 1];
}

__device__ void store_mel_seg(const MelSeg& st, double* rows, int q) {
  const int r = q >> 3, n = q & 7;
  rows[MS_V + 13 * r + n] = st.v[0];
  if (n < 5) {
    rows[MS_V + 13 * r + 8 + n] = st.v[1];
    rows[MS_I + 5 * r + n] = st.i;
    rows[MS_VNL + 5 * r + n] = st.v_nl;
  }
  if (q < 10) rows[MS_WPREV + q] = st.w_prev;
  if (q == 0) {
    rows[MS_GPREV] = st.g_prev;
    rows[MS_KEY] = st.key[0];
    rows[MS_KEY + 1] = st.key[1];
  }
}

// the twins' rows at the DC point
__device__ __forceinline__ void mel_rows_at_dc(const double* s, MelSeg& st,
                                               int q) {
  int nv[2];
  const int nm = mel_seg_rows(q, nv);
  for (int k = 0; k < 2; ++k)
    st.v[k] = s[ML_V_DC + nv[k] - MS_V - 13 * (nv[k] - MS_V >= 13)];
  st.i = s[ML_I_DC + nm % 5];
  st.v_nl = s[ML_V_NL_DC + nm % 5];
}

__device__ __forceinline__ void init_melange_seg(const double* s,
                                                 MelSeg& st, int q) {
  mel_rows_at_dc(s, st, q);
  st.w_prev = 0.0;
  st.g_prev = 1.0 / 1000000.0;
  st.key[0] = 0.0;
  st.key[1] = 24301.0;  // 0x5EED
}

// melange_step_warp on a segment, the twins side by side on its two
// 8-lane quarters (MelSeg's map): lane q serves twin r = q / 8, its node
// rows n = q % 8 (v[0]) and, on n < 5, a second row 8 + n (v[1]), its
// Newton row n < 5 (i, v_nl). Twin r's vectors are published at [16 r,
// 16 r + 13) of the segment's buffers. Newton runs until all four twins
// of the warp have converged, a converged twin's update masked as in the
// warp form.
__device__ __noinline__ double melange_step_seg(const double* s,
                                                MelSeg& st, double g,
                                                double x, double scale,
                                                WarpScratch* w) {
  constexpr int N = 13, M = 5, NR = 10;
  const int q = threadIdx.x & 15, r = q >> 3, n = q & 7;
  const int rn = n, rn2 = 8 + min(n, N - 9), rm = min(n, M - 1);
  const int fb = (int)s[ML_IDX], outn = (int)s[ML_IDX + 1];
  const int row_in = (int)s[ML_IDX + 2];
  const double* a = w->a + 16 * r;  // this twin's published vectors
  const double* b = w->b + 16 * r;
  // the key's two hashes: the next key on lane NR, the draws' key on every
  // other lane; one normal on each lane q < NR
  uint32_t h1, h2;
  threefry((uint32_t)st.key[0], (uint32_t)st.key[1], 0u,
           q == NR ? 0u : 1u, &h1, &h2);
  const uint32_t n1 = __shfl_sync(FULL, h1, NR, 16);
  const uint32_t n2 = __shfl_sync(FULL, h2, NR, 16);
  const int d = min(q, NR - 1);
  const double w_new =
      normal_draw(h1, h2, (uint32_t)d) * s[ML_SIGMA + d] * scale;
  publish_seg(w->b, w_new + st.w_prev, 0.0, q, NR);
  const double i_noise = row_dot<N, NR>(s + ML_INJECT, w->b, rn);
  const double i_noise2 = row_dot<N, NR>(s + ML_INJECT, w->b, rn2);
  // the history, fb's LDR term, the sources, the input, the device
  // currents, the noise (main twin only), rows rn and rn2
  const double v = st.v[0], v2 = st.v[1];
  __syncwarp();  // every lane has read b's draws
  w->a[16 * r + n] = v;
  if (n < N - 8) w->a[16 * r + 8 + n] = v2;
  if (n < M) w->b[16 * r + n] = st.i;
  __syncwarp();
  const double u = r == 0 ? x : 0.0;
  auto rhs_row = [&](int row, double vr, double noise) {
    double rhs = row_dot<N, N>(s + ML_A_HIST, a, row);
    rhs = row == fb ? rhs + (-st.g_prev) * vr : rhs;
    rhs = rhs + s[ML_WS_W + row];
    rhs = row == row_in ? rhs + u : rhs;
    rhs = rhs + row_dot<N, M>(s + ML_N_I, b, row);
    return rhs + (r == 0 ? noise : 0.0);
  };
  const double rhs = rhs_row(rn, v, i_noise);
  const double rhs2 = rhs_row(rn2, v2, i_noise2);
  // the predictor, its LDR correction, the ports' p, this row of K_corr
  __syncwarp();
  w->a[16 * r + n] = rhs;
  if (n < N - 8) w->a[16 * r + 8 + n] = rhs2;
  __syncwarp();
  const double vpb = row_dot<N, N>(s + ML_S, a, rn);
  const double vpb2 = row_dot<N, N>(s + ML_S, a, rn2);
  const double sm_k = g / (1.0 + s[ML_S_FB_FB] * g);
  const double vpb_fb = __shfl_sync(FULL, fb < 8 ? vpb : vpb2, fb & 7, 8);
  const double v_pred = vpb - (sm_k * vpb_fb) * s[ML_S_FB_COL + rn];
  const double v_pred2 = vpb2 - (sm_k * vpb_fb) * s[ML_S_FB_COL + rn2];
  __syncwarp();
  w->a[16 * r + n] = v_pred;
  if (n < N - 8) w->a[16 * r + 8 + n] = v_pred2;
  __syncwarp();
  const double p = row_dot<M, N>(s + ML_N_V, a, rm);
  double kc[M];
#pragma unroll
  for (int k = 0; k < M; ++k)
    kc[k] = s[ML_K + k * M + rm] - sm_k * s[ML_K_OUTER + k * M + rm];
  // Newton, the warp's four twins at once: at most 12 iterations
  double v_nl = st.v_nl, i_nl = 0.0;
  bool done = false;
#pragma unroll 1
  for (int it = 0; it < 12; ++it) {
    i_nl = mel_current_lane<8>(s, v_nl, n);
    __syncwarp();
    if (n < M) w->b[16 * r + n] = i_nl;
    __syncwarp();
    double ki = kc[0] * b[0];
#pragma unroll
    for (int k = 1; k < M; ++k) ki = ki + kc[k] * b[k];
    const double f = v_nl - p - ki;
    const int prev = half_switch(HP_VOTES);
    const unsigned ok = __ballot_sync(FULL, n >= M || fabs(f) < 1e-9);
    half_switch(prev);
    const bool conv = ((ok >> (threadIdx.x & 24)) & 0xffu) == 0xffu;
    if (warp_all(conv)) {
      done = true;
      break;
    }
    double top, bot;
    mel_derivs_lane<8>(s, v_nl, n, &top, &bot);
    __syncwarp();  // every lane has read b's currents
    if (n < M) {
      w->a[16 * r + n] = top;
      w->b[16 * r + n] = bot;
    }
    __syncwarp();
    float aug[M + 1];
#pragma unroll
    for (int k = 0; k < M - 1; ++k) {
      const int r0 = 2 * (k / 2);
      aug[k] = (float)((n == k ? 1.0 : 0.0) -
                       (kc[r0] * a[k] + kc[r0 + 1] * b[k]));
    }
    aug[M - 1] = (float)((n == M - 1 ? 1.0 : 0.0) - kc[M - 1] * a[M - 1]);
    aug[M] = (float)f;
    const double dv = (double)ge_solve_f32_warp<M, 8>(aug, n);
    v_nl = conv ? v_nl : v_nl - jclip(dv, -0.5, 0.5);
  }
  if (!done) i_nl = mel_current_lane<8>(s, v_nl, n);
  // the corrector, the reset to the DC point on a non-finite output
  __syncwarp();
  if (n < M) w->b[16 * r + n] = i_nl;
  __syncwarp();
  const double dot = row_dot<1, M>(s + ML_SFB_NI, b, 0);
  const double v_new = v_pred + row_dot<N, M>(s + ML_S_NI, b, rn) -
                       (sm_k * dot) * s[ML_S_FB_COL + rn];
  const double v_new2 = v_pred2 + row_dot<N, M>(s + ML_S_NI, b, rn2) -
                        (sm_k * dot) * s[ML_S_FB_COL + rn2];
  const double o = outn < 8 ? v_new : v_new2;
  const double out = __shfl_sync(FULL, o, outn & 7, 16) -
                     __shfl_sync(FULL, o, 8 + (outn & 7), 16);
  const bool bad = !finite(out);
  st.v[0] = bad ? s[ML_V_DC + rn] : v_new;
  st.v[1] = bad ? s[ML_V_DC + rn2] : v_new2;
  st.i = bad ? s[ML_I_DC + rm] : i_nl;
  st.v_nl = bad ? s[ML_V_NL_DC + rm] : v_nl;
  st.w_prev = w_new;
  st.g_prev = g;
  st.key[0] = (double)n1;
  st.key[1] = (double)n2;
  return bad ? 0.0 : out;
}

// a segment's preamp rows and power-amp rows
template <int PRE> struct PreSegOf { using T = DkWarp; };
template <> struct PreSegOf<PRE_MELANGE> { using T = MelSeg; };
template <int PRE> using PreSeg = typename PreSegOf<PRE>::T;
template <int PA> struct PaSegOf { using T = PaSeg; };
template <> struct PaSegOf<PA_BEHAVIORAL> { using T = NoPa; };
template <int PA> using PaSegT = typename PaSegOf<PA>::T;

// nonlinear_step_warp on a segment; → the power amp's output on every
// lane of the segment
template <int PRE, int PA>
__device__ __forceinline__ double nonlinear_step_seg(
    const double* misc, TremSeg& tr, PaSegT<PA>& pa, PreSeg<PRE>& pre,
    const double* s_trem, const double* s_pa, const double* s_pre,
    WarpScratch* w, double depth, double u, bool sag, double noise_scale) {
  const double shunt = tremolo_step_seg(s_trem, misc, tr, depth, w);
  const double g = 1.0 / jmax(shunt, 1000.0);
  const double x = __shfl_sync(FULL, u, 0, 16);
  double y;
  if constexpr (PRE == PRE_DK)
    y = dk_step_seg(s_pre, pre, g, x, w);
  else
    y = melange_step_seg(s_pre, pre, g, x, noise_scale, w);
  const double drive = 0.25;  // tables.FIXED_CIRCUIT_DRIVE
  if constexpr (PA == PA_CIRCUIT)
    return power_amp_step_seg(s_pa, misc, pa, y * drive, sag, w);
  else
    return behavioral(y * drive);
}

// chain_sample_warp on a segment; → the output on its lane 0
template <int PRE, int PA>
__device__ __noinline__ double chain_sample_seg(
    const double* c, double* ch, TremSeg& tr, PaSegT<PA>& pa,
    PreSeg<PRE>& pre, const double* s_trem, const double* s_pa,
    const double* s_pre, WarpScratch* w, double mono, bool sag,
    double noise_scale, double* last_char, Speaker* spk_k) {
  const int q = threadIdx.x & 15;
  const double* misc = c + C_MISC;
  double depth = 0.0, vol = 0.0, chr = 0.0;
  if (q == 0) {
    half_switch(HP_LANE0);
    depth = smoother_next(ch + CH_SM_DEPTH);
    vol = smoother_next(ch + CH_SM_VOLUME);
    chr = smoother_next(ch + CH_SM_CHAR);
    half_switch(HP_REST);
  }
  depth = __shfl_sync(FULL, depth, 0, 16);
  double amp_out = 0.0;
  if (misc[M_OVERSAMPLE] != 0.0) {
    double us[2] = {0.0, 0.0}, y[2];
    if (q == 0) {
      half_switch(HP_LANE0);
      us[0] = branch_step(kBranchA, ch + CH_OS_UP_A, mono);
      us[1] = branch_step(kBranchB, ch + CH_OS_UP_B, mono);
      half_switch(HP_REST);
    }
#pragma unroll 1
    for (int h = 0; h < 2; ++h)
      y[h] = nonlinear_step_seg<PRE, PA>(misc, tr, pa, pre, s_trem, s_pa,
                                         s_pre, w, depth, us[h], sag,
                                         noise_scale);
    if (q == 0) {
      half_switch(HP_LANE0);
      const double a = branch_step(kBranchA, ch + CH_OS_DOWN_A, y[0]);
      const double b = branch_step(kBranchB, ch + CH_OS_DOWN_B, y[1]);
      amp_out = (a + ch[CH_OS_DELAY]) * 0.5;
      ch[CH_OS_DELAY] = b;
      half_switch(HP_REST);
    }
  } else {
    amp_out = nonlinear_step_seg<PRE, PA>(misc, tr, pa, pre, s_trem, s_pa,
                                          s_pre, w, depth, mono, sag,
                                          noise_scale);
  }
  double out = 0.0;
  int bad = 0;
  if (q == 0) {
    half_switch(HP_LANE0);
    if (__double_as_longlong(chr) != __double_as_longlong(*last_char)) {
      *last_char = chr;
      speaker_design(chr, misc[M_SPK_SR], spk_k);
    }
    double* spk = ch + CH_SPK;
    const double y = speaker_step(*spk_k, spk, amp_out, misc[M_SPK_ALPHA]);
    out = y * misc[M_POST_GAIN] * vol;
    bad = !finite(out);
    if (bad) {
      // NaN guard #2, as in the warp form
      for (int k = 0; k < OS_ROWS; ++k) ch[CH_OS_UP_A + k] = 0.0;
      if constexpr (PA == PA_BEHAVIORAL) init_power_amp(c + C_PA, ch);
      for (int k = 0; k < 5; ++k) spk[k] = 0.0;
      out = 0.0;
    }
    half_switch(HP_REST);
  }
  if (__shfl_sync(FULL, bad, 0, 16)) {
    if constexpr (PRE == PRE_DK)
      init_dk_seg(s_pre, pre, q);
    else
      init_melange_seg(s_pre, pre, q);
    if constexpr (PA == PA_CIRCUIT) init_power_amp_seg(s_pa, pa, q);
  }
  return out;
}

constexpr int E2_HALF_WARPS = 4;  // warps per block: eight engines

template <int PRE, int PA>
__global__ void __launch_bounds__(E2_HALF_WARPS * 32)
engine_chain_half_kernel(const double* __restrict__ c,
                         const double* __restrict__ mono, double* chain,
                         float* out, int n, int b, const unsigned char* sag,
                         const double* noise_scale) {
  constexpr bool MEL = PRE == PRE_MELANGE;
  constexpr bool CIRCUIT = PA == PA_CIRCUIT;
  constexpr int PRE_ROW = MEL ? CH_MEL_V : CH_PRE_V;
  __shared__ double s_trem[TREM_BLOCK];
  __shared__ double s_pa[CIRCUIT ? PA_BLOCK : 1];
  __shared__ double s_pre[PreWarpOf<PRE>::BLOCK];
  __shared__ WarpScratch scratch[2 * E2_HALF_WARPS];
  if constexpr (CIRCUIT) stage_block<21, 16, 8>(c + C_PA, s_pa);
  stage_block<7, 4, 2>(c + C_TREM, s_trem);
  if constexpr (MEL)
    stage_melange(c + C_MEL, s_pre);
  else
    stage_dk(c + C_PRE, s_pre);
  __syncthreads();
  const int q = threadIdx.x & 15;
  const int e = blockIdx.x * (blockDim.x >> 4) + (threadIdx.x >> 4);
  if ((e & ~1) >= b) return;  // the whole warp: no block-wide sync follows
  // a segment past b runs its neighbour's engine and stores nothing
  const bool live = e < b;
  const int own = live ? e : b - 1;
  double* row = chain + (size_t)own * CHAIN_ROWS;
  double ch[CHAIN_ROWS];  // lane 0's rows
  if (q == 0)
    for (int k = 0; k < CHAIN_ROWS; ++k)
      ch[k] = warp_row<PRE, PA>(k) ? 0.0 : row[k];
  TremSeg tr;
  load_seg<7, 4>(tr.s, row + CH_TREM_V, q);
  tr.env = row[CH_TREM_ENV];
  tr.r_ldr = row[CH_TREM_RLDR];
  PaSegT<PA> pa;
  if constexpr (CIRCUIT) load_pa_seg(pa, row + CH_PA_V, q);
  PreSeg<PRE> pre;
  if constexpr (MEL)
    load_mel_seg(pre, row + PRE_ROW, q);
  else
    load_dk_seg(pre, row + PRE_ROW, q);
  double last_char = __longlong_as_double(0x7ff8dead0000beefLL);  // NaN
  Speaker spk_k;
  WarpScratch* w = &scratch[threadIdx.x >> 4];
#if OW_HALF_STAMPS
  long long* stamps = g_half_parts + (size_t)(blockIdx.x * blockDim.x +
                                              threadIdx.x) * (HALF_PARTS + 2);
  stamps[HALF_PARTS] = clock64();
  stamps[HALF_PARTS + 1] = HP_REST;
#endif
  for (int t = 0; t < n; ++t) {
    const size_t i = (size_t)own * n + t;
    const double y = chain_sample_seg<PRE, PA>(
        c, ch, tr, pa, pre, s_trem, s_pa, s_pre, w, mono[i], sag[own] != 0,
        noise_scale[own], &last_char, &spk_k);
    if (q == 0 && live) out[i] = (float)y;
  }
  if (!live) return;
  if (q == 0)
    for (int k = 0; k < CHAIN_ROWS; ++k)
      if (!warp_row<PRE, PA>(k)) row[k] = ch[k];
  if constexpr (MEL)
    store_mel_seg(pre, row + PRE_ROW, q);
  else
    store_dk_seg(pre, row + PRE_ROW, q);
  store_seg<7, 4>(tr.s, row + CH_TREM_V, q);
  if (q == 0) {
    row[CH_TREM_ENV] = tr.env;
    row[CH_TREM_RLDR] = tr.r_ldr;
  }
  if constexpr (CIRCUIT) store_pa_seg(pa, row + CH_PA_V, q);
}

// ═════════════════════════════ E3: settle ═════════════════════════════

// The oscillator's rows (v, i, v_nl, resid, diag: load_lane's layout)
// stepped n times by one warp: E2's tremolo step without the vactrol
// (mna_step_warp), its solver block staged in shared memory.
constexpr int OSC_ROWS = 7 + 2 * 4 + 1 + 5;

__global__ void __launch_bounds__(32)
tremolo_settle_kernel(const double* __restrict__ c, double* state,
                      int n_steps) {
  __shared__ double s_osc[TREM_BLOCK];
  __shared__ WarpScratch scratch;
  stage_block<7, 4, 2>(c, s_osc);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  LaneState st;
  load_lane<7, 4>(st, state, 1, lane);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t)
    mna_step_warp<7, 4, 2, 4>(s_osc, st, 0.0, &scratch);
  store_lane<7, 4>(st, state, 1, lane);
}

// ═══════════════════════════ E5: preamp scan ═══════════════════════════

// Columns of the (rows, G) state, one per stream; x and out (n, G) time
// major. Both forms run a warp per stream, E5_WARPS streams to a block
// sharing one staged copy of the preamp's constants; each of the stream's
// rows is loaded and stored by the lane that owns it. E5<dk>
// (di.preamp_di): lane 0 runs the oversampler (allpass up, then down) and
// the whole warp the twin DK step twice (dk_step_warp).
constexpr int E5_WARPS = 4;

template <int PRE>
__global__ void __launch_bounds__(E5_WARPS * 32)
preamp_scan_kernel(const double* __restrict__ c, const double* __restrict__ x,
                   double* state, const double* __restrict__ g_ldr,
                   double* out, int n, int g) {
  static_assert(PRE == PRE_DK, "E5<melange> is melange_scan_kernel");
  __shared__ double s_pre[PR_SIZE];
  __shared__ WarpScratch scratch[E5_WARPS];
  stage_dk(c, s_pre);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;  // the whole warp: no block-wide sync follows
  double os[OS_ROWS];  // lane 0's oversampler
  if (lane == 0)
    for (int k = 0; k < OS_ROWS; ++k) os[k] = state[(size_t)k * g + j];
  DkWarp st;
  load_dk(st, state + (size_t)OS_ROWS * g + j, g, lane);
  const double gl = g_ldr[j];
  WarpScratch* w = &scratch[warp];
  double x_next = n > 0 ? x[j] : 0.0;  // the next sample's, a step ahead
  for (int t = 0; t < n; ++t) {
    const double xt = x_next;
    if (t + 1 < n) x_next = x[(size_t)(t + 1) * g + j];
    double e = 0.0, o = 0.0;
    if (lane == 0) {
      e = branch_step(kBranchA, os + 0, xt);
      o = branch_step(kBranchB, os + 3, xt);
    }
    const double y0 = dk_step_warp(s_pre, st, gl, __shfl_sync(FULL, e, 0), w);
    const double y1 = dk_step_warp(s_pre, st, gl, __shfl_sync(FULL, o, 0), w);
    if (lane == 0) {
      const double a = branch_step(kBranchA, os + 6, y0);
      const double b = branch_step(kBranchB, os + 9, y1);
      out[(size_t)t * g + j] = (a + os[12]) * 0.5;
      os[12] = b;
    }
  }
  if (lane == 0)
    for (int k = 0; k < OS_ROWS; ++k) state[(size_t)k * g + j] = os[k];
  store_dk(st, state + (size_t)OS_ROWS * g + j, g, lane);
}

// E5<melange>: the melange step on the warp (melange_step_warp).
__global__ void __launch_bounds__(E5_WARPS * 32)
melange_scan_kernel(const double* __restrict__ c,
                    const double* __restrict__ x, double* state,
                    const double* __restrict__ g_ldr,
                    const double* __restrict__ noise_scale, double* out,
                    int n, int g) {
  __shared__ double s_mel[ML_SIZE];
  __shared__ WarpScratch scratch[E5_WARPS];
  stage_melange(c, s_mel);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;  // the whole warp: no block-wide sync follows
  MelWarp st;
  load_mel(st, state + j, g, lane);
  const double gl = g_ldr[j], scale = noise_scale[j];
  WarpScratch* w = &scratch[warp];
  for (int t = 0; t < n; ++t) {
    const double y = melange_step_warp(s_mel, st, gl, x[(size_t)t * g + j],
                                       scale, w);
    if (lane == 0) out[(size_t)t * g + j] = y;
  }
  store_mel(st, state + j, g, lane);
}

// ═══════════════════════ E7: the DK measurement scan ═══════════════════════

// The CLI's preamp and pump measurements: the twin DK preamp stepped once
// per sample at the input's own rate (no oversampler), a warp per stream
// (dk_step_warp), E7_WARPS streams to a block sharing one staged copy of
// the constants; x, r_ldr and out (n, G) time major, the state (PS_ROWS,
// G), each row loaded and stored by the lane that owns it. Each sample's
// LDR conductance is 1 / max(r, 1 kOhm) of that sample's resistance
// (dk_preamp.ldr_conductance), on every lane. TAP selects what each sample
// writes: DK_TAP_DIFF the step's main - shadow (lane 0), DK_TAP_SHADOW the
// shadow's OUT node after the step (after the step's reset to the DC
// point, when its output went non-finite; the lane that owns the row).
constexpr int E7_WARPS = 4;
enum DkTap { DK_TAP_DIFF = 0, DK_TAP_SHADOW = 1 };

template <int TAP>
__global__ void __launch_bounds__(E7_WARPS * 32)
dk_scan_kernel(const double* __restrict__ c, const double* __restrict__ x,
               const double* __restrict__ r_ldr, double* state, double* out,
               int n, int g) {
  __shared__ double s_pre[PR_SIZE];
  __shared__ WarpScratch scratch[E7_WARPS];
  stage_dk(c, s_pre);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;  // the whole warp: no block-wide sync follows
  DkWarp st;
  load_dk(st, state + j, g, lane);
  WarpScratch* w = &scratch[warp];
  // the next sample's input and resistance, loaded a step ahead
  double x_next = n > 0 ? x[j] : 0.0, r_next = n > 0 ? r_ldr[j] : 0.0;
  for (int t = 0; t < n; ++t) {
    const size_t at = (size_t)t * g + j;
    const double xt = x_next, rt = r_next;
    if (t + 1 < n) {
      x_next = x[at + g];
      r_next = r_ldr[at + g];
    }
    const double y = dk_step_warp(s_pre, st, 1.0 / jmax(rt, 1000.0), xt, w);
    if (TAP == DK_TAP_DIFF && lane == 0) out[at] = y;
    if (TAP == DK_TAP_SHADOW && lane == 16 + OUTN) out[at] = st.v;
  }
  store_dk(st, state + j, g, lane);
}

// ═══════════════════════ E6: power amp and speaker ═══════════════════════

// run_calibrate's T5, a warp per stream: x · volume · volume → the power
// amp (the chain's step, rail sag on, on the warp: power_amp_step_warp) →
// the speaker (its filters designed once, from `character`, on lane 0) →
// × POST_SPEAKER_GAIN. No smoothers, no NaN guard, no volume after the
// speaker. The constants have the chain's layout (C_PA, C_MISC; the
// tremolo and preamp blocks unused); the state (E6_ROWS, G) holds the
// chain's rows CH_PA_V .. CH_SPK + 4 of each stream, each row loaded and
// stored by the lane that owns it. E6_WARPS streams to a block share one
// staged copy of the power amp's solver block: run_calibrate's 512 streams
// are 128 blocks, so every SM but four holds one.
constexpr int E6_WARPS = 4;
constexpr int E6_ROWS = CH_SPK + 5 - CH_PA_V;
constexpr int E6_SPK = CH_SPK - CH_PA_V;

__global__ void __launch_bounds__(E6_WARPS * 32)
pa_speaker_scan_kernel(const double* __restrict__ c,
                       const double* __restrict__ x, double* state,
                       double* out, int n, int g, double volume,
                       double character) {
  __shared__ double s_pa[PA_BLOCK];
  __shared__ WarpScratch scratch[E6_WARPS];
  stage_block<21, 16, 8>(c + C_PA, s_pa);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;  // the whole warp: no block-wide sync follows
  PaWarp pa;
  load_pa(pa, state + j, g, lane);
  double spk[5];
  for (int k = 0; k < 5; ++k) spk[k] = state[(size_t)(E6_SPK + k) * g + j];
  const double* misc = c + C_MISC;
  Speaker spk_k;
  if (lane == 0) speaker_design(character, misc[M_SPK_SR], &spk_k);
  WarpScratch* w = &scratch[warp];
  for (int t = 0; t < n; ++t) {
    const double xt = x[(size_t)t * g + j] * volume * volume;
    const double y = power_amp_step_warp(s_pa, misc, pa, xt, true, w);
    if (lane == 0) {
      const double z = speaker_step(spk_k, spk, y, misc[M_SPK_ALPHA]);
      out[(size_t)t * g + j] = z * misc[M_POST_GAIN];
    }
  }
  store_pa(pa, state + j, g, lane);
  if (lane == 0)
    for (int k = 0; k < 5; ++k) state[(size_t)(E6_SPK + k) * g + j] = spk[k];
}

// ═══════════════════ E8, E9: the stage benchmark's scans ═══════════════════

// The tremolo and the power amp alone, at the stage's own rate, in the
// chain's constant layout (C_TREM, C_PA, C_MISC; the preamp block unused).
// E8 runs a warp per circuit, E8_WARPS to a block sharing one staged copy
// of the oscillator's solver block: E2's `tremolo_step_warp` (the
// oscillator's mna step on the warp, then the vactrol and the divider on
// every lane) at the circuit's depth, lane 0 writing the shunt; its state
// (E8_ROWS, G) holds the chain's rows CH_TREM_V .. CH_TREM_RLDR of each
// circuit, each row loaded and stored by the lane that owns it. E9 is E6
// without volume² and without the speaker: a warp per stream, four per
// block sharing one staged copy of the power amp's solver block,
// `power_amp_step_warp` with rail sag on, lane 0 writing the output; its
// state (E9_ROWS, G) holds the rows CH_PA_V .. CH_PA_LAST, E6's first
// rows. x and out are time major.
constexpr int E8_WARPS = 4;
constexpr int E8_ROWS = CH_TREM_RLDR + 1 - CH_TREM_V;
constexpr int E8_ENV = CH_TREM_ENV - CH_TREM_V;  // after load_lane's rows
static_assert(E8_ENV + 2 == E8_ROWS, "E8's rows: the oscillator's, env, r");
constexpr int E9_WARPS = 4;
constexpr int E9_ROWS = CH_PA_LAST + 1 - CH_PA_V;

__global__ void __launch_bounds__(E8_WARPS * 32)
tremolo_scan_kernel(const double* __restrict__ c, double* state,
                    const double* __restrict__ depth, double* out, int n,
                    int g) {
  __shared__ double s_trem[TREM_BLOCK];
  __shared__ WarpScratch scratch[E8_WARPS];
  stage_block<7, 4, 2>(c + C_TREM, s_trem);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;  // the whole warp: no block-wide sync follows
  TremWarp tr;
  load_lane<7, 4>(tr.s, state + j, g, lane);
  tr.env = state[(size_t)E8_ENV * g + j];
  tr.r_ldr = state[(size_t)(E8_ENV + 1) * g + j];
  const double* misc = c + C_MISC;
  const double d = depth[j];
  WarpScratch* w = &scratch[warp];
  for (int t = 0; t < n; ++t) {
    const double y = tremolo_step_warp(s_trem, misc, tr, d, w);
    if (lane == 0) out[(size_t)t * g + j] = y;
  }
  store_lane<7, 4>(tr.s, state + j, g, lane);
  if (lane == 0) {
    state[(size_t)E8_ENV * g + j] = tr.env;
    state[(size_t)(E8_ENV + 1) * g + j] = tr.r_ldr;
  }
}

// One block per SM is enough: without that bound ptxas caps E9 at 128
// registers, and power_amp_step_warp spills inside it.
__global__ void __launch_bounds__(E9_WARPS * 32, 1)
power_amp_scan_kernel(const double* __restrict__ c,
                      const double* __restrict__ x, double* state,
                      double* out, int n, int g) {
  __shared__ double s_pa[PA_BLOCK];
  __shared__ WarpScratch scratch[E9_WARPS];
  stage_block<21, 16, 8>(c + C_PA, s_pa);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * (blockDim.x >> 5) + warp;
  if (j >= g) return;  // the whole warp: no block-wide sync follows
  PaWarp pa;
  load_pa(pa, state + j, g, lane);
  const double* misc = c + C_MISC;
  WarpScratch* w = &scratch[warp];
  for (int t = 0; t < n; ++t) {
    const double y =
        power_amp_step_warp(s_pa, misc, pa, x[(size_t)t * g + j], true, w);
    if (lane == 0) out[(size_t)t * g + j] = y;
  }
  store_pa(pa, state + j, g, lane);
}

}  // namespace

extern "C" int ow_engine_voices(const double* vpar, double* vst,
                                long long* vsti, long long* eng_i,
                                double* mono, int n, int b, double fade_len,
                                double sample_rate, cudaStream_t stream) {
  return launch_engine_voices(vpar, vst, vsti, eng_i, mono, n, b, fade_len,
                              sample_rate, stream);
}

extern "C" int ow_engine_voices_thread(const double* vpar, double* vst,
                                       long long* vsti, long long* eng_i,
                                       double* mono, int n, int b,
                                       double fade_len, double sample_rate,
                                       cudaStream_t stream) {
  if (n < 0 || b < 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  engine_voices_thread_kernel<<<b, SLOTS, 0, stream>>>(
      vpar, vst, vsti, eng_i, mono, n, fade_len, sample_rate);
  return (int)cudaGetLastError();
}

extern "C" int ow_voice_render(const double* vpar, double* vst,
                               long long* vsti, double* out, int g, int n,
                               cudaStream_t stream) {
  return launch_voice_lanes<false>(vpar, vst, vsti, out, nullptr, g, n,
                                   nullptr, E4_BLOCK, stream);
}

extern "C" int ow_voice_render_tap(const double* vpar, double* vst,
                                   long long* vsti, double* out,
                                   double* reed, int g, int n,
                                   cudaStream_t stream) {
  return launch_voice_lanes<true>(vpar, vst, vsti, out, reed, g, n,
                                  nullptr, E4_BLOCK, stream);
}

extern "C" int ow_pa_speaker_scan(const double* consts, int n_consts,
                                  const double* x, double* state,
                                  double* out, int n, int g, double volume,
                                  double character, cudaStream_t stream) {
  if (n_consts != C_TOTAL || n < 0 || g < 0)
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const int blocks = (g + E6_WARPS - 1) / E6_WARPS;
  const int warps = g < E6_WARPS ? g : E6_WARPS;
  pa_speaker_scan_kernel<<<blocks, warps * 32, 0, stream>>>(
      consts, x, state, out, n, g, volume, character);
  return (int)cudaGetLastError();
}

// E2's forms: 0 a thread per engine, 1 a warp per engine, 2 a half-warp
// per engine
enum { E2_THREAD = 0, E2_WARP = 1, E2_HALF = 2 };

extern "C" int ow_engine_chain(const double* consts, int n_consts,
                               const double* mono, double* chain, float* out,
                               int n, int b, const unsigned char* rail_sag,
                               int pre_model, int pa_model,
                               const double* noise_scale, int form,
                               cudaStream_t stream) {
  const int want = C_TOTAL + (pre_model == PRE_MELANGE ? ML_SIZE : 0);
  if (n_consts != want || n < 0 || b < 0 || pre_model < 0 ||
      pre_model > 1 || pa_model < 0 || pa_model > 1 || form < E2_THREAD ||
      form > E2_HALF)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const bool dk = pre_model == PRE_DK, circuit = pa_model == PA_CIRCUIT;
  if (form == E2_HALF) {
    const int warps = (b + 1) / 2;
    const int blocks = (warps + E2_HALF_WARPS - 1) / E2_HALF_WARPS;
    const int threads = 32 * (warps < E2_HALF_WARPS ? warps : E2_HALF_WARPS);
    if (dk && circuit)
      engine_chain_half_kernel<PRE_DK, PA_CIRCUIT>
          <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                           rail_sag, noise_scale);
    else if (dk)
      engine_chain_half_kernel<PRE_DK, PA_BEHAVIORAL>
          <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                           rail_sag, noise_scale);
    else if (circuit)
      engine_chain_half_kernel<PRE_MELANGE, PA_CIRCUIT>
          <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                           rail_sag, noise_scale);
    else
      engine_chain_half_kernel<PRE_MELANGE, PA_BEHAVIORAL>
          <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                           rail_sag, noise_scale);
    return (int)cudaGetLastError();
  }
  if (form == E2_WARP) {
    const int blocks = (b + E2_WARPS - 1) / E2_WARPS;
    const int threads = 32 * (b < E2_WARPS ? b : E2_WARPS);
    if (dk && circuit)
      engine_chain_warp_kernel<PRE_DK, PA_CIRCUIT>
          <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                           rail_sag, noise_scale);
    else if (dk)
      engine_chain_warp_kernel<PRE_DK, PA_BEHAVIORAL>
          <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                           rail_sag, noise_scale);
    else if (circuit)
      engine_chain_warp_kernel<PRE_MELANGE, PA_CIRCUIT>
          <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                           rail_sag, noise_scale);
    else
      engine_chain_warp_kernel<PRE_MELANGE, PA_BEHAVIORAL>
          <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                           rail_sag, noise_scale);
    return (int)cudaGetLastError();
  }
  const int blocks = (b + E2_BLOCK - 1) / E2_BLOCK;
  const int threads = b < E2_BLOCK ? b : E2_BLOCK;
  if (dk && circuit)
    engine_chain_kernel<PRE_DK, PA_CIRCUIT><<<blocks, threads, 0, stream>>>(
        consts, mono, chain, out, n, b, rail_sag, noise_scale);
  else if (dk)
    engine_chain_kernel<PRE_DK, PA_BEHAVIORAL>
        <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                         rail_sag, noise_scale);
  else if (circuit)
    engine_chain_kernel<PRE_MELANGE, PA_CIRCUIT>
        <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                         rail_sag, noise_scale);
  else
    engine_chain_kernel<PRE_MELANGE, PA_BEHAVIORAL>
        <<<blocks, threads, 0, stream>>>(consts, mono, chain, out, n, b,
                                         rail_sag, noise_scale);
  return (int)cudaGetLastError();
}

extern "C" int ow_preamp_scan(int kind, const double* consts, int n_consts,
                              const double* x, double* state,
                              const double* g_ldr, const double* noise_scale,
                              double* out, int n, int g,
                              cudaStream_t stream) {
  if (n < 0 || g < 0 || kind < 0 || kind > 1 ||
      n_consts != (kind == PRE_DK ? PR_SIZE : ML_SIZE))
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const int blocks = (g + E5_WARPS - 1) / E5_WARPS;
  const int warps = g < E5_WARPS ? g : E5_WARPS;
  if (kind == PRE_DK)
    preamp_scan_kernel<PRE_DK><<<blocks, warps * 32, 0, stream>>>(
        consts, x, state, g_ldr, out, n, g);
  else
    melange_scan_kernel<<<blocks, warps * 32, 0, stream>>>(
        consts, x, state, g_ldr, noise_scale, out, n, g);
  return (int)cudaGetLastError();
}

extern "C" int ow_dk_scan(int tap, const double* consts, int n_consts,
                          const double* x, const double* r_ldr,
                          double* state, double* out, int n, int g,
                          cudaStream_t stream) {
  if (n < 0 || g < 0 || tap < 0 || tap > 1 || n_consts != PR_SIZE)
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const int blocks = (g + E7_WARPS - 1) / E7_WARPS;
  const int warps = g < E7_WARPS ? g : E7_WARPS;
  if (tap == DK_TAP_DIFF)
    dk_scan_kernel<DK_TAP_DIFF><<<blocks, warps * 32, 0, stream>>>(
        consts, x, r_ldr, state, out, n, g);
  else
    dk_scan_kernel<DK_TAP_SHADOW><<<blocks, warps * 32, 0, stream>>>(
        consts, x, r_ldr, state, out, n, g);
  return (int)cudaGetLastError();
}

extern "C" int ow_tremolo_settle(const double* consts, int n_consts,
                                 double* state, int n_steps,
                                 cudaStream_t stream) {
  if (n_consts != SL<7, 4, 2>::SIZE || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  tremolo_settle_kernel<<<1, 32, 0, stream>>>(consts, state, n_steps);
  return (int)cudaGetLastError();
}

extern "C" int ow_tremolo_scan(const double* consts, int n_consts,
                               double* state, const double* depth,
                               double* out, int n, int g,
                               cudaStream_t stream) {
  if (n_consts != C_TOTAL || n < 0 || g < 0)
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const int blocks = (g + E8_WARPS - 1) / E8_WARPS;
  const int warps = g < E8_WARPS ? g : E8_WARPS;
  tremolo_scan_kernel<<<blocks, warps * 32, 0, stream>>>(consts, state,
                                                         depth, out, n, g);
  return (int)cudaGetLastError();
}

extern "C" int ow_power_amp_scan(const double* consts, int n_consts,
                                 const double* x, double* state, double* out,
                                 int n, int g, cudaStream_t stream) {
  if (n_consts != C_TOTAL || n < 0 || g < 0)
    return (int)cudaErrorInvalidValue;
  if (g == 0) return 0;
  const int blocks = (g + E9_WARPS - 1) / E9_WARPS;
  const int warps = g < E9_WARPS ? g : E9_WARPS;
  power_amp_scan_kernel<<<blocks, warps * 32, 0, stream>>>(consts, x, state,
                                                            out, n, g);
  return (int)cudaGetLastError();
}
