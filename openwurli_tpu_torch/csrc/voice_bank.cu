// Voice bank (kernels K1 and K3) for Hopper: 7 modal reed modes + attack
// noise + electrostatic pickup, eight threads per voice lane.
//
// Replaces: openwurli_tpu/kernels/voice_bank.py, `_kernel_body` as built by
// `_make_kernel` and launched by `_render_voice_bank_jit`: the plain variant
// (K1, events=False) and the events variant (K3, events=True), both with
// steady gating. One template, `voice_bank_kernel<EVENTS>`: every events
// addition sits under `if constexpr (EVENTS)`, so K1's instantiation holds
// none of it.
//
// What bounds it on this card: each lane's recurrence is serial in time.
// At a few hundred lanes (K3's 128) the dependent latency of one 8-sample
// group sets the time: the legacy stage's envelope chain, the pickup's
// division and 8-deep charge recurrence, the composed-power refresh every
// 16 samples. At thousands of lanes (K1's 8192) a group's issue and its
// stores do: a warp stores 16-byte pieces of each output row, which costs
// about as much as the rest of the group (tools/torch_vb_breakdown.py).
// The bytes alone (one f32 per lane and sample) are 0.43 ms at K1's shape.
//
// What the design does about it: eight threads per lane, four lanes per
// warp, in two roles per group.
//  * Modes on threads (the group's state): thread m < 7 owns mode m — its
//    s, c, env, drift, its parameters and only its own rotation powers —
//    and writes its 8 stage terms into a per-warp shared scratch. Thread 7
//    carries padding row 7 (renormed at tile ends, never advanced or
//    drifted, as the reference's arithmetic leaves it). The jitter LCG is
//    one word per lane, held by every thread: thread m draws its mode's
//    composed step from it, and thread 6's draw, the next word, reaches
//    the others by a shuffle.
//  * Samples on threads (the output): thread j sums sample j's terms over
//    modes 0..6 in index order, computes its onset ramp row, saturation
//    and charge factors (pn, r); every thread of the lane then runs the
//    8-step charge recurrence on the group's 8 pairs, read back from
//    scratch, so each holds the same charge; thread j stores sample j.
//  * The attack noise (serial over the group's samples) runs on every
//    thread of the lane, with sample j's fade-in from thread j.
// Each value is computed by one thread in the reference's order, nothing
// is summed across threads in any other order, and per-lane conditions
// are selects or give the same value on either side: the kernel equals its
// plain torch version bit for bit. cosf, powf, tanhf and the damper's
// expf run only where their value is selected, and a warp takes such a
// path for all its lanes when one lane needs it (a vote), rather than both
// paths. Branches on the sample counter (`steady`, `min_release`, the
// jitter tick, the renorm tile) are uniform. A warp whose lanes all lie
// past `lanes` returns; in any other warp every thread takes part in every
// sync and shuffle, and threads of lanes past `lanes` load and store
// nothing.
//
// Like the reference, 8-sample groups advance the envelope once, the OU
// jitter refreshes the powers only when drift changes, and the onset/noise
// branches are skipped past the `steady` horizon. The quadrature renorm
// fires at the end of each t_tile-sample tile whose span holds a multiple
// of 1024 — the reference's rule, with t_tile computed from the lane count
// by the wrapper.
//
// K3 adds per-lane onset and release samples. A lane is active from its
// onset (a multiple of 16, so constant over a group); before it every
// update is a select that keeps the old value, so the lane stays at its
// note-on state bit for bit and its LCG streams do not advance. Groups that
// end at or before `min_release` (the earliest release of the whole call, a
// uniform branch like `steady`) take K1's fast stage with P/Q masked;
// later groups take the legacy stage: the 3-phase damper and the natural
// decay per sub-step, the quadrature state of sub-step j straight from the
// group's start through raw R^j (kept beside the folded coefficients).
// Never-released lanes overflow the damper's expf to inf; the selects
// discard it, as the reference's do.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NM = 7;        // modes
constexpr int SUB = 8;       // rows per packed block
constexpr int UNROLL = 8;    // samples per group
constexpr int TPL = 8;       // threads per voice lane
constexpr int BLOCK = 128;   // threads per block: 16 lanes
constexpr int MAX_BLOCK = 128;
constexpr int JITTER_SUBSAMPLE = 16;
static_assert(JITTER_SUBSAMPLE == 2 * UNROLL,
              "groups run in pairs, a jitter tick opening each");
constexpr int RENORM_INTERVAL = 1024;
constexpr int ROW_COSM1 = 0, ROW_SIN = 1, ROW_PHASE = 2, ROW_AMP = 3,
              ROW_DECAYM1 = 4, ROW_SCAL = 5, ROW_NOISE = 8, ROW_EVT = 9,
              ROW_DRATE = 10, ROW_DM1 = 11, ROW_DM8M1 = 12;
constexpr int EVT_ONSET_F = 0, EVT_RELEASE_F = 1, EVT_RAMP = 2;
constexpr float NEVER = 1.0e12f;  // release sentinel
constexpr int S0 = 0, C0 = 8, E0 = 16, D0 = 24, N0 = 32, I0 = 40;
constexpr unsigned FULL = 0xffffffffu;
// Per-warp exchange scratch. Stage terms: 4 lanes x 8 rows x 8 samples,
// rows padded to 9 floats and lanes to 72 so that a warp's 32 writes of
// one sample, and its 32 reads of one mode, fall in 32 distinct banks.
// Pickup: 4 lanes x (pn[8], r[8]) at a lane stride of 24 floats, read back
// as 16-byte vectors without bank conflicts.
constexpr int ROW_PAD = 9, LANE_PAD = 72, TERMS = 4 * LANE_PAD;
constexpr int PR_PAD = 24, WARP_SCRATCH = TERMS + 4 * PR_PAD;
// Eight sequential steps of the attack-noise LCG as one.
constexpr uint32_t LCG_A8 = 3934847009u, LCG_C8 = 2748932008u;

__constant__ uint32_t kLcgAPow[NM] = {
    1664525u, 389569705u, 2940799637u, 158984081u, 2862450781u,
    3211393721u, 1851289957u};
__constant__ uint32_t kLcgCAcc[NM] = {
    1013904223u, 1196435762u, 3519870697u, 2868466484u, 1649599747u,
    2670642822u, 1476291629u};

// Variants for tools/vb_breakdown.cu, which times the kernel with pieces
// done another way (exact) or switched off; the library builds VARIANT = 0.
enum : int {
  V_Q_SHUFFLE = 1,   // exact: the charge handed thread to thread
  V_STAGED = 2,      // exact: whole-row stores through a block barrier
  V_NO_PICKUP = 4,   // the stage sum is stored; no saturation, no charge
  V_NO_REFRESH = 8,  // the rotation powers of the note-on drift are kept
  V_NO_LEGACY = 16,  // the fast stage in every group
  V_NO_WARM = 32,    // no onset ramp, no attack noise
  V_FEW_STORES = 64  // one output sample in eight is stored
};

// One block per SM is enough (the grid is the lanes): without that bound
// ptxas caps K1 near 96 registers and spills.
template <bool EVENTS, int VARIANT = 0>
__global__ void __launch_bounds__(MAX_BLOCK, 1)
voice_bank_kernel(const float* __restrict__ params,
                  const float* __restrict__ state_in,
                  float* __restrict__ out, float* __restrict__ state_out,
                  int lanes, int total, int t_tile, int n0, float steady0,
                  float steady1, float min_release) {
  constexpr bool STAGED = VARIANT & V_STAGED;
  __shared__ __align__(16) float scratch[MAX_BLOCK / 32][WARP_SCRATCH];
  __shared__ float staged[STAGED ? 2 : 1][STAGED ? UNROLL * MAX_BLOCK / TPL
                                                 : 1];
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  // A warp whose lanes all lie past `lanes` has nothing to do.
  if (!STAGED && (gt & ~31) / TPL >= lanes) return;
  const int v = gt / TPL;  // voice lane
  const int k = gt % TPL;  // mode k (row 7: padding); output sample k
  const bool valid = v < lanes;
  const bool is_mode = k < NM;
  const int wl = threadIdx.x / TPL % 4;  // lane within the warp
  float* const ws = scratch[threadIdx.x / 32];
  auto P = [&](int row, int m) {
    return valid ? params[(row * SUB + m) * lanes + v] : 0.0f;
  };
  auto ST = [&](int r) { return valid ? state_in[r * lanes + v] : 0.0f; };

  // Mode k's parameters (zeros on row 7).
  const float cosm1 = P(ROW_COSM1, k), sin_inc = P(ROW_SIN, k),
              phase_inc = P(ROW_PHASE, k), amp = P(ROW_AMP, k),
              decaym1 = P(ROW_DECAYM1, k), dm8m1 = P(ROW_DM8M1, k);
  const float onset_samps = P(ROW_SCAL, 0), onset_inc = P(ROW_SCAL, 1),
              onset_exp = P(ROW_SCAL, 2), revert = P(ROW_SCAL, 3),
              diffusion = P(ROW_SCAL, 4), beta = P(ROW_SCAL, 5),
              ds = P(ROW_SCAL, 6), post_gain = P(ROW_SCAL, 7);
  const float noise_decay = P(ROW_NOISE, 1), noise_dur = P(ROW_NOISE, 2),
              nb0 = P(ROW_NOISE, 3), nb2 = P(ROW_NOISE, 4),
              na1 = P(ROW_NOISE, 5), na2 = P(ROW_NOISE, 6);
  // Events schedule and mode k's damper constants (K3 only).
  float onset_f = 0.0f, release_f = NEVER, ramp_f = 1.0f, drate = 0.0f,
        dm1 = 0.0f;
  if constexpr (EVENTS) {
    onset_f = P(ROW_EVT, EVT_ONSET_F);
    release_f = P(ROW_EVT, EVT_RELEASE_F);
    ramp_f = P(ROW_EVT, EVT_RAMP);
    drate = P(ROW_DRATE, k);
    dm1 = P(ROW_DM1, k);
  }
  // A schedule that never releases never takes the legacy stage.
  const bool legacy_possible =
      EVENTS && !(VARIANT & V_NO_LEGACY) && min_release < 0.5f * NEVER;
  // Mode k's draw is k+1 composed LCG steps (thread 7's goes unused); read
  // once here, since indexing constant memory by thread serialises it.
  const uint32_t lcg_a = kLcgAPow[is_mode ? k : 0];
  const uint32_t lcg_c = kLcgCAcc[is_mode ? k : 0];

  // Row k of each state block; the lane's jitter LCG word, attack-noise
  // rows and pickup charge on every thread of the lane.
  float s = ST(S0 + k), c = ST(C0 + k), env = ST(E0 + k), drift = ST(D0 + k);
  const float nst_k = ST(N0 + k);
  const uint32_t irng_k = __float_as_uint(ST(I0 + k));
  float q = ST(N0 + 5);
  uint32_t jit = __float_as_uint(ST(I0 + 0));
  float namp = ST(N0 + 0), z1 = ST(N0 + 1), z2 = ST(N0 + 2);
  uint32_t nrng = __float_as_uint(ST(I0 + 1));

  // Mode k's composed rotation powers: slots 0..6 hold the folded output
  // coefficients for sub-steps 1..7, slot 7 the raw R^8 (state advance).
  // K3 also keeps raw R^1..R^7 (wa/wb) for the legacy stage.
  float ra[UNROLL], rb[UNROLL];
  float wa[EVENTS ? UNROLL - 1 : 1], wb[EVENTS ? UNROLL - 1 : 1];
  auto refresh = [&]() {
    const float delta = drift * phase_inc;
    const float a1 = cosm1 - delta * sin_inc;
    const float b1 = delta * (1.0f + cosm1) + sin_inc;
    const float dm = 1.0f - decaym1;
    float dj = amp * dm;
    ra[0] = dj + dj * a1;
    rb[0] = dj * b1;
    if constexpr (EVENTS) {
      wa[0] = a1;
      wb[0] = b1;
    }
    float aj = a1, bj = b1;
#pragma unroll
    for (int j = 2; j <= UNROLL; ++j) {
      const float a_new = aj + a1 + aj * a1 - bj * b1;
      const float b_new = bj + b1 + bj * a1 + aj * b1;
      aj = a_new;
      bj = b_new;
      if (j < UNROLL) {
        dj = dj * dm;
        ra[j - 1] = dj + dj * aj;
        rb[j - 1] = dj * bj;
        if constexpr (EVENTS) {
          wa[j - 1] = aj;
          wb[j - 1] = bj;
        }
      } else {
        ra[UNROLL - 1] = aj;
        rb[UNROLL - 1] = bj;
      }
    }
  };
  refresh();

  const float knee = 0.94f;
  const float rng_sat = (float)(0.98 - 0.94);
  const float sens = 1.8375f;
  const float twob = 2.0f * beta;
  const float u_scale = (float)(2.0 / 4294967295.0);
  const float w_scale = (float)(1.0 / 2147483647.0);
  const float sqrt3 = 1.7320508080f;
  const float pi_f = (float)3.141592653589793;
  float n_f0 = (float)n0;  // f32 sample counter (exact to 2^24 samples)

  // The jitter tick: mode k's draw from one composed-LCG step; the next
  // word is mode 6's draw. A pre-onset lane's stream has not started: it
  // keeps drift and LCG state.
  auto tick = [&](bool active0) {
    const uint32_t st = jit;
    const uint32_t sk = lcg_a * st + lcg_c;
    const float u = (float)(int32_t)(sk >> 1) * u_scale;
    const float noise = (u * 2.0f - 1.0f) * sqrt3;
    const float nd = revert * drift + diffusion * noise;
    drift = (is_mode && active0) ? nd : drift;
    const uint32_t sk_last = __shfl_sync(FULL, sk, NM - 1, TPL);
    jit = active0 ? sk_last : st;
    if constexpr (!(VARIANT & V_NO_REFRESH)) refresh();
  };

  // The warm-phase rows of sample k: onset ramp and attack noise. The
  // transcendentals run only where their value is selected.
  float onset_k = 1.0f, noise_k = 0.0f;
  auto warm = [&]() {
    const bool w_onset = n_f0 < steady0, w_noise = n_f0 < steady1;
    if ((VARIANT & V_NO_WARM) || !(w_onset || w_noise)) return;
    // onset-local time (onset_f is 0 without events: n − 0 = n)
    const float n_loc_k = EVENTS ? (n_f0 + (float)k) - onset_f
                                 : n_f0 + (float)k;
    // Sample k's onset-ramp and noise fade-in cosines share one cosf call
    // site: with two, ptxas puts the argument reduction's table on the
    // stack.
    bool need = w_onset && n_loc_k < onset_samps;
    float x = n_loc_k * onset_inc, cos_onset = 0.0f, cos_fade = 0.0f;
#pragma unroll 1
    for (int i = 0; i < 2; ++i) {
      float cv = 0.0f;
      if (need) cv = cosf(x);
      if (i == 0) {
        cos_onset = cv;
        need = w_noise && n_loc_k >= 0.0f && n_loc_k < 16.0f;
        x = pi_f * fminf(n_loc_k / 16.0f, 1.0f);
      } else {
        cos_fade = cv;
      }
    }
    if (w_onset) {
      onset_k = 1.0f;
      if (n_loc_k < onset_samps) {
        const float cosine = 0.5f * (1.0f - cos_onset);
        if (onset_exp <= 1.001f) onset_k = cosine;
        else if (onset_exp >= 1.999f) onset_k = cosine * cosine;
        else onset_k = powf(fmaxf(cosine, 1e-30f), onset_exp);
      }
    }
    if (w_noise) {
      // LCG → bandpass → envelope over the group's 8 samples, on every
      // thread of the lane, with sample j's fade-in from thread j (only
      // read while sample j is in the burst). A group wholly before the
      // onset moves nothing; one wholly past noise_dur only advances the
      // LCG. The recurrence gives the same for those, so a warp runs it
      // for all its lanes if one needs it.
      noise_k = 0.0f;
      const float n_loc0 = EVENTS ? n_f0 - onset_f : n_f0;
      const float n_loc7 = EVENTS ? (n_f0 + 7.0f) - onset_f : n_f0 + 7.0f;
      const bool before = EVENTS && n_loc7 < 0.0f;
      const bool past = n_loc0 >= 0.0f && n_loc0 >= noise_dur;
      if (!__any_sync(FULL, !before && !past)) {
        if (past) nrng = LCG_A8 * nrng + LCG_C8;
        return;
      }
      const float fade_k = n_loc_k < 16.0f ? 0.5f * (1.0f - cos_fade) : 1.0f;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const float n_loc = EVENTS ? (n_f0 + (float)j) - onset_f
                                   : n_f0 + (float)j;
        const bool active = !EVENTS || n_loc >= 0.0f;
        const uint32_t nrng_new = nrng * 1664525u + 1013904223u;
        nrng = active ? nrng_new : nrng;
        const float white = (float)(int32_t)nrng_new * w_scale;
        const bool nact = n_loc < noise_dur && active;
        const float filtered = nb0 * white + z1;
        const float z1_new = -na1 * filtered + z2;
        const float z2_new = nb2 * white - na2 * filtered;
        const float fade = __shfl_sync(FULL, fade_k, j, TPL);
        const float nz = nact ? namp * fade * filtered : 0.0f;
        noise_k = k == j ? nz : noise_k;
        namp = nact ? namp * noise_decay : namp;
        z1 = nact ? z1_new : z1;
        z2 = nact ? z2_new : z2;
      }
    }
  };

  // One group (a jitter tick opens every other one: tiles and n0 are
  // multiples of 16). Modes on threads: mode k's 8 stage terms into row k
  // of the warp's terms scratch (thread 7's row is never read), then the
  // group-end state advance by raw R^8. Samples on threads, after a
  // __syncwarp: sample k's stage (modes summed in index order), soft
  // saturation and charge factors (pn, r) into the pairs scratch; after a
  // second __syncwarp, which also keeps the next group's terms from
  // overwriting ones still being read, every thread of the lane runs the
  // charge recurrence, serial over the group's samples, on the 8 pairs,
  // and thread k stores sample k.
  float* const terms_k = ws + wl * LANE_PAD + k * ROW_PAD;
  const float* const stage_k = ws + wl * LANE_PAD + k;
  float* const pairs = ws + TERMS + wl * PR_PAD;
  auto group = [&](int parity, int n_out) {
    // Onsets are multiples of 16: constant over the 8-sample group.
    const bool active0 = !EVENTS || (n_f0 - onset_f) >= 0.0f;
    if (parity == 0) tick(active0);
    warm();
    auto legacy_terms = [&](auto in_ramp_c) {
      // Legacy stage (K3 past min_release): damper and natural decay per
      // sub-step; s_j from the group's start through raw R^j. In the ramp,
      // thread j divides sample j's t_rel by the ramp length for every
      // mode thread of the lane.
      float ratio_k = 0.0f;
      if constexpr (decltype(in_ramp_c)::value)
        ratio_k = (((n_f0 + (float)k) - release_f) + 1.0f)
                  / fmaxf(ramp_f, 1.0f);
      float e = env;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const float t_rel = ((n_f0 + (float)j) - release_f) + 1.0f;
        if constexpr (decltype(in_ramp_c)::value) {
          const bool in_ramp = t_rel >= 1.0f && t_rel <= ramp_f;
          const float inst = drate * __shfl_sync(FULL, ratio_k, j, TPL);
          e = in_ramp ? e * expf(-inst) : e;
        }
        const bool post = t_rel > ramp_f;
        e = post ? e - e * dm1 : e;
        float sj = s;
        if (j > 0) {
          const float rot = s * wa[j - 1] + c * wb[j - 1];
          sj = s + (active0 ? rot : 0.0f);
        }
        terms_k[j] = (amp * sj) * e;
        e = active0 ? e - e * decaym1 : e;
      }
      env = is_mode ? e : env;
    };
    const bool legacy = legacy_possible && n_f0 + (float)UNROLL > min_release;
    // The damper's expf runs only where a sample lies in its ramp, which a
    // group can touch only if its first t_rel <= ramp_f and its last >= 1;
    // the expf path gives the same for other lanes, so a warp takes it for
    // all its lanes if one needs it.
    if (legacy) {
      if constexpr (EVENTS) {
        if (__any_sync(FULL, ((n_f0 + 7.0f) - release_f) + 1.0f >= 1.0f
                                 && (n_f0 - release_f) + 1.0f <= ramp_f))
          legacy_terms(std::true_type{});
        else
          legacy_terms(std::false_type{});
      }
    } else {
      // Fast stage: spiral-folded terms; env advances once per group. A
      // pre-onset lane's c = 1 must not leak into the output.
      const float p = active0 ? env * s : 0.0f;
      const float pq = active0 ? env * c : 0.0f;
      terms_k[0] = amp * p;
#pragma unroll
      for (int j = 1; j < UNROLL; ++j)
        terms_k[j] = p * ra[j - 1] + pq * rb[j - 1];
      env = (is_mode && active0) ? env - env * dm8m1 : env;
    }
    const float d_s = s * ra[UNROLL - 1] + c * rb[UNROLL - 1];
    const float d_c = c * ra[UNROLL - 1] - s * rb[UNROLL - 1];
    s = (is_mode && active0) ? s + d_s : s;
    c = (is_mode && active0) ? c + d_c : c;
    __syncwarp();

    float stage = stage_k[0];
#pragma unroll
    for (int m = 1; m < NM; ++m) stage = stage + stage_k[m * ROW_PAD];
    float y_out = stage, omy = 0.0f, pn = 0.0f, r = 0.0f;
    if constexpr (!(VARIANT & V_NO_PICKUP)) {
      const float y_raw = (stage * onset_k + noise_k) * ds;
      const float abs_y = fabsf(y_raw);
      float y = y_raw;
      if (__any_sync(FULL, !(abs_y < knee))) {  // soft saturation
        const float sat = knee + rng_sat * tanhf((abs_y - knee) / rng_sat);
        y = abs_y < knee ? y_raw : (y_raw >= 0.0f ? sat : -sat);
      }
      omy = 1.0f - y;
      const float alpha = beta * omy;
      pn = 1.0f - alpha;
      r = 1.0f / (1.0f + alpha);
      pairs[k] = pn;
      pairs[UNROLL + k] = r;
    }
    __syncwarp();
    if constexpr (!(VARIANT & V_NO_PICKUP)) {
      float q_k = q;
      if constexpr (VARIANT & V_Q_SHUFFLE) {
        // thread j advances the charge of sample j - 1, then hands it on
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const float q_new = (q * pn + twob) * r;
          q_k = k == j ? q_new : q_k;
          q = __shfl_sync(FULL, q_new, j, TPL);
        }
      } else {
        const float4* pr4 = reinterpret_cast<const float4*>(pairs);
        const float4 p0 = pr4[0], p1 = pr4[1], r0 = pr4[2], r1 = pr4[3];
        const float pn8[UNROLL] = {p0.x, p0.y, p0.z, p0.w,
                                   p1.x, p1.y, p1.z, p1.w};
        const float r8[UNROLL] = {r0.x, r0.y, r0.z, r0.w,
                                  r1.x, r1.y, r1.z, r1.w};
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          q = (q * pn8[j] + twob) * r8[j];
          q_k = k == j ? q : q_k;
        }
      }
      y_out = (q_k * omy - 1.0f) * sens * post_gain;
    }
    if constexpr (STAGED) {
      // the block's lanes x 8 samples through shared memory (two buffers,
      // one barrier a group), stored as whole row segments; row j's lanes
      // are XOR-swizzled by quads so that a warp's writes meet no conflict
      const int lb = blockDim.x / TPL;
      auto swz = [&](int row) { return 4 * ((row * lb / 32) % (lb / 4)); };
      float* stg = staged[parity];
      stg[k * lb + ((int)threadIdx.x / TPL ^ swz(k))] = y_out;
      __syncthreads();
      const int row = threadIdx.x / lb, col = threadIdx.x % lb;
      const int lane = blockIdx.x * lb + col;
      if (lane < lanes && (!(VARIANT & V_FEW_STORES) || row == 0))
        out[(size_t)(n_out + row) * lanes + lane] =
            stg[row * lb + (col ^ swz(row))];
    } else if (valid && (!(VARIANT & V_FEW_STORES) || k == 0)) {
      out[(size_t)(n_out + k) * lanes + v] = y_out;
    }
    n_f0 += (float)UNROLL;
  };

  const int n_tiles = total / t_tile;
  for (int tile = 0; tile < n_tiles; ++tile) {
#pragma unroll 1
    for (int gi = 0; gi < t_tile / UNROLL; ++gi)
      group(gi & 1, tile * t_tile + gi * UNROLL);
    const int n_end = n0 + (tile + 1) * t_tile;
    if ((n_end & (RENORM_INTERVAL - 1)) < t_tile) {
      // K3: active as of the tile's last sample. Row 7 too.
      const bool act = !EVENTS || (n_f0 - 1.0f) >= onset_f;
      const float r_inv = rsqrtf(fmaxf(s * s + c * c, 1e-30f));
      s = act ? s * r_inv : s;
      c = act ? c * r_inv : c;
    }
  }

  if (valid) {
    state_out[(S0 + k) * lanes + v] = s;
    state_out[(C0 + k) * lanes + v] = c;
    state_out[(E0 + k) * lanes + v] = env;
    state_out[(D0 + k) * lanes + v] = drift;
    const float nst_o = k == 0 ? namp : k == 1 ? z1 : k == 2 ? z2
                        : k == 5 ? q : nst_k;
    state_out[(N0 + k) * lanes + v] = nst_o;
    const uint32_t irng_o = k == 0 ? jit : k == 1 ? nrng : irng_k;
    state_out[(I0 + k) * lanes + v] = __uint_as_float(irng_o);
  }
}

template <bool EVENTS, int VARIANT = 0>
int launch_voice_bank(const float* params, const float* state_in, float* out,
                      float* state_out, int lanes, int total, int t_tile,
                      int n0, float steady0, float steady1, float min_release,
                      cudaStream_t stream, int block = BLOCK) {
  if (lanes <= 0 || t_tile <= 0 || t_tile % 16 || total % t_tile || n0 % 16
      || block <= 0 || block % 32 || block > MAX_BLOCK)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)lanes * TPL + block - 1) / block);
  voice_bank_kernel<EVENTS, VARIANT><<<blocks, block, 0, stream>>>(
      params, state_in, out, state_out, lanes, total, t_tile, n0, steady0,
      steady1, min_release);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: the plain variant.
extern "C" int ow_voice_bank(const float* params, const float* state_in,
                             float* out, float* state_out, int lanes,
                             int total, int t_tile, int n0, float steady0,
                             float steady1, cudaStream_t stream) {
  return launch_voice_bank<false>(params, state_in, out, state_out, lanes,
                                  total, t_tile, n0, steady0, steady1, NEVER,
                                  stream);
}

// K3: the events variant; min_release is the earliest release sample of
// the whole schedule (>= 0.5e12: no lane is ever released).
extern "C" int ow_voice_bank_events(const float* params,
                                    const float* state_in, float* out,
                                    float* state_out, int lanes, int total,
                                    int t_tile, int n0, float steady0,
                                    float steady1, float min_release,
                                    cudaStream_t stream) {
  return launch_voice_bank<true>(params, state_in, out, state_out, lanes,
                                 total, t_tile, n0, steady0, steady1,
                                 min_release, stream);
}
