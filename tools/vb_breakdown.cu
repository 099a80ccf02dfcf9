// Where a voice-bank (K1/K3) group's time goes on the card: timing
// variants of the kernel, built and run by tools/torch_vb_breakdown.py.
//
// Beside `voice_bank_kernel` (csrc/voice_bank.cu, eight threads per voice
// lane) at three block sizes, and its VARIANT flags (the charge handed
// thread to thread, whole-row stores through a block barrier, pieces
// switched off), this file holds
// the earlier design, one thread per voice lane, as `one_thread_kernel`. A variant with a piece switched off computes
// something else and is timed only; a variant marked exact must equal the
// kernel bit for bit, which the tool checks.

#include "../openwurli_tpu_torch/csrc/voice_bank.cu"

namespace {

// One thread per voice lane: all 7 modes, the attack noise and the pickup
// of a lane in one thread, its rotation powers in local memory.
template <bool EVENTS>
__global__ void __launch_bounds__(128)
one_thread_kernel(const float* __restrict__ params,
                  const float* __restrict__ state_in,
                  float* __restrict__ out, float* __restrict__ state_out,
                  int lanes, int total, int t_tile, int n0, float steady0,
                  float steady1, float min_release) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= lanes) return;
  auto P = [&](int row, int m) { return params[(row * SUB + m) * lanes + v]; };
  auto ST = [&](int r) { return state_in[r * lanes + v]; };

  float cosm1[NM], sin_inc[NM], phase_inc[NM], amp[NM], decaym1[NM],
      dm8m1[NM];
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    cosm1[m] = P(ROW_COSM1, m);
    sin_inc[m] = P(ROW_SIN, m);
    phase_inc[m] = P(ROW_PHASE, m);
    amp[m] = P(ROW_AMP, m);
    decaym1[m] = P(ROW_DECAYM1, m);
    dm8m1[m] = P(ROW_DM8M1, m);
  }
  const float onset_samps = P(ROW_SCAL, 0), onset_inc = P(ROW_SCAL, 1),
              onset_exp = P(ROW_SCAL, 2), revert = P(ROW_SCAL, 3),
              diffusion = P(ROW_SCAL, 4), beta = P(ROW_SCAL, 5),
              ds = P(ROW_SCAL, 6), post_gain = P(ROW_SCAL, 7);
  const float noise_decay = P(ROW_NOISE, 1), noise_dur = P(ROW_NOISE, 2),
              nb0 = P(ROW_NOISE, 3), nb2 = P(ROW_NOISE, 4),
              na1 = P(ROW_NOISE, 5), na2 = P(ROW_NOISE, 6);
  // Events schedule and damper constants (K3 only).
  float onset_f = 0.0f, release_f = NEVER, ramp_f = 1.0f;
  float drate[NM], dm1[NM];
  if constexpr (EVENTS) {
    onset_f = P(ROW_EVT, EVT_ONSET_F);
    release_f = P(ROW_EVT, EVT_RELEASE_F);
    ramp_f = P(ROW_EVT, EVT_RAMP);
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      drate[m] = P(ROW_DRATE, m);
      dm1[m] = P(ROW_DM1, m);
    }
  }
  // A schedule that never releases never takes the legacy stage.
  const bool legacy_possible = EVENTS && min_release < 0.5f * NEVER;

  // State rows; row 7 of each block is padding (no mode) and is carried
  // through exactly as the reference's arithmetic leaves it.
  float s[SUB], c[SUB], env[SUB], drift[SUB], nst[SUB];
  uint32_t irng[SUB];
#pragma unroll
  for (int m = 0; m < SUB; ++m) {
    s[m] = ST(S0 + m);
    c[m] = ST(C0 + m);
    env[m] = ST(E0 + m);
    drift[m] = ST(D0 + m);
    nst[m] = ST(N0 + m);
    irng[m] = __float_as_uint(ST(I0 + m));
  }

  // Composed rotation powers: slots 0..6 hold the folded output
  // coefficients for sub-steps 1..7, slot 7 the raw R^8 (state advance).
  // K3 also keeps raw R^1..R^7 (rawa/rawb) for the legacy stage.
  float rota[UNROLL][NM], rotb[UNROLL][NM];
  float rawa[EVENTS ? UNROLL - 1 : 1][NM], rawb[EVENTS ? UNROLL - 1 : 1][NM];
  auto refresh = [&]() {
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float delta = drift[m] * phase_inc[m];
      const float a1 = cosm1[m] - delta * sin_inc[m];
      const float b1 = delta * (1.0f + cosm1[m]) + sin_inc[m];
      const float dm = 1.0f - decaym1[m];
      float dj = amp[m] * dm;
      rota[0][m] = dj + dj * a1;
      rotb[0][m] = dj * b1;
      if constexpr (EVENTS) {
        rawa[0][m] = a1;
        rawb[0][m] = b1;
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
          rota[j - 1][m] = dj + dj * aj;
          rotb[j - 1][m] = dj * bj;
          if constexpr (EVENTS) {
            rawa[j - 1][m] = aj;
            rawb[j - 1][m] = bj;
          }
        } else {
          rota[UNROLL - 1][m] = aj;
          rotb[UNROLL - 1][m] = bj;
        }
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

  float onset8[UNROLL], noise8[UNROLL];
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    onset8[j] = 1.0f;
    noise8[j] = 0.0f;
  }

  float n_f0 = (float)n0;  // f32 sample counter (exact to 2^24 samples)
  const int n_tiles = total / t_tile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    for (int gi = 0; gi < t_tile / UNROLL; ++gi) {
      const int n_g = n0 + tile * t_tile + gi * UNROLL;
      // Onsets are multiples of 16: constant over the 8-sample group.
      const bool active0 = !EVENTS || (n_f0 - onset_f) >= 0.0f;
      if ((n_g & (JITTER_SUBSAMPLE - 1)) == 0) {
        // NM draws from one composed-LCG step per mode. A pre-onset
        // lane's stream has not started: it keeps drift and LCG state.
        const uint32_t st = irng[0];
        uint32_t sk = st;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          sk = kLcgAPow[m] * st + kLcgCAcc[m];
          const float u = (float)(int32_t)(sk >> 1) * u_scale;
          const float noise = (u * 2.0f - 1.0f) * sqrt3;
          const float nd = revert * drift[m] + diffusion * noise;
          drift[m] = active0 ? nd : drift[m];
        }
        irng[0] = active0 ? sk : st;
        refresh();
      }

      if (n_f0 < steady0) {  // onset ramp rows for the group
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          // onset-local time (onset_f is 0 without events: n − 0 = n)
          const float n_loc = EVENTS ? (n_f0 + (float)j) - onset_f
                                     : n_f0 + (float)j;
          const float cosine = 0.5f * (1.0f - cosf(n_loc * onset_inc));
          float shaped;
          if (onset_exp <= 1.001f) shaped = cosine;
          else if (onset_exp >= 1.999f) shaped = cosine * cosine;
          else shaped = powf(fmaxf(cosine, 1e-30f), onset_exp);
          onset8[j] = n_loc < onset_samps ? shaped : 1.0f;
        }
      }
      if (n_f0 < steady1) {  // attack noise: LCG → bandpass → envelope
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const float n_loc = EVENTS ? (n_f0 + (float)j) - onset_f
                                     : n_f0 + (float)j;
          const bool active = !EVENTS || n_loc >= 0.0f;
          const uint32_t nrng = irng[1] * 1664525u + 1013904223u;
          irng[1] = active ? nrng : irng[1];
          const float white = (float)(int32_t)nrng * w_scale;
          const bool nact = n_loc < noise_dur && active;
          const float namp = nst[0], z1 = nst[1], z2 = nst[2];
          const float filtered = nb0 * white + z1;
          const float z1_new = -na1 * filtered + z2;
          const float z2_new = nb2 * white - na2 * filtered;
          const float fade_t = fminf(n_loc / 16.0f, 1.0f);
          float fade = 0.5f * (1.0f - cosf(pi_f * fade_t));
          fade = n_loc < 16.0f ? fade : 1.0f;
          noise8[j] = nact ? namp * fade * filtered : 0.0f;
          nst[0] = nact ? namp * noise_decay : namp;
          nst[1] = nact ? z1_new : z1;
          nst[2] = nact ? z2_new : z2;
        }
      }

      float stage[UNROLL];
      if (legacy_possible && n_f0 + (float)UNROLL > min_release) {
        // Legacy stage (K3 past min_release): damper and natural decay
        // per sub-step; s_j from the group's start through raw R^j.
        if constexpr (EVENTS) {
          const float ramp_div = fmaxf(ramp_f, 1.0f);
#pragma unroll
          for (int j = 0; j < UNROLL; ++j) {
            const float t_rel = ((n_f0 + (float)j) - release_f) + 1.0f;
            const bool in_ramp = t_rel >= 1.0f && t_rel <= ramp_f;
            const bool post = t_rel > ramp_f;
            const float ratio = t_rel / ramp_div;
            float acc = 0.0f;
#pragma unroll
            for (int m = 0; m < NM; ++m) {
              const float inst = drate[m] * ratio;
              float e = env[m];
              e = in_ramp ? e * expf(-inst) : e;
              e = post ? e - e * dm1[m] : e;
              float sj = s[m];
              if (j > 0) {
                const float rot = s[m] * rawa[j - 1][m] + c[m] * rawb[j - 1][m];
                sj = s[m] + (active0 ? rot : 0.0f);
              }
              acc += (amp[m] * sj) * e;
              env[m] = active0 ? e - e * decaym1[m] : e;
            }
            stage[j] = acc;
          }
        }
      } else {
        // Fast stage: spiral-folded mode sums; env advances once per
        // group. A pre-onset lane's c = 1 must not leak into the output.
        float p_row[NM], q_row[NM];
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          p_row[m] = active0 ? env[m] * s[m] : 0.0f;
          q_row[m] = active0 ? env[m] * c[m] : 0.0f;
        }
        {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < NM; ++m) acc += amp[m] * p_row[m];
          stage[0] = acc;
        }
#pragma unroll
        for (int j = 1; j < UNROLL; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < NM; ++m)
            acc += p_row[m] * rota[j - 1][m] + q_row[m] * rotb[j - 1][m];
          stage[j] = acc;
        }
#pragma unroll
        for (int m = 0; m < NM; ++m)
          env[m] = active0 ? env[m] - env[m] * dm8m1[m] : env[m];
      }
      // Group-end state advance by raw R^8.
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const float d_s = s[m] * rota[UNROLL - 1][m] + c[m] * rotb[UNROLL - 1][m];
        const float d_c = c[m] * rota[UNROLL - 1][m] - s[m] * rotb[UNROLL - 1][m];
        s[m] = active0 ? s[m] + d_s : s[m];
        c[m] = active0 ? c[m] + d_c : c[m];
      }

      // Pickup: soft saturation, bilinear charge update, post gain.
      float q = nst[5];
      const int n_out = tile * t_tile + gi * UNROLL;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const float y_raw = (stage[j] * onset8[j] + noise8[j]) * ds;
        const float abs_y = fabsf(y_raw);
        const float sat = knee + rng_sat * tanhf((abs_y - knee) / rng_sat);
        const float y = abs_y < knee ? y_raw : (y_raw >= 0.0f ? sat : -sat);
        const float omy = 1.0f - y;
        const float alpha = beta * omy;
        const float pn = 1.0f - alpha;
        const float r = 1.0f / (1.0f + alpha);
        q = (q * pn + twob) * r;
        out[(size_t)(n_out + j) * lanes + v] =
            (q * omy - 1.0f) * sens * post_gain;
      }
      nst[5] = q;
      n_f0 += (float)UNROLL;
    }

    const int n_end = n0 + (tile + 1) * t_tile;
    if ((n_end & (RENORM_INTERVAL - 1)) < t_tile) {
      // K3: active as of the tile's last sample.
      const bool act = !EVENTS || (n_f0 - 1.0f) >= onset_f;
#pragma unroll
      for (int m = 0; m < SUB; ++m) {
        const float r_inv = rsqrtf(fmaxf(s[m] * s[m] + c[m] * c[m], 1e-30f));
        s[m] = act ? s[m] * r_inv : s[m];
        c[m] = act ? c[m] * r_inv : c[m];
      }
    }
  }

#pragma unroll
  for (int m = 0; m < SUB; ++m) {
    state_out[(S0 + m) * lanes + v] = s[m];
    state_out[(C0 + m) * lanes + v] = c[m];
    state_out[(E0 + m) * lanes + v] = env[m];
    state_out[(D0 + m) * lanes + v] = drift[m];
    state_out[(N0 + m) * lanes + v] = nst[m];
    state_out[(I0 + m) * lanes + v] = __uint_as_float(irng[m]);
  }
}


template <bool EVENTS>
int launch_one_thread(const float* params, const float* state_in, float* out,
                      float* state_out, int lanes, int total, int t_tile,
                      int n0, float steady0, float steady1, float min_release,
                      cudaStream_t stream, int block) {
  const int blocks = (lanes + block - 1) / block;
  one_thread_kernel<EVENTS><<<blocks, block, 0, stream>>>(
      params, state_in, out, state_out, lanes, total, t_tile, n0, steady0,
      steady1, min_release);
  return (int)cudaGetLastError();
}

// Only the stage terms, the state advance and the stores.
constexpr int STAGE_ONLY = V_NO_PICKUP | V_NO_REFRESH | V_NO_LEGACY | V_NO_WARM;

typedef int (*Launch)(const float*, const float*, float*, float*, int, int,
                      int, int, float, float, float, cudaStream_t, int);

struct Variant {
  Launch k1, k3;
  int block;
};

constexpr Variant kVariants[] = {
    {launch_one_thread<false>, launch_one_thread<true>, 128},
    {launch_voice_bank<false, 0>, launch_voice_bank<true, 0>, 128},
    {launch_voice_bank<false, 0>, launch_voice_bank<true, 0>, 64},
    {launch_voice_bank<false, 0>, launch_voice_bank<true, 0>, 32},
    {launch_voice_bank<false, V_Q_SHUFFLE>,
     launch_voice_bank<true, V_Q_SHUFFLE>, 128},
    {launch_voice_bank<false, V_STAGED>, launch_voice_bank<true, V_STAGED>, 128},
    {launch_voice_bank<false, V_NO_PICKUP>, launch_voice_bank<true, V_NO_PICKUP>,
     128},
    {launch_voice_bank<false, V_NO_REFRESH>,
     launch_voice_bank<true, V_NO_REFRESH>, 128},
    {launch_voice_bank<false, V_NO_LEGACY>, launch_voice_bank<true, V_NO_LEGACY>,
     128},
    {launch_voice_bank<false, V_NO_WARM>, launch_voice_bank<true, V_NO_WARM>, 128},
    {launch_voice_bank<false, V_FEW_STORES>,
     launch_voice_bank<true, V_FEW_STORES>, 128},
    {launch_voice_bank<false, STAGE_ONLY>, launch_voice_bank<true, STAGE_ONLY>,
     128},
    {launch_voice_bank<false, STAGE_ONLY | V_FEW_STORES>,
     launch_voice_bank<true, STAGE_ONLY | V_FEW_STORES>, 128},
    {launch_voice_bank<false, STAGE_ONLY | V_STAGED>,
     launch_voice_bank<true, STAGE_ONLY | V_STAGED>, 128},
};

}  // namespace

extern "C" int vbb_count() {
  return (int)(sizeof(kVariants) / sizeof(kVariants[0]));
}

extern "C" int vbb_launch(int which, int events, const float* params,
                          const float* state_in, float* out, float* state_out,
                          int lanes, int total, int t_tile, int n0,
                          float steady0, float steady1, float min_release,
                          cudaStream_t stream) {
  if (which < 0 || which >= vbb_count()) return (int)cudaErrorInvalidValue;
  const Variant& v = kVariants[which];
  return (events ? v.k3 : v.k1)(params, state_in, out, state_out, lanes,
                                total, t_tile, n0, steady0, steady1,
                                min_release, stream, v.block);
}
