// Voice bank (kernel K1) for Hopper: 7 modal reed modes + attack noise +
// electrostatic pickup, one thread per voice lane.
//
// Replaces: openwurli_tpu/kernels/voice_bank.py, `_kernel_body` as built by
// `_make_kernel` and launched by `_render_voice_bank_jit` (plain variant,
// events=False, steady gating on).
//
// What bounds it on this card: the per-lane recurrence is serial in time,
// so a lane's work cannot be split; the card fills only with thousands of
// lanes, and each thread's arithmetic latency (the 8-deep serial pickup
// charge update per group, the composed-power refresh every 16 samples)
// sets the time. Memory traffic is one f32 store per lane and sample.
//
// What the design does about it: all per-lane state (s, c, env, drift of
// the 7 modes, the noise/pickup rows and both LCGs) and the composed
// rotation powers live in registers / local memory for the whole call;
// params and state are read once and the state written once, in the
// reference's packed layouts; a warp's 32 lanes store one sample's outputs
// to 32 consecutive floats (coalesced). Like the reference, 8-sample
// groups advance the envelope once, the OU jitter refreshes the powers
// only when drift changes, and the onset/noise branches are skipped past
// the `steady` horizon (a uniform branch: every lane sees the same n).
// The quadrature renorm fires at the end of each t_tile-sample tile whose
// span holds a multiple of 1024 — the reference's rule, with t_tile
// computed from the lane count by the wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NM = 7;        // modes
constexpr int SUB = 8;       // rows per packed block
constexpr int UNROLL = 8;    // samples per group
constexpr int JITTER_SUBSAMPLE = 16;
constexpr int RENORM_INTERVAL = 1024;
constexpr int STATE_ROWS = 48;
constexpr int ROW_COSM1 = 0, ROW_SIN = 1, ROW_PHASE = 2, ROW_AMP = 3,
              ROW_DECAYM1 = 4, ROW_SCAL = 5, ROW_NOISE = 8, ROW_DM8M1 = 12;
constexpr int S0 = 0, C0 = 8, E0 = 16, D0 = 24, N0 = 32, I0 = 40;

__constant__ uint32_t kLcgAPow[NM] = {
    1664525u, 389569705u, 2940799637u, 158984081u, 2862450781u,
    3211393721u, 1851289957u};
__constant__ uint32_t kLcgCAcc[NM] = {
    1013904223u, 1196435762u, 3519870697u, 2868466484u, 1649599747u,
    2670642822u, 1476291629u};

__global__ void __launch_bounds__(128)
voice_bank_kernel(const float* __restrict__ params,
                  const float* __restrict__ state_in,
                  float* __restrict__ out, float* __restrict__ state_out,
                  int lanes, int total, int t_tile, int n0, float steady0,
                  float steady1) {
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
  float rota[UNROLL][NM], rotb[UNROLL][NM];
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
      if ((n_g & (JITTER_SUBSAMPLE - 1)) == 0) {
        // NM draws from one composed-LCG step per mode.
        const uint32_t st = irng[0];
        uint32_t sk = st;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          sk = kLcgAPow[m] * st + kLcgCAcc[m];
          const float u = (float)(int32_t)(sk >> 1) * u_scale;
          const float noise = (u * 2.0f - 1.0f) * sqrt3;
          drift[m] = revert * drift[m] + diffusion * noise;
        }
        irng[0] = sk;
        refresh();
      }

      if (n_f0 < steady0) {  // onset ramp rows for the group
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
          const float n_loc = n_f0 + (float)j;
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
          const float n_loc = n_f0 + (float)j;
          irng[1] = irng[1] * 1664525u + 1013904223u;
          const float white = (float)(int32_t)irng[1] * w_scale;
          const bool nact = n_loc < noise_dur;
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

      // Spiral-folded mode sums; env advances once per group.
      float stage[UNROLL];
      float p_row[NM], q_row[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        p_row[m] = env[m] * s[m];
        q_row[m] = env[m] * c[m];
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
      for (int m = 0; m < NM; ++m) {
        env[m] = env[m] - env[m] * dm8m1[m];
        const float d_s = s[m] * rota[UNROLL - 1][m] + c[m] * rotb[UNROLL - 1][m];
        const float d_c = c[m] * rota[UNROLL - 1][m] - s[m] * rotb[UNROLL - 1][m];
        s[m] = s[m] + d_s;
        c[m] = c[m] + d_c;
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
#pragma unroll
      for (int m = 0; m < SUB; ++m) {
        const float r_inv = rsqrtf(fmaxf(s[m] * s[m] + c[m] * c[m], 1e-30f));
        s[m] = s[m] * r_inv;
        c[m] = c[m] * r_inv;
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

}  // namespace

extern "C" int ow_voice_bank(const float* params, const float* state_in,
                             float* out, float* state_out, int lanes,
                             int total, int t_tile, int n0, float steady0,
                             float steady1, cudaStream_t stream) {
  if (lanes <= 0 || t_tile <= 0 || t_tile % 16 || total % t_tile)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (lanes + threads - 1) / threads;
  voice_bank_kernel<<<blocks, threads, 0, stream>>>(
      params, state_in, out, state_out, lanes, total, t_tile, n0, steady0,
      steady1);
  return (int)cudaGetLastError();
}
