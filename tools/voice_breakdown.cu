// Where E4's time goes on the card (voice.render's voices, and E4<tap>,
// run_calibrate's reed and pickup taps), built and run by
// tools/torch_voice_breakdown.py. Three designs in one binary:
//   thread          E4 before its lane redesign: a thread per voice,
//                   blocks of 32, `voice_sample<TAP>` (E1 ran it too
//                   before its own lane redesign)
//   thread guarded  the same with cos, pow, exp, sqrt and tanh run only
//                   where their value is selected, a vote per warp (the
//                   lane kernel's rule) and nothing else changed
//   lanes           `voice_lanes_kernel<TAP>` (E4 now), eight threads per
//                   voice, at 32 and 128 threads per block, with its
//                   stores staged through shared memory, and stamped:
//                   the SM's cycle counter (clock64) read between the
//                   group's parts, each part's cycles added per voice:
//     modes   the mode threads' damper, jitter, shares, rotation, decay
//             and renorm over the group (and the __syncwarp after them)
//     sum     sample k's onset and noise fade ahead of the modes, and the
//             seven terms' sum after them
//     tail    the attack noise over the group, the saturation, the
//             charge factors and the charge recurrence
//     stores  the group's output (and reed) stores
// Every variant runs the arithmetic of voice_sample in its order, so each
// equals E4 bit for bit, which the tool checks. E1's knock-outs (e1b_*)
// show what its cluster barrier and slot sum add to E4's group body.

#include "../openwurli_tpu_torch/csrc/engine.cu"

namespace {

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

// voice_sample with its libm calls guarded by warp votes
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

// a thread per voice, blocks of 32; GUARDED: the voting step, every
// thread of a warp in every vote (voices past g hold zeros and store
// nothing)
template <bool TAP, bool GUARDED>
__global__ void __launch_bounds__(32)
e4b_thread_kernel(const double* __restrict__ vpar, double* vst,
                  long long* vsti, double* out, double* reed, int g, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = j < g;
  if (!GUARDED && !valid) return;
  Voice v = {};
  if (valid) voice_load(v, vpar, vst, vsti, g, j);
  for (int t = 0; t < n; ++t) {
    double r;
    const double y = GUARDED ? voice_sample_guarded<TAP>(v, &r, valid)
                             : voice_sample<TAP>(v, &r);
    if (valid) {
      out[(size_t)t * g + j] = y;
      if constexpr (TAP) reed[(size_t)t * g + j] = r;
    }
  }
  if (valid) voice_store(v, vst, vsti, g, j);
}

enum : int {
  W_THREAD, W_GUARDED, W_LANES_32, W_LANES_128, W_STAGED_128,
  W_STAMPED_32, kVariants
};

template <bool TAP>
int e4b_launch_tap(int which, const double* vpar, double* vst,
                   long long* vsti, double* out, double* reed,
                   long long* parts, int g, int n, cudaStream_t stream) {
  const int blocks = (g + 31) / 32;
  switch (which) {
    case W_THREAD:
      e4b_thread_kernel<TAP, false><<<blocks, 32, 0, stream>>>(
          vpar, vst, vsti, out, reed, g, n);
      return (int)cudaGetLastError();
    case W_GUARDED:
      e4b_thread_kernel<TAP, true><<<blocks, 32, 0, stream>>>(
          vpar, vst, vsti, out, reed, g, n);
      return (int)cudaGetLastError();
    case W_LANES_32:
      return launch_voice_lanes<TAP>(vpar, vst, vsti, out, reed, g, n,
                                     nullptr, 32, stream);
    case W_LANES_128:
      return launch_voice_lanes<TAP>(vpar, vst, vsti, out, reed, g, n,
                                     nullptr, 128, stream);
    case W_STAGED_128:
      return launch_voice_lanes<TAP, E4_STAGED>(vpar, vst, vsti, out, reed,
                                                g, n, nullptr, 128, stream);
    case W_STAMPED_32:
      return launch_voice_lanes<TAP, E4_STAMPED>(vpar, vst, vsti, out, reed,
                                                 g, n, parts, 32, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// E1 (engine_voices_kernel, a cluster of eight blocks per engine) and its
// knock-outs, timed only: without the leader's slot sum, and without the
// tile, the cluster barrier and the sum (each block's slots alone)
enum { W1_LIBRARY, W1_NO_SUM, W1_NO_CLUSTER, kE1Variants };

extern "C" int e1b_count() { return kE1Variants; }

extern "C" int e1b_launch(int which, const double* vpar, double* vst,
                          long long* vsti, long long* eng_i, double* mono,
                          int n, int b, double fade_len, double sample_rate,
                          cudaStream_t stream) {
  switch (which) {
    case W1_LIBRARY:
      return launch_engine_voices(vpar, vst, vsti, eng_i, mono, n, b,
                                  fade_len, sample_rate, stream);
    case W1_NO_SUM:
      return launch_engine_voices<E1_NO_SUM>(vpar, vst, vsti, eng_i, mono,
                                             n, b, fade_len, sample_rate,
                                             stream);
    case W1_NO_CLUSTER:
      return launch_engine_voices<E1_NO_CLUSTER>(
          vpar, vst, vsti, eng_i, mono, n, b, fade_len, sample_rate, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int e4b_count() { return kVariants; }
extern "C" int e4b_parts() { return E4_PARTS; }

// variant `which` of E4 (tap 0) or E4<tap> (tap 1) on packed columns:
// out and reed (n, G), parts (E4_PARTS, G) for the stamped variant
extern "C" int e4b_launch(int which, int tap, const double* vpar,
                          double* vst, long long* vsti, double* out,
                          double* reed, long long* parts, int g, int n,
                          cudaStream_t stream) {
  if (g <= 0 || n < 0 || which < 0 || which >= kVariants)
    return (int)cudaErrorInvalidValue;
  return tap ? e4b_launch_tap<true>(which, vpar, vst, vsti, out, reed, parts,
                                    g, n, stream)
             : e4b_launch_tap<false>(which, vpar, vst, vsti, out, reed,
                                     parts, g, n, stream);
}
