// Where E4's time goes on the card (voice.render's voices, and E4<tap>,
// run_calibrate's reed and pickup taps), built and run by
// tools/torch_voice_breakdown.py. Three designs in one binary:
//   thread          E4 before its lane redesign: a thread per voice,
//                   blocks of 32, `voice_sample<TAP>` (E1 ran it too
//                   before its own lane redesign)
//   thread guarded  the same with cos, pow, exp, sqrt and tanh run only
//                   where their value is selected, a vote per warp (the
//                   lane kernel's rule) and nothing else changed:
//                   `voice_sample_guarded`, which E1's thread form runs
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
// tile, the cluster barrier and the sum (each block's slots alone); then
// E1's thread form (engine_voices_thread_kernel, a thread per slot)
// without its votes (as it ran before), the library's (its votes, 1 block
// per SM) and with votes at launch bounds of 3 and 4 blocks per SM, each
// exact
enum {
  W1_LIBRARY, W1_NO_SUM, W1_NO_CLUSTER, W1_THREAD_UNGUARDED, W1_THREAD_1,
  W1_THREAD_3, W1_THREAD_4, kE1Variants
};

namespace {

// a copy of engine_voices_thread_kernel (E1's thread form) at another
// launch bound (MIN_BLOCKS blocks per SM) and, with GUARDED false,
// voice_sample on every slot (E1's thread form before its votes)
template <int MIN_BLOCKS, bool GUARDED>
__global__ void __launch_bounds__(SLOTS, MIN_BLOCKS)
e1b_thread_kernel(const double* __restrict__ vpar, double* vst,
                  long long* vsti, long long* eng_i, double* mono, int n,
                  double fade_len, double sample_rate) {
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
  long long gate = eng_i[j];
  if (j == 0) fires = 0;

  for (int t0 = 0; t0 < n; t0 += E1_TILE) {
    const int tn = min(E1_TILE, n - t0);
    if (j < E1_TILE) bad_tile[j] = 0;
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      const double out = GUARDED ? voice_sample_guarded<false>(v, nullptr,
                                                               true)
                                 : voice_sample<false>(v, nullptr);
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

template <int MIN_BLOCKS, bool GUARDED>
int e1b_thread(const double* vpar, double* vst, long long* vsti,
               long long* eng_i, double* mono, int n, int b,
               double fade_len, double sample_rate, cudaStream_t stream) {
  e1b_thread_kernel<MIN_BLOCKS, GUARDED>
      <<<b, SLOTS, 0, stream>>>(vpar, vst, vsti, eng_i, mono, n, fade_len,
                                sample_rate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int e1b_count() { return kE1Variants; }

extern "C" int e1b_launch(int which, const double* vpar, double* vst,
                          long long* vsti, long long* eng_i, double* mono,
                          int n, int b, double fade_len, double sample_rate,
                          cudaStream_t stream) {
  if (n < 0 || b <= 0) return (int)cudaErrorInvalidValue;
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
    case W1_THREAD_UNGUARDED:
      return e1b_thread<1, false>(vpar, vst, vsti, eng_i, mono, n, b,
                                  fade_len, sample_rate, stream);
    case W1_THREAD_1:
      return ow_engine_voices_thread(vpar, vst, vsti, eng_i, mono, n, b,
                                     fade_len, sample_rate, stream);
    case W1_THREAD_3:
      return e1b_thread<3, true>(vpar, vst, vsti, eng_i, mono, n, b,
                                 fade_len, sample_rate, stream);
    case W1_THREAD_4:
      return e1b_thread<4, true>(vpar, vst, vsti, eng_i, mono, n, b,
                                 fade_len, sample_rate, stream);
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
