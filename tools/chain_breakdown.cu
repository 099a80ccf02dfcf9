// E2, built and run by tools/torch_chain_breakdown.py three times:
// -DOW_BEHAVIORAL_ALL_LANES=1 (the library's settings), =0 (the
// behavioral warp form's behavioral() on lane 0 alone) and
// -DOW_HALF_STAMPS=1 (the half form's stamped parts, into the buffer that
// cb_half_parts hands the kernel); E2's behavioral thread form as it ran
// before its working set moved into registers (cb_thread_old: a thread
// per engine, chain_sample over the engine's 205 rows in a local array),
// and a copy of it that reads the SM's cycle counter (clock64) between
// the parts of each sample and adds each part's cycles to the engine's
// row of `parts`: the tremolo (tremolo_step), the preamp's twins
// (preamp_step or melange_step), behavioral() and the rest (the
// smoothers, the allpass branches, the speaker, guard #2); the same
// arithmetic in the same order, so the same bits; and the latency of one
// behavioral() call:
// cb_behavioral runs n calls on one thread, each call's input made from
// the output before (x ← 0.05 + 1e-3 · behavioral(x)), so the time per
// call is the call's dependent chain: the 8 Newton iterations of an f64
// exp, a tanh and a division.

#include "../openwurli_tpu_torch/csrc/engine.cu"

namespace {

__global__ void cb_behavioral_kernel(double* x, int n) {
  double v = x[0];
  for (int t = 0; t < n; ++t) v = 0.05 + 1e-3 * behavioral(v);
  x[0] = v;
}

enum ThreadPart { TP_TREMOLO, TP_PREAMP, TP_BEHAVIORAL, TP_REST,
                  THREAD_PARTS };

__device__ __forceinline__ void stamp(long long* acc, int part,
                                      long long& t) {
  const long long now = clock64();
  acc[part] += now - t;
  t = now;
}

// nonlinear_step<PRE, PA_BEHAVIORAL>, stamped
template <int PRE>
__device__ __forceinline__ double cb_nonlinear_stamped(
    const double* c, const double* misc, double* ch, double depth, double u,
    double noise_scale, long long* acc, long long& t) {
  stamp(acc, TP_REST, t);
  const double shunt = tremolo_step(c, misc, ch, depth);
  stamp(acc, TP_TREMOLO, t);
  const double g = 1.0 / jmax(shunt, 1000.0);
  double pre;
  if constexpr (PRE == PRE_DK)
    pre = preamp_step(c + C_PRE, ch + CH_PRE_V, g, u);
  else
    pre = melange_step(c + C_MEL, ch + CH_MEL_V, g, u, noise_scale);
  stamp(acc, TP_PREAMP, t);
  const double y = behavioral(pre * 0.25);
  stamp(acc, TP_BEHAVIORAL, t);
  return y;
}

// chain_sample<PRE, PA_BEHAVIORAL>, stamped
template <int PRE>
__device__ __noinline__ double cb_chain_sample_stamped(
    const double* c, double* ch, double mono, double noise_scale,
    double* last_char, Speaker* spk_k, long long* acc) {
  long long t = clock64();
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
      y[h] = cb_nonlinear_stamped<PRE>(c, misc, ch, depth, us[h],
                                       noise_scale, acc, t);
    const double a = branch_step(kBranchA, ch + CH_OS_DOWN_A, y[0]);
    const double b = branch_step(kBranchB, ch + CH_OS_DOWN_B, y[1]);
    amp_out = (a + ch[CH_OS_DELAY]) * 0.5;
    ch[CH_OS_DELAY] = b;
  } else {
    amp_out = cb_nonlinear_stamped<PRE>(c, misc, ch, depth, mono,
                                        noise_scale, acc, t);
  }
  if (__double_as_longlong(chr) != __double_as_longlong(*last_char)) {
    *last_char = chr;
    speaker_design(chr, misc[M_SPK_SR], spk_k);
  }
  double* spk = ch + CH_SPK;
  const double y = speaker_step(*spk_k, spk, amp_out, misc[M_SPK_ALPHA]);
  double out = y * misc[M_POST_GAIN] * vol;
  if (!finite(out)) {
    for (int k = 0; k < OS_ROWS; ++k) ch[CH_OS_UP_A + k] = 0.0;
    if constexpr (PRE == PRE_DK)
      init_preamp(c + C_PRE, ch + CH_PRE_V);
    else
      init_melange(c + C_MEL, ch + CH_MEL_V);
    init_power_amp(c + C_PA, ch);
    for (int k = 0; k < 5; ++k) spk[k] = 0.0;
    out = 0.0;
  }
  stamp(acc, TP_REST, t);
  return out;
}

// the behavioral thread form before its redesign; STAMP: the stamped
// copy, engine e's cycles by part in parts[e * THREAD_PARTS + part]
template <int PRE, bool STAMP>
__global__ void cb_thread_old_kernel(const double* __restrict__ c,
                                     const double* __restrict__ mono,
                                     double* chain, float* out, int n, int b,
                                     const unsigned char* sag,
                                     const double* noise_scale,
                                     long long* parts) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= b) return;
  double ch[CHAIN_ROWS];
  for (int k = 0; k < CHAIN_ROWS; ++k)
    ch[k] = chain[(size_t)e * CHAIN_ROWS + k];
  double last_char = __longlong_as_double(0x7ff8dead0000beefLL);  // NaN
  Speaker spk_k;
  for (int t = 0; t < n; ++t) {
    const size_t i = (size_t)e * n + t;
    if constexpr (STAMP)
      out[i] = (float)cb_chain_sample_stamped<PRE>(
          c, ch, mono[i], noise_scale[e], &last_char, &spk_k,
          parts + (size_t)e * THREAD_PARTS);
    else
      out[i] = (float)chain_sample<PRE, PA_BEHAVIORAL>(
          c, ch, mono[i], sag[e] != 0, noise_scale[e], &last_char, &spk_k);
  }
  for (int k = 0; k < CHAIN_ROWS; ++k)
    chain[(size_t)e * CHAIN_ROWS + k] = ch[k];
}

}  // namespace

extern "C" int cb_thread_part_count() { return THREAD_PARTS; }

// the behavioral thread form before its redesign (stamp 0) or its stamped
// copy (stamp 1, parts (b, THREAD_PARTS) int64, zeroed by the caller);
// ow_engine_chain's arguments otherwise
extern "C" int cb_thread_old(int pre_model, int stamp, const double* consts,
                             int n_consts, const double* mono,
                             double* chain, float* out, int n, int b,
                             const unsigned char* rail_sag,
                             const double* noise_scale, long long* parts,
                             cudaStream_t stream) {
  const int want = C_TOTAL + (pre_model == PRE_MELANGE ? ML_SIZE : 0);
  if (n_consts != want || n < 0 || b <= 0 || pre_model < 0 ||
      pre_model > 1 || stamp < 0 || stamp > 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (b + 31) / 32, threads = b < 32 ? b : 32;
  const bool dk = pre_model == PRE_DK;
  if (dk && stamp)
    cb_thread_old_kernel<PRE_DK, true><<<blocks, threads, 0, stream>>>(
        consts, mono, chain, out, n, b, rail_sag, noise_scale, parts);
  else if (dk)
    cb_thread_old_kernel<PRE_DK, false><<<blocks, threads, 0, stream>>>(
        consts, mono, chain, out, n, b, rail_sag, noise_scale, parts);
  else if (stamp)
    cb_thread_old_kernel<PRE_MELANGE, true><<<blocks, threads, 0, stream>>>(
        consts, mono, chain, out, n, b, rail_sag, noise_scale, parts);
  else
    cb_thread_old_kernel<PRE_MELANGE, false><<<blocks, threads, 0, stream>>>(
        consts, mono, chain, out, n, b, rail_sag, noise_scale, parts);
  return (int)cudaGetLastError();
}

// the stamped half form's parts: (threads, cb_half_part_count() + 2)
// int64, zeroed by the caller
extern "C" int cb_half_part_count() { return HALF_PARTS; }
extern "C" int cb_half_parts(long long* buf, cudaStream_t stream) {
#if OW_HALF_STAMPS
  return (int)cudaMemcpyToSymbolAsync(g_half_parts, &buf, sizeof(buf), 0,
                                      cudaMemcpyHostToDevice, stream);
#else
  return (int)cudaErrorInvalidValue;
#endif
}

extern "C" int cb_behavioral(double* x, int n, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  cb_behavioral_kernel<<<1, 1, 0, stream>>>(x, n);
  return (int)cudaGetLastError();
}
