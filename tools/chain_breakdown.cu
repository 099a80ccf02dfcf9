// E2, built and run by tools/torch_chain_breakdown.py three times:
// -DOW_BEHAVIORAL_ALL_LANES=1 (the library's settings), =0 (the
// behavioral warp form's behavioral() on lane 0 alone) and
// -DOW_HALF_STAMPS=1 (the half form's stamped parts, into the buffer that
// cb_half_parts hands the kernel); and the latency of one behavioral()
// call:
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

}  // namespace

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
