// Launchers of the float32 kernels (centered_clip.cuh): the stack is the
// (n, d) float32 gradient matrix.
//
// Replaces these Pallas TPU kernels (src/repro/kernels/centered_clip.py):
//   * butterfly_clip_fused_pallas   (fixed budget + Alg. 6 tables):
//       sq pass, n_iters x (update with incremental norms + finish
//       weights), dot pass, finish tables;
//   * verify_tables_batched_pallas  (tables against a given aggregate):
//       dot pass with norms, finish tables;
//   * adaptive_clip_step_pallas     (one early-exit iteration):
//       update with norms and ||dv||^2, finish weights;
//   * butterfly_clip_pallas         (two-phase CenteredClip, no tables):
//       n_iters x (sq pass, finish weights, update);
//   * digest_tables_batched_pallas  (verified:* digests, no tau):
//       dot pass with norms, finish digests;
//   * mean_digest_fused_pallas      (verified:mean, 2 passes):
//       mean pass, dot pass with norms, finish digests;
//   * digest_tables_rows_pallas     (sampled-digest audits: the k sampled
//       partitions only): the rows dot pass with norms, then finish
//       tables (tau > 0, clip weight) or finish digests (tau = 0), over k
//       rows instead of P partitions;
//   * centered_clip_fused_pallas    (one owner's fixed budget + tables, the
//       launch path): the passes of butterfly_clip_fused_pallas over one
//       (n, part) partition, P = 1;
//   * verify_tables_pallas          (one owner's tables against a given
//       aggregate, the launch path's adaptive epilogue): the passes of
//       verify_tables_batched_pallas at P = 1;
//   * centered_clip_pallas          (core.centered_clip's fixed budget over
//       one (n, d) stack, a per-iteration tau): the passes of
//       butterfly_clip_pallas at P = 1 (a bf16 stack runs wire.cu's passes
//       with unit scales, an exact widening).
// The three single-partition kernels read one contiguous (n, part)
// matrix, so the partition count is 1 and every pass spreads its CTAs
// over chunks of that one partition. Like the batched passes they are
// bound by bytes (a few float32 operations per element read): the design
// reads the stack once per pass, n_iters + 2 passes for the fused clip,
// one for the tables and 2 n_iters for the two-phase clip.
// The wire-payload twins of butterfly_clip_fused_pallas and
// mean_digest_fused_pallas are wire.cu.

#include "centered_clip.cuh"

using cc::kThreads;

// ---------------------------------------------------------------------------
// Plain C launchers (loaded with ctypes). Each enqueues on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 = ok).
// Any peer count n >= 1: above 32 the passes walk the peers in tiles.
// ---------------------------------------------------------------------------
extern "C" int cc_sq_pass(const float* x, long long ld, long long part,
                          long long d, int n, int P, const float* v,
                          long long cs, int C, float* sq_part, void* stream) {
  const auto s = cc::make_stack<0>(x, nullptr, ld, part, d, n);
  const dim3 grid(C, P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(N) \
  cc::sq_pass_kernel<N, 0><<<grid, kThreads, 0, st>>>(s, v, cs, sq_part)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

// `scratch`: a (P, part) f32 buffer, needed only above 32 peers when the
// update carries the next norms (sq_part given).
extern "C" int cc_update(const float* x, long long ld, long long part,
                         long long d, int n, int P, float* v, const float* cw,
                         const float* wsum, long long cs, int C,
                         float* sq_part, float* d2_part, const float* d2,
                         float tol2, float* scratch, void* stream) {
  const auto s = cc::make_stack<0>(x, nullptr, ld, part, d, n);
  const dim3 grid(C, P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool with_sq = sq_part != nullptr, with_d2 = d2 != nullptr;
  if (with_sq && n > cc::kTile && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
#define LAUNCH_SD(N, SQ, D2)                                         \
  cc::update_kernel<N, 0, SQ, D2><<<grid, kThreads, 0, st>>>(       \
      s, v, cw, wsum, cs, sq_part, d2_part, d2, tol2, scratch)
#define LAUNCH(N)                      \
  do {                                 \
    if (with_sq && with_d2) {          \
      LAUNCH_SD(N, true, true);        \
    } else if (with_sq) {              \
      LAUNCH_SD(N, true, false);       \
    } else if (with_d2) {              \
      LAUNCH_SD(N, false, true);       \
    } else {                           \
      LAUNCH_SD(N, false, false);      \
    }                                  \
  } while (0)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
#undef LAUNCH_SD
  return cc::launch_status();
}

namespace {

// The dot pass over P partitions, or over the k partitions `rows` (device
// memory, k int32 ids in [0, P), checked by the caller) when given.
int dot_pass(const float* x, long long ld, long long part, long long d,
             int n, int n_rows, const int* rows, const float* v,
             const float* z, long long cs, int C, float* dot_part,
             float* sq_part, void* stream) {
  const auto s = cc::make_stack<0>(x, nullptr, ld, part, d, n);
  const dim3 grid(C, n_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(N)                                                       \
  do {                                                                  \
    if (sq_part != nullptr) {                                           \
      cc::dot_pass_kernel<N, 0, true><<<grid, kThreads, 0, st>>>(       \
          s, v, z, cs, dot_part, sq_part, rows);                        \
    } else {                                                            \
      cc::dot_pass_kernel<N, 0, false><<<grid, kThreads, 0, st>>>(      \
          s, v, z, cs, dot_part, sq_part, rows);                        \
    }                                                                   \
  } while (0)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

}  // namespace

extern "C" int cc_dot_pass(const float* x, long long ld, long long part,
                           long long d, int n, int P, const float* v,
                           const float* z, long long cs, int C,
                           float* dot_part, float* sq_part, void* stream) {
  return dot_pass(x, ld, part, d, n, P, nullptr, v, z, cs, C, dot_part,
                  sq_part, stream);
}

// The sampled-digest pass: dot and square partials (k, C, n) of the k
// partitions rows[0..k) only; cs and C are those of the full P-partition
// stack, so row j sums what row rows[j] of cc_dot_pass sums, in its order.
// P is taken with the other stack arguments of every pass and not needed.
extern "C" int cc_rows_dot_pass(const float* x, long long ld, long long part,
                                long long d, int n, int P, const int* rows,
                                int k, const float* v, const float* z,
                                long long cs, int C, float* dot_part,
                                float* sq_part, void* stream) {
  (void)P;
  return dot_pass(x, ld, part, d, n, k, rows, v, z, cs, C, dot_part,
                  sq_part, stream);
}

extern "C" int cc_mean_pass(const float* x, long long ld, long long part,
                            long long d, int n, int P, const float* w,
                            long long cs, int C, float* v, void* stream) {
  const auto s = cc::make_stack<0>(x, nullptr, ld, part, d, n);
  const dim3 grid(C, P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(N) \
  cc::mean_pass_kernel<N, 0><<<grid, kThreads, 0, st>>>(s, w, cs, v)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

extern "C" int cc_finish_weights(const float* sq_part, int P, int C, int n,
                                 const float* w, float tau, float* sq_out,
                                 float* cw_out, float* wsum_out,
                                 const float* d2_part, float* d2, int* iters,
                                 float tol2, void* stream) {
  cc::finish_weights_kernel<<<cc::finish_grid(P, n), 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      sq_part, C, n, w, tau, sq_out, cw_out, wsum_out, d2_part, d2, iters,
      tol2);
  return cc::launch_status();
}

extern "C" int cc_finish_tables(const float* dot_part, const float* sq_part,
                                const float* sq_in, int P, int C, int n,
                                float tau, float* s_out, float* norm_out,
                                void* stream) {
  cc::finish_tables_kernel<true>
      <<<cc::finish_grid(P, n), 32, 0, static_cast<cudaStream_t>(stream)>>>(
          dot_part, sq_part, sq_in, C, n, tau, s_out, norm_out);
  return cc::launch_status();
}

extern "C" int cc_finish_digests(const float* dot_part, const float* sq_part,
                                 int P, int C, int n, float* s_out,
                                 float* norm_out, void* stream) {
  cc::finish_tables_kernel<false>
      <<<cc::finish_grid(P, n), 32, 0, static_cast<cudaStream_t>(stream)>>>(
          dot_part, sq_part, nullptr, C, n, 0.f, s_out, norm_out);
  return cc::launch_status();
}
