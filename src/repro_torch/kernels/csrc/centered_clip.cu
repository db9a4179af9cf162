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
//       up to 32 peers one read of the stack an iteration: the norms'
//       prologue, then n_iters x (finish weights, update carrying the
//       next iteration's norms); above, n_iters x (sq pass, finish
//       weights, update);
//   * digest_tables_batched_pallas  (verified:* digests, no tau):
//       dot pass with norms, finish digests;
//   * mean_digest_fused_pallas      (verified:mean): one read of the
//       stack, the pass that writes the mean and sums the digests'
//       partials against it, then finish digests;
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
// matrix, so the partition count is 1 and every pass walks the chunks of
// that one partition. Like the batched passes they are
// bound by bytes (a few float32 operations per element read): the design
// reads the stack once per pass, n_iters + 2 passes for the fused clip,
// one for the tables and for verified:mean (two above 32 peers), and
// n_iters + 1 for the two-phase clip (2 n_iters above 32 peers).
// The wire-payload twins of butterfly_clip_fused_pallas and
// mean_digest_fused_pallas are wire.cu.

#include "centered_clip.cuh"

using cc::kThreads;

// ---------------------------------------------------------------------------
// Plain C launchers (loaded with ctypes). Each enqueues on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 = ok).
// Every pass takes the stack (x, ld, part, d, n, P), its logical chunk grid
// (cs columns a chunk, C chunks a partition; kernels/centered_clip.py
// chunk_grid) and `vec`: 1 when every (peer, partition) row start of the
// stack and of each float32 vector it reads or writes is 16-byte aligned
// (the 16-byte loads), 0 otherwise (the same sums, loaded column by
// column). Any peer count n >= 1: above 32 the passes walk the peers in
// tiles. A null v in a pass that reads v reads zeros. `vec` 2
// (cc::kStaged; the norm, update and dot passes and verified:mean's pass,
// up to 8 peers): the staged body, every row start of the stack and the
// vectors 16-byte aligned; an ask it cannot run is refused, never run
// another way.
// ---------------------------------------------------------------------------
extern "C" int cc_sq_pass(const float* x, long long ld, long long part,
                          long long d, int n, int P, long long cs, int C,
                          int vec, const float* v, float* sq_part,
                          void* stream) {
  const auto s = cc::make_stack<0>(x, nullptr, ld, part, d, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = static_cast<long long>(P) * C;
  if (vec == cc::kStaged) {
    const int rc = cc::staged_status(s, v, nullptr);
    if (rc != 0) return rc;
    constexpr int DT = 0;
#define KERNEL(N) cc::sq_pass_kernel<N, DT, true, true>
    CC_LAUNCH_STAGED(1, s, v, cs, C, P, sq_part);
#undef KERNEL
  }
#define LAUNCH(N, V)                                                  \
  cc::launch_pass(cc::sq_pass_kernel<N, 0, V>, chunks, st, s, v, cs, C, \
                  P, sq_part)
  CC_DISPATCH_PEERS(n, vec, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

// One iteration from v_in (null: zeros) into v_out (may be v_in: in
// place), carrying the next iteration's norms into sq_part (the fused
// clip's incremental norms). `scratch`: a (P, part) f32 buffer, needed only
// above 32 peers. With d2 (the adaptive step) a frozen partition is
// neither read nor written, so v_out differs from v_in only in a first
// step, where d2 is +inf for every partition.
extern "C" int cc_update(const float* x, long long ld, long long part,
                         long long d, int n, int P, long long cs, int C,
                         int vec, const float* vin, float* vout,
                         const float* cw, const float* wsum, float* sq_part,
                         float* d2_part, const float* d2, float tol2,
                         float* scratch, void* stream) {
  const auto s = cc::make_stack<0>(x, nullptr, ld, part, d, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = static_cast<long long>(P) * C;
  const bool with_d2 = d2 != nullptr;
  if (sq_part == nullptr || (n > cc::kTile && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == cc::kStaged) {
    const int rc = cc::staged_status(s, vin, vout);
    if (rc != 0) return rc;
    constexpr int DT = 0;
    if (with_d2) {
#define KERNEL(N) cc::update_kernel<N, DT, true, true, true, true>
      CC_LAUNCH_STAGED(1, s, vin, vout, cw, wsum, cs, C, P, sq_part,
                       d2_part, d2, tol2, scratch);
#undef KERNEL
    }
#define KERNEL(N) cc::update_kernel<N, DT, true, false, true, true>
    CC_LAUNCH_STAGED(1, s, vin, vout, cw, wsum, cs, C, P, sq_part, d2_part,
                     d2, tol2, scratch);
#undef KERNEL
  }
#define LAUNCH_D(N, V, D2)                                                 \
  cc::launch_pass(cc::update_kernel<N, 0, true, D2, V>, chunks, st, s, vin, \
                  vout, cw, wsum, cs, C, P, sq_part, d2_part, d2, tol2,    \
                  scratch)
#define LAUNCH(N, V)             \
  do {                           \
    if (with_d2) {               \
      LAUNCH_D(N, V, true);      \
    } else {                     \
      LAUNCH_D(N, V, false);     \
    }                            \
  } while (0)
  CC_DISPATCH_PEERS(n, vec, LAUNCH);
#undef LAUNCH
#undef LAUNCH_D
  return cc::launch_status();
}

// One pass of the two-phase clip (#4, #12; centered_clip.cuh, "The
// two-phase clip"): vout null, the prologue's norms ||x_i - v_in||^2 into
// sq_part; else the update v_in -> v_out with clip weights cw and wsum,
// carrying the next iteration's norms ||x_i - v_out||^2 into sq_part when
// it is given. Up to 32 peers `vec` means every row start of the stack and
// the vectors is 16-byte aligned: the staged body; else the global body.
// Above 32 peers: the peer-tiled norm pass or update, never both in one
// pass.
extern "C" int cc_clip_pass(const float* x, long long ld, long long part,
                            long long d, int n, int P, long long cs, int C,
                            int vec, const float* vin, float* vout,
                            const float* cw, const float* wsum,
                            float* sq_part, void* stream) {
  return cc::clip_pass(cc::make_stack<0>(x, nullptr, ld, part, d, n), P, cs,
                       C, vec, vin, vout, cw, wsum, sq_part,
                       static_cast<cudaStream_t>(stream));
}

namespace {

// The dot pass over P partitions, or over the k partitions `rows` (device
// memory, k int32 ids in [0, P), checked by the caller) when given.
int dot_pass(const float* x, long long ld, long long part, long long d,
             int n, int n_rows, const int* rows, long long cs, int C,
             int vec, const float* v, const float* z, float* dot_part,
             float* sq_part, void* stream) {
  const auto s = cc::make_stack<0>(x, nullptr, ld, part, d, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = static_cast<long long>(n_rows) * C;
  if (vec == cc::kStaged) {
    const int rc = cc::staged_status(s, v, z);
    if (rc != 0) return rc;
    constexpr int DT = 0;
    if (sq_part != nullptr) {
#define KERNEL(N) cc::dot_pass_kernel<N, DT, true, true, true>
      CC_LAUNCH_STAGED(2, s, v, z, cs, C, n_rows, dot_part, sq_part, rows);
#undef KERNEL
    }
#define KERNEL(N) cc::dot_pass_kernel<N, DT, false, true, true>
    CC_LAUNCH_STAGED(2, s, v, z, cs, C, n_rows, dot_part, sq_part, rows);
#undef KERNEL
  }
#define LAUNCH(N, V)                                                        \
  do {                                                                      \
    if (sq_part != nullptr) {                                               \
      cc::launch_pass(cc::dot_pass_kernel<N, 0, true, V>, chunks, st, s, v, \
                      z, cs, C, n_rows, dot_part, sq_part, rows);           \
    } else {                                                                \
      cc::launch_pass(cc::dot_pass_kernel<N, 0, false, V>, chunks, st, s,   \
                      v, z, cs, C, n_rows, dot_part, sq_part, rows);        \
    }                                                                       \
  } while (0)
  CC_DISPATCH_PEERS(n, vec, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

}  // namespace

extern "C" int cc_dot_pass(const float* x, long long ld, long long part,
                           long long d, int n, int P, long long cs, int C,
                           int vec, const float* v, const float* z,
                           float* dot_part, float* sq_part, void* stream) {
  return dot_pass(x, ld, part, d, n, P, nullptr, cs, C, vec, v, z, dot_part,
                  sq_part, stream);
}

// The sampled-digest pass: dot and square partials (k, n, C) of the k
// partitions rows[0..k) only; cs and C are those of the full P-partition
// stack, so row j sums what row rows[j] of cc_dot_pass sums, in its order.
// P is taken with the other stack arguments of every pass and not needed.
extern "C" int cc_rows_dot_pass(const float* x, long long ld, long long part,
                                long long d, int n, int P, long long cs,
                                int C, int vec, const int* rows, int k,
                                const float* v, const float* z,
                                float* dot_part, float* sq_part,
                                void* stream) {
  (void)P;
  return dot_pass(x, ld, part, d, n, k, rows, cs, C, vec, v, z, dot_part,
                  sq_part, stream);
}

// verified:mean's one pass (#5; centered_clip.cuh, "verified:mean"): v =
// sum_i w_i x_i / max(sum_i w_i, 1e-30) into v, and the partials of <x_i
// - v, z> and ||x_i - v||^2 against it into dot_part and sq_part, the bits
// of a mean pass followed by cc_dot_pass with norms.
extern "C" int cc_mean_dot_pass(const float* x, long long ld, long long part,
                                long long d, int n, int P, long long cs,
                                int C, int vec, const float* w, float* v,
                                const float* z, float* dot_part,
                                float* sq_part, void* stream) {
  return cc::mean_dot_pass(cc::make_stack<0>(x, nullptr, ld, part, d, n), P,
                           cs, C, vec, w, v, z, dot_part, sq_part,
                           static_cast<cudaStream_t>(stream));
}

// The finishing kernels: a CTA per row of the (rows, n, C) partials and
// peer (the adaptive step's CTA of peer 0 also finishes ||dv||^2, writes
// d2 and iters, and copies d2 to d2_seen, pinned host memory, when given).
extern "C" int cc_finish_weights(const float* sq_part, int P, int C, int n,
                                 const float* w, float tau, float* sq_out,
                                 float* cw_out, float* wsum_out,
                                 const float* d2_part, float* d2, int* iters,
                                 float tol2, float* d2_seen, void* stream) {
  const dim3 grid(P, n);
  cc::finish_weights_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      sq_part, C, n, w, tau, sq_out, cw_out, wsum_out, d2_part, d2, iters,
      tol2, d2_seen);
  return cc::launch_status();
}

extern "C" int cc_finish_tables(const float* dot_part, const float* sq_part,
                                const float* sq_in, int P, int C, int n,
                                float tau, float* s_out, float* norm_out,
                                void* stream) {
  cc::finish_tables_kernel<true>
      <<<dim3(P, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          dot_part, sq_part, sq_in, C, n, tau, s_out, norm_out);
  return cc::launch_status();
}

extern "C" int cc_finish_digests(const float* dot_part, const float* sq_part,
                                 int P, int C, int n, float* s_out,
                                 float* norm_out, void* stream) {
  cc::finish_tables_kernel<false>
      <<<dim3(P, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          dot_part, sq_part, nullptr, C, n, 0.f, s_out, norm_out);
  return cc::launch_status();
}

// What the compiler made of a float32 pass, for a report: out[0] registers
// a thread, out[1] local (spill) bytes a thread, out[2] resident CTAs per
// SM, out[3] dynamic shared memory a CTA. `pass`: 0 the norm pass, 1 the
// update with norms, 2 the dot pass, 3 the dot pass with norms, 4
// verified:mean's pass (the mean with the digests' partials), 5 finish
// weights, 6 finish tables, 8 the update with norms and
// ||dv||^2 (the adaptive step); the two-phase clip's passes 7 (an update
// with the next norms), 9 (the prologue's norms) and 10 (the last update)
// up to 32 peers, with their dynamic shared memory. n and vec (0, 1, or 2:
// the staged body of passes 0-4 and 8, n <= 8, with its dynamic shared
// memory) pick the instantiation as a launch would.
extern "C" int cc_pass_info(int pass, int n, int vec, int* out) {
  out[3] = 0;
  if (pass == 4) return cc::mean_dot_pass_info<0>(n, vec, out);
  if (pass == 5) return cc::kernel_info(cc::finish_weights_kernel, out);
  if (pass == 6) return cc::kernel_info(cc::finish_tables_kernel<true>, out);
  if (pass == 7) return cc::clip_pass_info<0>(1, n, vec, out);
  if (pass == 9) return cc::clip_pass_info<0>(0, n, vec, out);
  if (pass == 10) return cc::clip_pass_info<0>(2, n, vec, out);
  if (vec == cc::kStaged) {
    if (n < 1 || n > 8) return static_cast<int>(cudaErrorInvalidValue);
#define INFO(N)                                                              \
  do {                                                                       \
    const int s1 = cc::span_smem<0>(n, 1), m1 = cc::span_smem<0>(N, 1);      \
    const int s2 = cc::span_smem<0>(n, 2), m2 = cc::span_smem<0>(N, 2);      \
    switch (pass) {                                                          \
      case 0:                                                                \
        return cc::kernel_info(cc::sq_pass_kernel<N, 0, true, true>, out, s1, \
                               m1);                                          \
      case 1:                                                                \
        return cc::kernel_info(                                              \
            cc::update_kernel<N, 0, true, false, true, true>, out, s1, m1);  \
      case 2:                                                                \
        return cc::kernel_info(cc::dot_pass_kernel<N, 0, false, true, true>, \
                               out, s2, m2);                                 \
      case 3:                                                                \
        return cc::kernel_info(cc::dot_pass_kernel<N, 0, true, true, true>,  \
                               out, s2, m2);                                 \
      case 8:                                                                \
        return cc::kernel_info(                                              \
            cc::update_kernel<N, 0, true, true, true, true>, out, s1, m1);   \
      default:                                                               \
        return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                        \
  } while (0)
    if (n <= 4) INFO(4);
    INFO(8);
#undef INFO
  }
#define INFO(N, V)                                                          \
  do {                                                                      \
    switch (pass) {                                                         \
      case 0:                                                               \
        return cc::kernel_info(cc::sq_pass_kernel<N, 0, V>, out);           \
      case 1:                                                               \
        return cc::kernel_info(cc::update_kernel<N, 0, true, false, V>,     \
                               out);                                        \
      case 2:                                                               \
        return cc::kernel_info(cc::dot_pass_kernel<N, 0, false, V>, out);   \
      case 3:                                                               \
        return cc::kernel_info(cc::dot_pass_kernel<N, 0, true, V>, out);    \
      case 8:                                                               \
        return cc::kernel_info(cc::update_kernel<N, 0, true, true, V>,      \
                               out);                                        \
      default:                                                              \
        break;                                                              \
    }                                                                       \
  } while (0)
  CC_DISPATCH_PEERS(n, vec, INFO);
#undef INFO
  return static_cast<int>(cudaErrorInvalidValue);
}
