// Launchers of the wire-payload kernels (centered_clip.cuh): the stack is
// an (n, d) matrix of int8 or bf16 wire payloads with one f32 scale per
// (partition, peer), dequantized in registers (core.compression).
//
// Replaces these Pallas TPU kernels (src/repro/kernels/centered_clip.py):
//   * butterfly_clip_fused_dequant_pallas (compressed:butterfly_clip):
//       the passes of butterfly_clip_fused over the wire payloads;
//   * mean_digest_fused_dequant_pallas    (compressed:verified:mean):
//       mean_digest_fused's one read of the stack over the wire payloads
//       (the pass that writes the mean and sums the digests' partials
//       against it), then its finish;
//   * centered_clip_pallas over a bf16 stack (#12 at unit scales): the
//       two-phase clip's passes.
// They reuse the float32 kernels' finishing steps (centered_clip.cu), which
// read only the partial sums. A pass moves 1 (int8) or 2 (bf16) bytes per
// element of the stack instead of 4.
//
// `dtype` selects the element type: 1 = int8, 2 = bf16; anything else is
// refused with cudaErrorInvalidValue.

#include "centered_clip.cuh"

namespace {

template <int DT>
int sq_pass(const void* x, const float* scales, long long ld, long long part,
            long long d, int n, int P, long long cs, int C, int vec,
            const float* v, float* sq_part, cudaStream_t st) {
  const auto s = cc::make_stack<DT>(x, scales, ld, part, d, n);
  const long long chunks = static_cast<long long>(P) * C;
  if (vec == cc::kStaged) {
    const int rc = cc::staged_status(s, v, nullptr);
    if (rc != 0) return rc;
#define KERNEL(N) cc::sq_pass_kernel<N, DT, true, true>
    CC_LAUNCH_STAGED(1, s, v, cs, C, P, sq_part);
#undef KERNEL
  }
#define LAUNCH(N, V)                                                   \
  cc::launch_pass(cc::sq_pass_kernel<N, DT, V>, chunks, st, s, v, cs, C, \
                  P, sq_part)
  CC_DISPATCH_PEERS(n, vec, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

template <int DT>
int update(const void* x, const float* scales, long long ld, long long part,
           long long d, int n, int P, long long cs, int C, int vec,
           const float* vin, float* vout, const float* cw, const float* wsum,
           float* sq_part, float* scratch, cudaStream_t st) {
  const auto s = cc::make_stack<DT>(x, scales, ld, part, d, n);
  const long long chunks = static_cast<long long>(P) * C;
  const float* no_d2 = nullptr;
  float* no_part = nullptr;
  if (vec == cc::kStaged) {
    const int rc = cc::staged_status(s, vin, vout);
    if (rc != 0) return rc;
#define KERNEL(N) cc::update_kernel<N, DT, true, false, true, true>
    CC_LAUNCH_STAGED(1, s, vin, vout, cw, wsum, cs, C, P, sq_part,
                no_part, no_d2, 0.f, scratch);
#undef KERNEL
  }
#define LAUNCH(N, V)                                                       \
  cc::launch_pass(cc::update_kernel<N, DT, true, false, V>, chunks, st, s, \
                  vin, vout, cw, wsum, cs, C, P, sq_part, no_part, no_d2,  \
                  0.f, scratch)
  CC_DISPATCH_PEERS(n, vec, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

template <int DT>
int dot_pass(const void* x, const float* scales, long long ld,
             long long part, long long d, int n, int P, long long cs, int C,
             int vec, const float* v, const float* z, float* dot_part,
             float* sq_part, cudaStream_t st) {
  const auto s = cc::make_stack<DT>(x, scales, ld, part, d, n);
  const long long chunks = static_cast<long long>(P) * C;
  const int* all_rows = nullptr;
  if (vec == cc::kStaged) {
    const int rc = cc::staged_status(s, v, z);
    if (rc != 0) return rc;
    if (sq_part != nullptr) {
#define KERNEL(N) cc::dot_pass_kernel<N, DT, true, true, true>
      CC_LAUNCH_STAGED(2, s, v, z, cs, C, P, dot_part, sq_part, all_rows);
#undef KERNEL
    }
#define KERNEL(N) cc::dot_pass_kernel<N, DT, false, true, true>
    CC_LAUNCH_STAGED(2, s, v, z, cs, C, P, dot_part, sq_part, all_rows);
#undef KERNEL
  }
#define LAUNCH(N, V)                                                         \
  do {                                                                       \
    if (sq_part != nullptr) {                                                \
      cc::launch_pass(cc::dot_pass_kernel<N, DT, true, V>, chunks, st, s, v, \
                      z, cs, C, P, dot_part, sq_part, all_rows);             \
    } else {                                                                 \
      cc::launch_pass(cc::dot_pass_kernel<N, DT, false, V>, chunks, st, s,   \
                      v, z, cs, C, P, dot_part, sq_part, all_rows);          \
    }                                                                        \
  } while (0)
  CC_DISPATCH_PEERS(n, vec, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

template <int DT>
int mean_dot_pass(const void* x, const float* scales, long long ld,
                  long long part, long long d, int n, int P, long long cs,
                  int C, int vec, const float* w, float* v, const float* z,
                  float* dot_part, float* sq_part, cudaStream_t st) {
  return cc::mean_dot_pass(cc::make_stack<DT>(x, scales, ld, part, d, n), P,
                           cs, C, vec, w, v, z, dot_part, sq_part, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C launchers (loaded with ctypes), as in centered_clip.cu, with the
// element type and the (P, n) scales in front. `vec` 1: every (peer,
// partition) row start of the payload 4 elements aligned (4 bytes of int8,
// 8 of bf16) and the float32 vectors' 16 bytes. `vec` 2 (the norm, update
// and dot passes and verified:mean's pass, up to 8 peers): the staged
// body, every row start of the payload and the vectors 16-byte aligned; an
// ask it cannot run is refused (cudaErrorInvalidValue above 8 peers,
// cudaErrorMisalignedAddress off 16 bytes), never run another way.
// ---------------------------------------------------------------------------
#define WIRE_DISPATCH(fn, ...)                                   \
  do {                                                           \
    if (dtype == 1) return fn<1>(__VA_ARGS__);                   \
    if (dtype == 2) return fn<2>(__VA_ARGS__);                   \
    return static_cast<int>(cudaErrorInvalidValue);              \
  } while (0)

extern "C" int wire_sq_pass(int dtype, const void* x, const float* scales,
                            long long ld, long long part, long long d, int n,
                            int P, long long cs, int C, int vec,
                            const float* v, float* sq_part, void* stream) {
  WIRE_DISPATCH(sq_pass, x, scales, ld, part, d, n, P, cs, C, vec, v,
                sq_part, static_cast<cudaStream_t>(stream));
}

// One CenteredClip iteration from v_in into v_out, carrying the next
// iteration's norms into sq_part (the fused kernel's update). The adaptive
// loop's frozen-partition variant is not built for wire payloads: d2 must
// be null. `scratch` as in cc_update.
extern "C" int wire_update(int dtype, const void* x, const float* scales,
                           long long ld, long long part, long long d, int n,
                           int P, long long cs, int C, int vec,
                           const float* vin, float* vout, const float* cw,
                           const float* wsum, float* sq_part, float* d2_part,
                           const float* d2, float tol2, float* scratch,
                           void* stream) {
  (void)tol2;
  if (d2_part != nullptr || d2 != nullptr || sq_part == nullptr ||
      (n > cc::kTile && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  WIRE_DISPATCH(update, x, scales, ld, part, d, n, P, cs, C, vec, vin, vout,
                cw, wsum, sq_part, scratch,
                static_cast<cudaStream_t>(stream));
}

// One pass of the two-phase clip, as cc_clip_pass, over a bf16 stack
// (#12 at unit scales: an exact widening); other element types are
// refused.
extern "C" int wire_clip_pass(int dtype, const void* x, const float* scales,
                              long long ld, long long part, long long d,
                              int n, int P, long long cs, int C, int vec,
                              const float* vin, float* vout, const float* cw,
                              const float* wsum, float* sq_part,
                              void* stream) {
  if (dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  return cc::clip_pass(cc::make_stack<2>(x, scales, ld, part, d, n), P, cs,
                       C, vec, vin, vout, cw, wsum, sq_part,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int wire_dot_pass(int dtype, const void* x, const float* scales,
                             long long ld, long long part, long long d, int n,
                             int P, long long cs, int C, int vec,
                             const float* v, const float* z, float* dot_part,
                             float* sq_part, void* stream) {
  WIRE_DISPATCH(dot_pass, x, scales, ld, part, d, n, P, cs, C, vec, v, z,
                dot_part, sq_part, static_cast<cudaStream_t>(stream));
}

// verified:mean's one pass over the wire payloads, as cc_mean_dot_pass.
extern "C" int wire_mean_dot_pass(int dtype, const void* x,
                                  const float* scales, long long ld,
                                  long long part, long long d, int n, int P,
                                  long long cs, int C, int vec,
                                  const float* w, float* v, const float* z,
                                  float* dot_part, float* sq_part,
                                  void* stream) {
  WIRE_DISPATCH(mean_dot_pass, x, scales, ld, part, d, n, P, cs, C, vec, w,
                v, z, dot_part, sq_part, static_cast<cudaStream_t>(stream));
}

namespace {

template <int DT>
int pass_info(int pass, int n, int vec, int* out) {
  out[3] = 0;
  if (pass == 4) return cc::mean_dot_pass_info<DT>(n, vec, out);
  if (vec == cc::kStaged) {
    if (n < 1 || n > 8) return static_cast<int>(cudaErrorInvalidValue);
#define INFO(N)                                                               \
  do {                                                                        \
    const int s1 = cc::span_smem<DT>(n, 1), m1 = cc::span_smem<DT>(N, 1);     \
    const int s2 = cc::span_smem<DT>(n, 2), m2 = cc::span_smem<DT>(N, 2);     \
    switch (pass) {                                                           \
      case 0:                                                                 \
        return cc::kernel_info(cc::sq_pass_kernel<N, DT, true, true>, out, s1, \
                               m1);                                           \
      case 1:                                                                 \
        return cc::kernel_info(                                               \
            cc::update_kernel<N, DT, true, false, true, true>, out, s1, m1);  \
      case 2:                                                                 \
        return cc::kernel_info(cc::dot_pass_kernel<N, DT, false, true, true>, \
                               out, s2, m2);                                  \
      case 3:                                                                 \
        return cc::kernel_info(cc::dot_pass_kernel<N, DT, true, true, true>,  \
                               out, s2, m2);                                  \
      default:                                                                \
        return static_cast<int>(cudaErrorInvalidValue);                       \
    }                                                                         \
  } while (0)
    if (n <= 4) INFO(4);
    INFO(8);
#undef INFO
  }
#define INFO(N, V)                                                           \
  do {                                                                       \
    switch (pass) {                                                          \
      case 0:                                                                \
        return cc::kernel_info(cc::sq_pass_kernel<N, DT, V>, out);           \
      case 1:                                                                \
        return cc::kernel_info(cc::update_kernel<N, DT, true, false, V>,     \
                               out);                                         \
      case 2:                                                                \
        return cc::kernel_info(cc::dot_pass_kernel<N, DT, false, V>, out);   \
      case 3:                                                                \
        return cc::kernel_info(cc::dot_pass_kernel<N, DT, true, V>, out);    \
      default:                                                               \
        return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                        \
  } while (0)
  CC_DISPATCH_PEERS(n, vec, INFO);
#undef INFO
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// What the compiler made of a wire pass, for a report, as cc_pass_info:
// out[0] registers a thread, out[1] local (spill) bytes, out[2] resident
// CTAs per SM, out[3] dynamic shared memory a CTA. `pass`: 0 the norm
// pass, 1 the update with norms, 2 the dot pass, 3 the dot pass with
// norms, 4 verified:mean's pass; n and vec (0, 1, or 2: the staged body,
// n <= 8) pick the instantiation as a launch would.
extern "C" int wire_pass_info(int dtype, int pass, int n, int vec, int* out) {
  WIRE_DISPATCH(pass_info, pass, n, vec, out);
}
