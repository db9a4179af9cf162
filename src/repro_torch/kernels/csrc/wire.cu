// Launchers of the wire-payload kernels (centered_clip.cuh): the stack is
// an (n, d) matrix of int8 or bf16 wire payloads with one f32 scale per
// (partition, peer), dequantized in registers (core.compression).
//
// Replaces these Pallas TPU kernels (src/repro/kernels/centered_clip.py):
//   * butterfly_clip_fused_dequant_pallas (compressed:butterfly_clip):
//       the passes of butterfly_clip_fused over the wire payloads;
//   * mean_digest_fused_dequant_pallas    (compressed:verified:mean):
//       the passes of mean_digest_fused over the wire payloads.
// They reuse the float32 kernels' finishing steps (centered_clip.cu), which
// read only the partial sums. A pass moves 1 (int8) or 2 (bf16) bytes per
// element of the stack instead of 4.
//
// `dtype` selects the element type: 1 = int8, 2 = bf16; anything else is
// refused with cudaErrorInvalidValue.

#include "centered_clip.cuh"

using cc::kThreads;

namespace {

template <int DT>
int sq_pass(const void* x, const float* scales, long long ld, long long part,
            long long d, int n, int P, const float* v, long long cs, int C,
            float* sq_part, cudaStream_t st) {
  const auto s = cc::make_stack<DT>(x, scales, ld, part, d, n);
  const dim3 grid(C, P);
#define LAUNCH(N) \
  cc::sq_pass_kernel<N, DT><<<grid, kThreads, 0, st>>>(s, v, cs, sq_part)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

template <int DT>
int update(const void* x, const float* scales, long long ld, long long part,
           long long d, int n, int P, float* v, const float* cw,
           const float* wsum, long long cs, int C, float* sq_part,
           float* scratch, cudaStream_t st) {
  const auto s = cc::make_stack<DT>(x, scales, ld, part, d, n);
  const dim3 grid(C, P);
#define LAUNCH(N)                                                         \
  do {                                                                    \
    if (sq_part != nullptr) {                                             \
      cc::update_kernel<N, DT, true, false><<<grid, kThreads, 0, st>>>(   \
          s, v, cw, wsum, cs, sq_part, nullptr, nullptr, 0.f, scratch);   \
    } else {                                                              \
      cc::update_kernel<N, DT, false, false><<<grid, kThreads, 0, st>>>(  \
          s, v, cw, wsum, cs, nullptr, nullptr, nullptr, 0.f, nullptr);   \
    }                                                                     \
  } while (0)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

template <int DT>
int dot_pass(const void* x, const float* scales, long long ld,
             long long part, long long d, int n, int P, const float* v,
             const float* z, long long cs, int C, float* dot_part,
             float* sq_part, cudaStream_t st) {
  const auto s = cc::make_stack<DT>(x, scales, ld, part, d, n);
  const dim3 grid(C, P);
#define LAUNCH(N)                                                       \
  do {                                                                  \
    if (sq_part != nullptr) {                                           \
      cc::dot_pass_kernel<N, DT, true><<<grid, kThreads, 0, st>>>(      \
          s, v, z, cs, dot_part, sq_part, nullptr);                     \
    } else {                                                            \
      cc::dot_pass_kernel<N, DT, false><<<grid, kThreads, 0, st>>>(     \
          s, v, z, cs, dot_part, sq_part, nullptr);                     \
    }                                                                   \
  } while (0)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

template <int DT>
int mean_pass(const void* x, const float* scales, long long ld,
              long long part, long long d, int n, int P, const float* w,
              long long cs, int C, float* v, cudaStream_t st) {
  const auto s = cc::make_stack<DT>(x, scales, ld, part, d, n);
  const dim3 grid(C, P);
#define LAUNCH(N) \
  cc::mean_pass_kernel<N, DT><<<grid, kThreads, 0, st>>>(s, w, cs, v)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
  return cc::launch_status();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C launchers (loaded with ctypes), as in centered_clip.cu, with the
// element type and the (P, n) scales in front.
// ---------------------------------------------------------------------------
#define WIRE_DISPATCH(fn, ...)                                   \
  do {                                                           \
    if (dtype == 1) return fn<1>(__VA_ARGS__);                   \
    if (dtype == 2) return fn<2>(__VA_ARGS__);                   \
    return static_cast<int>(cudaErrorInvalidValue);              \
  } while (0)

extern "C" int wire_sq_pass(int dtype, const void* x, const float* scales,
                            long long ld, long long part, long long d, int n,
                            int P, const float* v, long long cs, int C,
                            float* sq_part, void* stream) {
  WIRE_DISPATCH(sq_pass, x, scales, ld, part, d, n, P, v, cs, C, sq_part,
                static_cast<cudaStream_t>(stream));
}

// One CenteredClip iteration, carrying the next iteration's norms when
// sq_part is given (the fused kernel's update) or not (the two-pass
// kernel's, #12 over a bf16 stack). The adaptive loop's frozen-partition
// variant is not built for wire payloads: d2 must be null. `scratch` as in
// cc_update.
extern "C" int wire_update(int dtype, const void* x, const float* scales,
                           long long ld, long long part, long long d, int n,
                           int P, float* v, const float* cw,
                           const float* wsum, long long cs, int C,
                           float* sq_part, float* d2_part, const float* d2,
                           float tol2, float* scratch, void* stream) {
  if (d2_part != nullptr || d2 != nullptr ||
      (sq_part != nullptr && n > cc::kTile && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  WIRE_DISPATCH(update, x, scales, ld, part, d, n, P, v, cw, wsum, cs, C,
                sq_part, scratch, static_cast<cudaStream_t>(stream));
}

extern "C" int wire_dot_pass(int dtype, const void* x, const float* scales,
                             long long ld, long long part, long long d, int n,
                             int P, const float* v, const float* z,
                             long long cs, int C, float* dot_part,
                             float* sq_part, void* stream) {
  WIRE_DISPATCH(dot_pass, x, scales, ld, part, d, n, P, v, z, cs, C,
                dot_part, sq_part, static_cast<cudaStream_t>(stream));
}

extern "C" int wire_mean_pass(int dtype, const void* x, const float* scales,
                              long long ld, long long part, long long d,
                              int n, int P, const float* w, long long cs,
                              int C, float* v, void* stream) {
  WIRE_DISPATCH(mean_pass, x, scales, ld, part, d, n, P, w, cs, C, v,
                static_cast<cudaStream_t>(stream));
}
