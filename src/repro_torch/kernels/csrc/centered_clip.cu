// CenteredClip and verification-table kernels for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels that the flagship butterfly_clip
// aggregator reaches (src/repro/kernels/centered_clip.py):
//   * butterfly_clip_fused_pallas   (fixed budget + Alg. 6 tables),
//   * verify_tables_batched_pallas  (tables against a given aggregate),
//   * adaptive_clip_step_pallas     (one early-exit iteration),
//   * butterfly_clip_pallas         (two-phase CenteredClip, no tables).
// Each is a per-peer reduction over the same stack: peer i's partition p is
// the slice G[i, p*part : (p+1)*part] of the (n, d) gradient matrix, read
// here with strides straight out of G (no padded, transposed copy). Flat
// positions p*part + k >= d (the ragged tail) read as zero, which is what
// the TPU path's zero padding computes.
//
// Bound: bytes. One pass reads n*d*4 bytes of G and does ~3 flops per
// element, far below the card's ~20 flops/byte balance point, so every
// kernel streams the stack once per pass and keeps per-peer sums in
// registers. Design for that bound, kept simple in this first version:
//   * a pass runs over a (chunk, partition) grid of CTAs; each thread walks
//     its columns of the chunk and accumulates n per-peer sums in
//     registers, a fixed warp-shuffle tree and a fixed cross-warp sum then
//     give the CTA's (n,) partials, written to a (P, C, n) buffer;
//   * a small finishing kernel sums those partials over C in a fixed order
//     and turns them into clip weights or table entries;
//   * the update is coordinatewise given the clip weights, so each CTA
//     updates its own slice of v with no cross-CTA traffic.
// No float atomics and no order that depends on scheduling: the same inputs
// give the same bits on every run, which the protocol's recomputed digests
// rely on. Offsets are 64-bit (n*d exceeds 2^31 at full width).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPeers = 32;

struct Stack {
  const float* x;  // element (i, p, k) at x[i * ld + p * part + k]
  long long ld;    // row stride of the (n, d) gradient matrix
  long long part;  // partition length
  long long d;     // valid flat length: p * part + k >= d reads as 0
  int n;           // peers
};

__device__ __forceinline__ float load_x(const Stack& s, int i, long long p,
                                        long long k) {
  const long long j = p * s.part + k;
  return j < s.d ? __ldg(s.x + static_cast<long long>(i) * s.ld + j) : 0.f;
}

// Sum `acc[i]` (i < n) over the CTA in a fixed order; thread i < n writes
// the total to out[i]. All threads must call it.
template <int MAXN>
__device__ void block_sums(const float (&acc)[MAXN], int n, float* out) {
  __shared__ float sm[kWarps][MAXN];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    if (i < n) {
      float v = acc[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) sm[warp][i] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < n) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += sm[w][threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

__device__ __forceinline__ float block_sum1(float v) {
  __shared__ float sm[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += sm[w];
  __syncthreads();
  return t;
}

// min(1, tau / ||.||) from a squared norm, safe at 0; tau = inf -> 1
// (kernels/centered_clip.py:322-326 of the JAX package).
__device__ __forceinline__ float clip_weight(float sq, float tau) {
  if (isinf(tau)) return 1.f;
  const float nrm = sqrtf(fmaxf(sq, 1e-30f));
  return fminf(1.f, tau / fmaxf(nrm, 1e-30f));
}

// Pass: per-peer partial sums of ||x_i - v||^2 over this CTA's chunk.
template <int MAXN>
__global__ void __launch_bounds__(kThreads)
sq_pass_kernel(Stack s, const float* __restrict__ v, long long cs,
               float* __restrict__ sq_part) {
  const int c = blockIdx.x, C = gridDim.x;
  const long long p = blockIdx.y;
  const long long k0 = c * cs;
  const long long k1 = min(s.part, k0 + cs);
  const float* vp = v + p * s.part;
  float acc[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) acc[i] = 0.f;
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const float vk = vp[k];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < s.n) {
        const float df = load_x(s, i, p, k) - vk;
        acc[i] += df * df;
      }
    }
  }
  block_sums<MAXN>(acc, s.n, sq_part + (p * C + c) * s.n);
}

// Pass: one CenteredClip iteration, v += sum_i cw_i (x_i - v) / wsum, in
// place. SQ: also the NEXT iteration's squared norms, sum ||diff - upd||^2
// from values already in registers (the fused kernel's incremental norms).
// D2: also ||v_new - v||^2 partials, and partitions with d2[p] <= tol2 are
// frozen (the adaptive loop's select).
template <int MAXN, bool SQ, bool D2>
__global__ void __launch_bounds__(kThreads)
update_kernel(Stack s, float* __restrict__ v, const float* __restrict__ cw,
              const float* __restrict__ wsum, long long cs,
              float* __restrict__ sq_part, float* __restrict__ d2_part,
              const float* __restrict__ d2, float tol2) {
  const int c = blockIdx.x, C = gridDim.x;
  const long long p = blockIdx.y;
  if (D2 && !(d2[p] > tol2)) return;  // converged partition: frozen
  const long long k0 = c * cs;
  const long long k1 = min(s.part, k0 + cs);
  float* vp = v + p * s.part;
  float w[MAXN], acc[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    w[i] = i < s.n ? cw[p * s.n + i] : 0.f;
    acc[i] = 0.f;
  }
  const float ws = *wsum;
  float dacc = 0.f;
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const float vk = vp[k];
    float diff[MAXN];
    float num = 0.f;
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < s.n) {
        diff[i] = load_x(s, i, p, k) - vk;
        num += w[i] * diff[i];
      }
    }
    const float upd = num / ws;
    const float vn = vk + upd;
    vp[k] = vn;
    if (SQ) {
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i < s.n) {
          const float nd = diff[i] - upd;
          acc[i] += nd * nd;
        }
      }
    }
    if (D2) {
      const float dv = vn - vk;
      dacc += dv * dv;
    }
  }
  if (SQ) block_sums<MAXN>(acc, s.n, sq_part + (p * C + c) * s.n);
  if (D2) {
    const float t = block_sum1(dacc);
    if (threadIdx.x == 0) d2_part[p * C + c] = t;
  }
}

// Pass: per-peer partials of <x_i - v, z> and, with SQ, ||x_i - v||^2.
template <int MAXN, bool SQ>
__global__ void __launch_bounds__(kThreads)
dot_pass_kernel(Stack s, const float* __restrict__ v,
                const float* __restrict__ z, long long cs,
                float* __restrict__ dot_part, float* __restrict__ sq_part) {
  const int c = blockIdx.x, C = gridDim.x;
  const long long p = blockIdx.y;
  const long long k0 = c * cs;
  const long long k1 = min(s.part, k0 + cs);
  const float* vp = v + p * s.part;
  const float* zp = z + p * s.part;
  float dacc[MAXN], sacc[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) dacc[i] = sacc[i] = 0.f;
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const float vk = vp[k], zk = zp[k];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < s.n) {
        const float df = load_x(s, i, p, k) - vk;
        dacc[i] += df * zk;
        if (SQ) sacc[i] += df * df;
      }
    }
  }
  block_sums<MAXN>(dacc, s.n, dot_part + (p * C + c) * s.n);
  if (SQ) block_sums<MAXN>(sacc, s.n, sq_part + (p * C + c) * s.n);
}

// Finish: one CTA per partition. sq[p, i] = sum over C of the partials,
// cw[p, i] = clip_weight(sq, tau) * w[i]; wsum = max(sum_i w_i, 1e-30).
// With d2/d2_part (adaptive step): only partitions with d2[p] > tol2 are
// touched, d2[p] takes this step's ||dv||^2 and iters[p] counts the step.
__global__ void finish_weights_kernel(
    const float* __restrict__ sq_part, int C, int n,
    const float* __restrict__ w, float tau, float* __restrict__ sq_out,
    float* __restrict__ cw_out, float* __restrict__ wsum_out,
    const float* __restrict__ d2_part, float* __restrict__ d2,
    int* __restrict__ iters, float tol2) {
  const int p = blockIdx.x, i = threadIdx.x;
  __shared__ int active;
  if (i == 0) active = d2 == nullptr || d2[p] > tol2;
  __syncthreads();
  if (active && i < n) {
    float sq = 0.f;
    for (int c = 0; c < C; ++c) sq += sq_part[(p * C + c) * n + i];
    sq_out[p * n + i] = sq;
    cw_out[p * n + i] = clip_weight(sq, tau) * w[i];
  }
  if (i == 0 && active && d2 != nullptr) {
    float t = 0.f;
    for (int c = 0; c < C; ++c) t += d2_part[p * C + c];
    d2[p] = t;
    iters[p] += 1;
  }
  if (p == 0 && i == 0 && wsum_out != nullptr) {
    float t = 0.f;
    for (int j = 0; j < n; ++j) t += w[j];
    *wsum_out = fmaxf(t, 1e-30f);
  }
}

// Finish the Alg. 6 tables: one CTA per partition. dot from partials, sq
// from partials (sq_part) or a carried buffer (sq_in);
// s = min(1, tau / ||x - v||) * dot (tau = inf -> dot), norm = ||x - v||.
__global__ void finish_tables_kernel(
    const float* __restrict__ dot_part, const float* __restrict__ sq_part,
    const float* __restrict__ sq_in, int C, int n, float tau,
    float* __restrict__ s_out, float* __restrict__ norm_out) {
  const int p = blockIdx.x, i = threadIdx.x;
  if (i >= n) return;
  float dot = 0.f, sq = 0.f;
  for (int c = 0; c < C; ++c) dot += dot_part[(p * C + c) * n + i];
  if (sq_part != nullptr) {
    for (int c = 0; c < C; ++c) sq += sq_part[(p * C + c) * n + i];
  } else {
    sq = sq_in[p * n + i];
  }
  const float nrm = sqrtf(fmaxf(sq, 0.f));
  const float cwv = isinf(tau) ? 1.f : fminf(1.f, tau / fmaxf(nrm, 1e-30f));
  s_out[p * n + i] = cwv * dot;
  norm_out[p * n + i] = nrm;
}

Stack make_stack(const float* x, long long ld, long long part, long long d,
                 int n) {
  Stack s;
  s.x = x;
  s.ld = ld;
  s.part = part;
  s.d = d;
  s.n = n;
  return s;
}

int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// ---------------------------------------------------------------------------
// Plain C launchers (loaded with ctypes). Each enqueues on `stream`, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 = ok).
// Peer counts above 32 are refused with cudaErrorInvalidValue.
// ---------------------------------------------------------------------------
#define CC_DISPATCH_PEERS(n, LAUNCH)                   \
  do {                                                 \
    if ((n) <= 4) {                                    \
      LAUNCH(4);                                       \
    } else if ((n) <= 8) {                             \
      LAUNCH(8);                                       \
    } else if ((n) <= 16) {                            \
      LAUNCH(16);                                      \
    } else if ((n) <= kMaxPeers) {                     \
      LAUNCH(32);                                      \
    } else {                                           \
      return static_cast<int>(cudaErrorInvalidValue);  \
    }                                                  \
  } while (0)

extern "C" int cc_sq_pass(const float* x, long long ld, long long part,
                          long long d, int n, int P, const float* v,
                          long long cs, int C, float* sq_part, void* stream) {
  const Stack s = make_stack(x, ld, part, d, n);
  const dim3 grid(C, P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(N) \
  sq_pass_kernel<N><<<grid, kThreads, 0, st>>>(s, v, cs, sq_part)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
  return launch_status();
}

extern "C" int cc_update(const float* x, long long ld, long long part,
                         long long d, int n, int P, float* v, const float* cw,
                         const float* wsum, long long cs, int C,
                         float* sq_part, float* d2_part, const float* d2,
                         float tol2, void* stream) {
  const Stack s = make_stack(x, ld, part, d, n);
  const dim3 grid(C, P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool with_sq = sq_part != nullptr, with_d2 = d2 != nullptr;
#define LAUNCH_SD(N, SQ, D2)                                         \
  update_kernel<N, SQ, D2><<<grid, kThreads, 0, st>>>(              \
      s, v, cw, wsum, cs, sq_part, d2_part, d2, tol2)
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
  return launch_status();
}

extern "C" int cc_dot_pass(const float* x, long long ld, long long part,
                           long long d, int n, int P, const float* v,
                           const float* z, long long cs, int C,
                           float* dot_part, float* sq_part, void* stream) {
  const Stack s = make_stack(x, ld, part, d, n);
  const dim3 grid(C, P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAUNCH(N)                                                       \
  do {                                                                  \
    if (sq_part != nullptr) {                                           \
      dot_pass_kernel<N, true><<<grid, kThreads, 0, st>>>(              \
          s, v, z, cs, dot_part, sq_part);                              \
    } else {                                                            \
      dot_pass_kernel<N, false><<<grid, kThreads, 0, st>>>(             \
          s, v, z, cs, dot_part, sq_part);                              \
    }                                                                   \
  } while (0)
  CC_DISPATCH_PEERS(n, LAUNCH);
#undef LAUNCH
  return launch_status();
}

extern "C" int cc_finish_weights(const float* sq_part, int P, int C, int n,
                                 const float* w, float tau, float* sq_out,
                                 float* cw_out, float* wsum_out,
                                 const float* d2_part, float* d2, int* iters,
                                 float tol2, void* stream) {
  if (n > kMaxPeers) return static_cast<int>(cudaErrorInvalidValue);
  finish_weights_kernel<<<P, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      sq_part, C, n, w, tau, sq_out, cw_out, wsum_out, d2_part, d2, iters,
      tol2);
  return launch_status();
}

extern "C" int cc_finish_tables(const float* dot_part, const float* sq_part,
                                const float* sq_in, int P, int C, int n,
                                float tau, float* s_out, float* norm_out,
                                void* stream) {
  if (n > kMaxPeers) return static_cast<int>(cudaErrorInvalidValue);
  finish_tables_kernel<<<P, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      dot_part, sq_part, sq_in, C, n, tau, s_out, norm_out);
  return launch_status();
}
