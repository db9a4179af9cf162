// CenteredClip, verification-table and digest kernels for Hopper (sm_90a):
// the kernel templates that centered_clip.cu (float32 stacks) and wire.cu
// (int8 / bf16 wire payloads) instantiate and launch.
//
// Every kernel is a pass over the same stack: peer i's partition p is the
// slice X[i, p*part : (p+1)*part] of an (n, d) matrix, read here with
// strides straight out of X (no padded, transposed copy). Flat positions
// p*part + k >= d (the ragged tail) read as zero, which is what the TPU
// path's zero padding computes. X is float32 (the gradient matrix) or a
// wire payload (int8 or bf16, one f32 scale per (partition, peer)),
// dequantized in registers as __fmul_rn(float(q), scale): a separate,
// correctly rounded multiply that nvcc may not contract into the FMA of a
// following subtract, so the value every pass sees is exactly
// core.compression.dequantize(q, scale), and a wire kernel gives the bits
// of its float32 twin run on the dequantized matrix.
//
// Bound: bytes. One pass reads n*part elements per partition and does a
// few flops per element, far below the card's ~20 flops/byte balance
// point, so every kernel streams the stack once per pass and keeps
// per-peer sums in registers. Design for that bound, kept simple:
//   * a pass runs over a (chunk, partition) grid of CTAs; each thread walks
//     its columns of the chunk and accumulates n per-peer sums in
//     registers; a fixed warp-shuffle tree and a fixed cross-warp sum then
//     give the CTA's (n,) partials, written to a (P, C, n) buffer;
//   * a small finishing kernel sums those partials over C in a fixed order
//     and turns them into clip weights, table entries or digests;
//   * the update and the weighted mean are coordinatewise once the peer
//     weights are known, so each CTA writes its own slice of v with no
//     cross-CTA traffic.
// No float atomics and no order that depends on scheduling: the same inputs
// give the same bits on every run, which the protocol's recomputed digests
// rely on. Offsets are 64-bit (n*d exceeds 2^31 at full width).
//
// Peer tiles. The per-peer sums live in MAXN-sized register arrays, MAXN
// the smallest of 4/8/16/32 that holds n. Above 32 peers the MAXN = 32
// instantiation branches to the peer-tiled passes, which walk the peers in
// tiles of 32, in index order: a reduction pass walks its chunk once per
// tile and writes that tile's slice of the same (P, C, n) partials; the
// weighted sum over peers of the update and the mean runs over all n peers
// inside the thread, in index order, with the peer weights read from
// cache. The update that also carries the next norms keeps each column's
// update in a (P, part) scratch vector between its two sweeps. The finish
// kernels take the peers 32 to a CTA along the grid's y axis. For n <= 32
// every kernel runs its untiled body.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace cc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // peers a register tile holds

// Element types of the stack: DT 0 = float32, 1 = int8, 2 = bf16 (its 16
// bits, widened exactly by a shift).
template <int DT> struct Elem;
template <> struct Elem<0> {
  using T = float;
  static __device__ __forceinline__ float f32(float v) { return v; }
};
template <> struct Elem<1> {
  using T = signed char;
  static __device__ __forceinline__ float f32(signed char v) {
    return static_cast<float>(v);
  }
};
template <> struct Elem<2> {
  using T = unsigned short;
  static __device__ __forceinline__ float f32(unsigned short v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
};

template <int DT>
struct Stack {
  const typename Elem<DT>::T* x;  // (i, p, k) at x[i * ld + p * part + k]
  const float* scales;            // (P, n) wire scales; unused for DT 0
  long long ld;                   // row stride of the (n, d) matrix
  long long part;                 // partition length
  long long d;                    // valid flat length: p*part + k >= d is 0
  int n;                          // peers
};

// Peer i's scale in partition p (1 for float32 stacks).
template <int DT>
__device__ __forceinline__ float peer_scale(const Stack<DT>& s, int i,
                                            long long p) {
  return (DT == 0 || i >= s.n) ? 1.f : s.scales[p * s.n + i];
}

template <int DT>
__device__ __forceinline__ float load_x(const Stack<DT>& s, int i,
                                        long long p, long long k, float sc) {
  const long long j = p * s.part + k;
  if (j >= s.d) return 0.f;
  const float q =
      Elem<DT>::f32(__ldg(s.x + static_cast<long long>(i) * s.ld + j));
  return DT == 0 ? q : __fmul_rn(q, sc);
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

// The reduction passes above 32 peers (see "Peer tiles"): the CTA walks
// its chunk once per tile of MAXN peers, in index order, and writes the
// tile's slice of its row of the (P, C, n) partials: <x_i - v, z> into
// dot_out (DOT) and ||x_i - v||^2 into sq_out (SQ).
template <int MAXN, int DT, bool DOT, bool SQ>
__device__ void reduce_tiled(const Stack<DT>& s, long long p, long long k0,
                             long long k1, const float* vp, const float* zp,
                             float* dot_out, float* sq_out) {
  for (int i0 = 0; i0 < s.n; i0 += MAXN) {
    const int nt = min(MAXN, s.n - i0);
    float dacc[MAXN], sacc[MAXN], sc[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      dacc[i] = sacc[i] = 0.f;
      sc[i] = peer_scale(s, i0 + i, p);
    }
    for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
      const float vk = vp[k], zk = DOT ? zp[k] : 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i < nt) {
          const float df = load_x(s, i0 + i, p, k, sc[i]) - vk;
          if (DOT) dacc[i] += df * zk;
          if (SQ) sacc[i] += df * df;
        }
      }
    }
    if (DOT) block_sums<MAXN>(dacc, nt, dot_out + i0);
    if (SQ) block_sums<MAXN>(sacc, nt, sq_out + i0);
  }
}

// Pass: per-peer partial sums of ||x_i - v||^2 over this CTA's chunk.
template <int MAXN, int DT>
__global__ void __launch_bounds__(kThreads)
sq_pass_kernel(Stack<DT> s, const float* __restrict__ v, long long cs,
               float* __restrict__ sq_part) {
  const int c = blockIdx.x, C = gridDim.x;
  const long long p = blockIdx.y;
  const long long k0 = c * cs;
  const long long k1 = min(s.part, k0 + cs);
  const float* vp = v + p * s.part;
  if (MAXN == kTile && s.n > MAXN) {
    reduce_tiled<MAXN, DT, false, true>(s, p, k0, k1, vp, nullptr, nullptr,
                                        sq_part + (p * C + c) * s.n);
    return;
  }
  float acc[MAXN], sc[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    acc[i] = 0.f;
    sc[i] = peer_scale(s, i, p);
  }
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const float vk = vp[k];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < s.n) {
        const float df = load_x(s, i, p, k, sc[i]) - vk;
        acc[i] += df * df;
      }
    }
  }
  block_sums<MAXN>(acc, s.n, sq_part + (p * C + c) * s.n);
}

// The update pass above 32 peers (see "Peer tiles"): sweep 1 forms each
// column's update over all n peers in index order; with SQ it keeps the
// update in `u` and sweep 2 walks the peer tiles for the next norms, the
// last tile writing v; without SQ sweep 1 writes v. The arithmetic is the
// untiled pass's, peer by peer.
template <int MAXN, int DT, bool SQ, bool D2>
__device__ void update_tiled(const Stack<DT>& s, long long p, int c, int C,
                             long long k0, long long k1, float* vp,
                             const float* cwp, float ws, float* sq_part,
                             float* d2_part, float* up) {
  float dacc = 0.f;
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const float vk = vp[k];
    float num = 0.f;
    for (int i = 0; i < s.n; ++i) {
      const float diff = load_x(s, i, p, k, peer_scale(s, i, p)) - vk;
      num += __ldg(cwp + i) * diff;
    }
    const float upd = num / ws;
    if (SQ) {
      up[k] = upd;
    } else {
      const float vn = vk + upd;
      vp[k] = vn;
      if (D2) {
        const float dv = vn - vk;
        dacc += dv * dv;
      }
    }
  }
  if (SQ) {
    for (int i0 = 0; i0 < s.n; i0 += MAXN) {
      const int nt = min(MAXN, s.n - i0);
      const bool last = i0 + MAXN >= s.n;
      float acc[MAXN], sc[MAXN];
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        acc[i] = 0.f;
        sc[i] = peer_scale(s, i0 + i, p);
      }
      for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
        const float vk = vp[k], upd = up[k];
#pragma unroll
        for (int i = 0; i < MAXN; ++i) {
          if (i < nt) {
            const float nd = (load_x(s, i0 + i, p, k, sc[i]) - vk) - upd;
            acc[i] += nd * nd;
          }
        }
        if (last) {
          const float vn = vk + upd;
          vp[k] = vn;
          if (D2) {
            const float dv = vn - vk;
            dacc += dv * dv;
          }
        }
      }
      block_sums<MAXN>(acc, nt, sq_part + (p * C + c) * s.n + i0);
    }
  }
  if (D2) {
    const float t = block_sum1(dacc);
    if (threadIdx.x == 0) d2_part[p * C + c] = t;
  }
}

// Pass: one CenteredClip iteration, v += sum_i cw_i (x_i - v) / wsum, in
// place. SQ: also the NEXT iteration's squared norms, sum ||diff - upd||^2
// from values already in registers (the fused kernel's incremental norms).
// D2: also ||v_new - v||^2 partials, and partitions with d2[p] <= tol2 are
// frozen (the adaptive loop's select). Above 32 peers: update_tiled, with
// the (P, part) scratch `u` when SQ.
template <int MAXN, int DT, bool SQ, bool D2>
__global__ void __launch_bounds__(kThreads)
update_kernel(Stack<DT> s, float* __restrict__ v,
              const float* __restrict__ cw, const float* __restrict__ wsum,
              long long cs, float* __restrict__ sq_part,
              float* __restrict__ d2_part, const float* __restrict__ d2,
              float tol2, float* __restrict__ u) {
  const int c = blockIdx.x, C = gridDim.x;
  const long long p = blockIdx.y;
  if (D2 && !(d2[p] > tol2)) return;  // converged partition: frozen
  const long long k0 = c * cs;
  const long long k1 = min(s.part, k0 + cs);
  float* vp = v + p * s.part;
  if (MAXN == kTile && s.n > MAXN) {
    update_tiled<MAXN, DT, SQ, D2>(s, p, c, C, k0, k1, vp, cw + p * s.n,
                                   *wsum, sq_part, d2_part,
                                   SQ ? u + p * s.part : nullptr);
    return;
  }
  float w[MAXN], acc[MAXN], sc[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    w[i] = i < s.n ? cw[p * s.n + i] : 0.f;
    acc[i] = 0.f;
    sc[i] = peer_scale(s, i, p);
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
        diff[i] = load_x(s, i, p, k, sc[i]) - vk;
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
// CTA (c, j) reads partition p = j, or p = rows[j] when `rows` is given
// (the sampled-digest pass: only the k sampled partitions are read), and
// writes row j of the partials. The body is the same either way, so row
// j of a sampled pass has the bits of row rows[j] of the full pass.
template <int MAXN, int DT, bool SQ>
__global__ void __launch_bounds__(kThreads)
dot_pass_kernel(Stack<DT> s, const float* __restrict__ v,
                const float* __restrict__ z, long long cs,
                float* __restrict__ dot_part, float* __restrict__ sq_part,
                const int* __restrict__ rows) {
  const int c = blockIdx.x, C = gridDim.x;
  const long long j = blockIdx.y;
  const long long p = rows == nullptr ? j : static_cast<long long>(rows[j]);
  const long long k0 = c * cs;
  const long long k1 = min(s.part, k0 + cs);
  const float* vp = v + p * s.part;
  const float* zp = z + p * s.part;
  if (MAXN == kTile && s.n > MAXN) {
    reduce_tiled<MAXN, DT, true, SQ>(
        s, p, k0, k1, vp, zp, dot_part + (j * C + c) * s.n,
        SQ ? sq_part + (j * C + c) * s.n : nullptr);
    return;
  }
  float dacc[MAXN], sacc[MAXN], sc[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    dacc[i] = sacc[i] = 0.f;
    sc[i] = peer_scale(s, i, p);
  }
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const float vk = vp[k], zk = zp[k];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < s.n) {
        const float df = load_x(s, i, p, k, sc[i]) - vk;
        dacc[i] += df * zk;
        if (SQ) sacc[i] += df * df;
      }
    }
  }
  block_sums<MAXN>(dacc, s.n, dot_part + (j * C + c) * s.n);
  if (SQ) block_sums<MAXN>(sacc, s.n, sq_part + (j * C + c) * s.n);
}

// Pass: the weighted per-partition mean, v[p, k] = sum_i w_i x_i[k] /
// max(sum_i w_i, 1e-30), peers summed in index order. Coordinatewise, so
// each CTA writes its own slice of v and nothing crosses CTAs. Above 32
// peers the weights and scales are read from cache instead of registers.
template <int MAXN, int DT>
__global__ void __launch_bounds__(kThreads)
mean_pass_kernel(Stack<DT> s, const float* __restrict__ w, long long cs,
                 float* __restrict__ v) {
  const long long p = blockIdx.y;
  const long long k0 = blockIdx.x * cs;
  const long long k1 = min(s.part, k0 + cs);
  if (MAXN == kTile && s.n > MAXN) {
    float wt = 0.f;
    for (int i = 0; i < s.n; ++i) wt += w[i];
    const float ws = fmaxf(wt, 1e-30f);
    float* vp = v + p * s.part;
    for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
      float num = 0.f;
      for (int i = 0; i < s.n; ++i)
        num += __ldg(w + i) * load_x(s, i, p, k, peer_scale(s, i, p));
      vp[k] = num / ws;
    }
    return;
  }
  float wr[MAXN], sc[MAXN];
  float wt = 0.f;
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    wr[i] = i < s.n ? w[i] : 0.f;
    sc[i] = peer_scale(s, i, p);
  }
  for (int i = 0; i < s.n; ++i) wt += w[i];
  const float ws = fmaxf(wt, 1e-30f);
  float* vp = v + p * s.part;
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    float num = 0.f;
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < s.n) num += wr[i] * load_x(s, i, p, k, sc[i]);
    }
    vp[k] = num / ws;
  }
}

// Finish: one CTA per partition and 32 peers (grid (P, ceil(n / 32)), 32
// threads). sq[p, i] = sum over C of the partials, cw[p, i] =
// clip_weight(sq, tau) * w[i]; wsum = max(sum_i w_i, 1e-30).
// With d2/d2_part (adaptive step): only partitions with d2[p] > tol2 are
// touched, d2[p] takes this step's ||dv||^2 and iters[p] counts the step.
__global__ void finish_weights_kernel(
    const float* __restrict__ sq_part, int C, int n,
    const float* __restrict__ w, float tau, float* __restrict__ sq_out,
    float* __restrict__ cw_out, float* __restrict__ wsum_out,
    const float* __restrict__ d2_part, float* __restrict__ d2,
    int* __restrict__ iters, float tol2) {
  const int p = blockIdx.x, i = blockIdx.y * blockDim.x + threadIdx.x;
  __shared__ int active;
  if (threadIdx.x == 0) active = d2 == nullptr || d2[p] > tol2;
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

// Finish the tables: one CTA per partition and 32 peers, as above. dot
// from partials, sq from partials (sq_part) or a carried buffer (sq_in).
// CLIP (the Alg. 6 tables of butterfly_clip): s = min(1, tau / ||x - v||)
// * dot, tau = inf -> dot. Without CLIP (the verified:* digests, which
// carry no tau): s = dot. norm = ||x - v|| either way.
template <bool CLIP>
__global__ void finish_tables_kernel(
    const float* __restrict__ dot_part, const float* __restrict__ sq_part,
    const float* __restrict__ sq_in, int C, int n, float tau,
    float* __restrict__ s_out, float* __restrict__ norm_out) {
  const int p = blockIdx.x, i = blockIdx.y * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float dot = 0.f, sq = 0.f;
  for (int c = 0; c < C; ++c) dot += dot_part[(p * C + c) * n + i];
  if (sq_part != nullptr) {
    for (int c = 0; c < C; ++c) sq += sq_part[(p * C + c) * n + i];
  } else {
    sq = sq_in[p * n + i];
  }
  const float nrm = sqrtf(fmaxf(sq, 0.f));
  if (CLIP) {
    const float cwv = isinf(tau) ? 1.f : fminf(1.f, tau / fmaxf(nrm, 1e-30f));
    s_out[p * n + i] = cwv * dot;
  } else {
    s_out[p * n + i] = dot;
  }
  norm_out[p * n + i] = nrm;
}

// The finish kernels' grid: a CTA per partition (or sampled row) and per
// 32 peers.
inline dim3 finish_grid(int rows, int n) { return dim3(rows, (n + 31) / 32); }

template <int DT>
Stack<DT> make_stack(const void* x, const float* scales, long long ld,
                     long long part, long long d, int n) {
  Stack<DT> s;
  s.x = static_cast<const typename Elem<DT>::T*>(x);
  s.scales = scales;
  s.ld = ld;
  s.part = part;
  s.d = d;
  s.n = n;
  return s;
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace cc

// Instantiate LAUNCH(MAXN) for the smallest register budget that holds n
// peers; above 32 peers the kTile instantiation walks them in tiles.
#define CC_DISPATCH_PEERS(n, LAUNCH) \
  do {                               \
    if ((n) <= 4) {                  \
      LAUNCH(4);                     \
    } else if ((n) <= 8) {           \
      LAUNCH(8);                     \
    } else if ((n) <= 16) {          \
      LAUNCH(16);                    \
    } else {                         \
      LAUNCH(cc::kTile);             \
    }                                \
  } while (0)
