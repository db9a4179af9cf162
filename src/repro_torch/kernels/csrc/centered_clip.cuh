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
// correctly rounded multiply, so the value every pass sees is exactly
// core.compression.dequantize(q, scale), and a wire kernel gives the bits
// of its float32 twin run on the dequantized matrix. Every multiply-add is
// spelled with the _rn intrinsics (__fsub_rn, __fmaf_rn, ...), so no
// choice of the compiler's contraction can differ between two bodies.
//
// Bound: bytes. One pass reads n*part elements per partition and does a
// few flops per element, far below the card's ~20 flops/byte balance
// point, so every kernel streams the stack once per pass and keeps
// per-peer sums in registers. The design for that bound:
//   * a logical chunk grid, fixed by (n, d, P) alone: each partition is cut
//     into C chunks of cs columns (a constant, kernels/centered_clip.py
//     CHUNK), and each chunk gives one row of (P, n, C) partial sums;
//   * a persistent grid of CTAs, as many as the card holds at once (its SM
//     count times the kernel's resident CTAs per SM), walks the logical
//     chunks q = blockIdx.x, blockIdx.x + gridDim.x, ... The chunk a CTA
//     takes changes nothing in how the chunk is summed, so the bits depend
//     on (n, d, P) and the constant, never on the card;
//   * inside a chunk each thread owns groups of G consecutive columns
//     (G = 4 up to 8 peers, 1 above; 4 up to 32 peers in the two-phase
//     clip, "The two-phase clip" below), group t, t + 256, ... of the chunk,
//     and sums them column by column in index order into n per-peer sums;
//     a fixed warp-shuffle tree and a fixed cross-warp sum give the chunk's
//     (n,) partials. A group of 4 is one 16-byte load of float32 (8 bytes
//     of bf16, 4 of int8) per peer where every (peer, partition) row start
//     is aligned (VEC), and otherwise the same 4 columns loaded one by one
//     in the same order: one stack gives the same bits at any storage
//     offset or row stride; where every row start is 16-byte aligned, the
//     two-phase clip, the norm, update and dot passes and verified:mean's
//     pass first copy their rows into shared memory ("The staged body
//     ..."), summed in the same order;
//   * a finishing kernel, one CTA per (partition, peer), sums the peer's C
//     partials in a fixed tree (thread t takes partials t, t + 256, ... in
//     turn, then the CTA's shuffle tree) and turns them into clip weights,
//     table entries or digests;
//   * the update and the weighted mean are coordinatewise once the peer
//     weights are known, so each chunk writes its own slice of v with no
//     cross-CTA traffic.
// No float atomics and no order that depends on scheduling or on the card:
// the same inputs give the same bits on every run and every card, which the
// protocol's recomputed digests rely on. Offsets are 64-bit (n*d exceeds
// 2^31 at full width).
//
// Peer tiles. The per-peer sums live in MAXN-sized register arrays, MAXN
// the smallest of 4/8/16/32 that holds n. Above 32 peers the MAXN = 32
// instantiation branches to the peer-tiled passes, which walk the peers in
// tiles of 32, in index order: a reduction pass walks its chunk once per
// tile and writes that tile's slice of the same (P, n, C) partials; the
// weighted sum over peers of the update and the mean runs over all n peers
// inside the thread, in index order, with the peer weights read from
// cache. The update that also carries the next norms keeps each column's
// update in a (P, part) scratch vector between its two sweeps. For n <= 32
// every kernel runs its untiled body.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

// The two-phase clip's instantiations up to 32 peers: every register budget
// with and without the staged body (every row start 16-byte aligned).
#define CC_DISPATCH_CLIP(n, vec, LAUNCH) \
  do {                                   \
    if ((n) <= 4) {                      \
      if (vec) {                         \
        LAUNCH(4, true);                 \
      } else {                           \
        LAUNCH(4, false);                \
      }                                  \
    } else if ((n) <= 8) {               \
      if (vec) {                         \
        LAUNCH(8, true);                 \
      } else {                           \
        LAUNCH(8, false);                \
      }                                  \
    } else if ((n) <= 16) {              \
      if (vec) {                         \
        LAUNCH(16, true);                \
      } else {                           \
        LAUNCH(16, false);               \
      }                                  \
    } else {                             \
      if (vec) {                         \
        LAUNCH(cc::kTile, true);         \
      } else {                           \
        LAUNCH(cc::kTile, false);        \
      }                                  \
    }                                    \
  } while (0)

namespace cc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // peers a register tile holds

// Columns of a group: 4 where the per-peer register arrays leave room (up
// to 8 peers), 1 above. The host's chunk length is a multiple of 4.
template <int MAXN>
__host__ __device__ constexpr int group_cols() {
  return MAXN <= 8 ? 4 : 1;
}

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

// Four consecutive elements of the stack in one load (16, 4 or 8 bytes).
template <int DT> struct Load4;
template <> struct Load4<0> {
  static __device__ __forceinline__ void get(const float* p, float (&o)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
  }
};
template <> struct Load4<1> {
  static __device__ __forceinline__ void get(const signed char* p,
                                             float (&o)[4]) {
    const char4 q = __ldg(reinterpret_cast<const char4*>(p));
    o[0] = Elem<1>::f32(q.x), o[1] = Elem<1>::f32(q.y);
    o[2] = Elem<1>::f32(q.z), o[3] = Elem<1>::f32(q.w);
  }
};
template <> struct Load4<2> {
  static __device__ __forceinline__ void get(const unsigned short* p,
                                             float (&o)[4]) {
    const ushort4 q = __ldg(reinterpret_cast<const ushort4*>(p));
    o[0] = Elem<2>::f32(q.x), o[1] = Elem<2>::f32(q.y);
    o[2] = Elem<2>::f32(q.z), o[3] = Elem<2>::f32(q.w);
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

// One element (the peer-tiled bodies): x_i at column k of partition p.
template <int DT>
__device__ __forceinline__ float load_x1(const Stack<DT>& s, int i,
                                         long long p, long long k, float sc) {
  const long long j = p * s.part + k;
  if (j >= s.d) return 0.f;
  const float q =
      Elem<DT>::f32(__ldg(s.x + static_cast<long long>(i) * s.ld + j));
  return DT == 0 ? q : __fmul_rn(q, sc);
}

// A group: the columns k .. k + G - 1 of a chunk that ends at k1. nv of
// them lie in the chunk (the rest are past the partition's end and take no
// part); nx of those lie before d (the rest read as zero).
struct Group {
  int nv, nx;
};

template <int G, bool VEC, int DT>
__device__ __forceinline__ Group group_at(const Stack<DT>& s, long long p,
                                          long long k, long long k1) {
  // VEC: part and cs are multiples of 4, so no group crosses k1
  const int nv = VEC ? G : static_cast<int>(min(static_cast<long long>(G),
                                                k1 - k));
  const long long left = s.d - (p * s.part + k);
  const int nx = static_cast<int>(
      max(0LL, min(static_cast<long long>(nv), left)));
  return {nv, nx};
}

// Peer i's values in the group (dequantized). VEC: one load when all G lie
// before d; otherwise (and always without VEC) one load per column, the
// same values in the same order.
template <int G, bool VEC, int DT>
__device__ __forceinline__ void load_x(const Stack<DT>& s, int i, long long p,
                                       long long k, Group g, float sc,
                                       float (&o)[G]) {
  const auto* row = s.x + static_cast<long long>(i) * s.ld + p * s.part + k;
  if constexpr (VEC) {
    static_assert(G == 4, "16-byte loads take groups of 4");
    if (g.nx == G) {
      Load4<DT>::get(row, o);
      if (DT != 0) {
#pragma unroll
        for (int e = 0; e < G; ++e) o[e] = __fmul_rn(o[e], sc);
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < G; ++e) {
    o[e] = 0.f;
    if (e < g.nx) {
      const float q = Elem<DT>::f32(__ldg(row + e));
      o[e] = DT == 0 ? q : __fmul_rn(q, sc);
    }
  }
}

// The group's columns of a float32 vector row (v, z): zeros past the chunk
// or for a null vector (a cold start, v = 0, read from nothing).
template <int G, bool VEC>
__device__ __forceinline__ void load_f(const float* row, long long k, Group g,
                                       float (&o)[G]) {
  if (row == nullptr) {
#pragma unroll
    for (int e = 0; e < G; ++e) o[e] = 0.f;
    return;
  }
  if constexpr (VEC) {
    const float4 q = *reinterpret_cast<const float4*>(row + k);
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < G; ++e) o[e] = e < g.nv ? row[k + e] : 0.f;
}

template <int G, bool VEC>
__device__ __forceinline__ void store_f(float* row, long long k, Group g,
                                        const float (&o)[G]) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(row + k) = make_float4(o[0], o[1], o[2], o[3]);
    return;
  }
#pragma unroll
  for (int e = 0; e < G; ++e) {
    if (e < g.nv) row[k + e] = o[e];
  }
}

// Sum `acc[i]` (i < n) over the CTA in a fixed order; thread i < n writes
// the total to out[i * stride]. All threads must call it.
template <int MAXN>
__device__ void block_sums(const float (&acc)[MAXN], int n, float* out,
                           long long stride) {
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
    out[threadIdx.x * stride] = t;
  }
  __syncthreads();
}

// The CTA's total of v, to every thread, in a fixed order.
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

// x[0] + ... + x[C - 1] in a fixed tree: thread t sums x[t], x[t + 256],
// ... in turn, then block_sum1. All threads must call it; all get the sum.
__device__ __forceinline__ float fixed_sum(const float* __restrict__ x,
                                           int C) {
  float t = 0.f;
#pragma unroll 4
  for (int c = threadIdx.x; c < C; c += kThreads) t += __ldg(x + c);
  return block_sum1(t);
}

// min(1, tau / ||.||) from a squared norm, safe at 0; tau = inf -> 1
// (kernels/centered_clip.py:322-326 of the JAX package).
__device__ __forceinline__ float clip_weight(float sq, float tau) {
  if (isinf(tau)) return 1.f;
  const float nrm = sqrtf(fmaxf(sq, 1e-30f));
  return fminf(1.f, tau / fmaxf(nrm, 1e-30f));
}

// The logical chunk q of a rows x C grid: row r, columns [k0, k1).
struct Chunk {
  long long r, k0, k1;
  int c;
};

__device__ __forceinline__ Chunk chunk_at(long long q, int C, long long cs,
                                          long long part) {
  Chunk ch;
  ch.r = q / C;
  ch.c = static_cast<int>(q - ch.r * C);
  ch.k0 = ch.c * cs;
  ch.k1 = min(part, ch.k0 + cs);
  return ch;
}

// ---------------------------------------------------------------------------
// Bulk copies into shared memory (the staged bodies of the two-phase clip
// and of the wire passes): one thread asks the Tensor Memory Accelerator
// for a 1-D copy (cp.async.bulk) that completes on an mbarrier.
// ---------------------------------------------------------------------------
constexpr int kSubCols = kThreads * 4;  // columns of a staged sub-tile
// the dynamic shared memory a CTA may take (227 KB less the static arrays)
constexpr int kStageBudget = 232448 - 2048;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Four consecutive elements of a staged row segment (shared memory),
// dequantized as load_x does.
template <int DT>
__device__ __forceinline__ void tile_x(const typename Elem<DT>::T* p,
                                       float sc, float (&o)[4]) {
  if constexpr (DT == 0) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
  } else {
    using V4 = typename std::conditional<DT == 1, char4, ushort4>::type;
    const V4 q = *reinterpret_cast<const V4*>(p);
    o[0] = __fmul_rn(Elem<DT>::f32(q.x), sc);
    o[1] = __fmul_rn(Elem<DT>::f32(q.y), sc);
    o[2] = __fmul_rn(Elem<DT>::f32(q.z), sc);
    o[3] = __fmul_rn(Elem<DT>::f32(q.w), sc);
  }
}

// ---------------------------------------------------------------------------
// The staged body of the norm, update and dot passes over float32, int8
// and bf16 stacks, up to 8 peers where every row start is 16-byte aligned
// (and of verified:mean's pass, "verified:mean" below); and of the
// two-phase clip's passes up to 32 peers (#4, #12, "The two-phase clip"
// below).
//
// A group of 4 columns is 4 bytes of int8 (8 of bf16) a peer, so a thread
// of the global body keeps a quarter (a half) of its float32 twin's bytes
// of stack in flight, and the wire passes stream well below the twin's
// rate; the float32 step that also sums ||dv||^2 sits at its 64-register
// budget and streams below #1's update (PERF.md). The staged body keeps
// the global body's order -- thread t sums the groups at columns k0 + 4t
// + 1024 j of its chunk, j = 0, 1, ..., in turn, into the same block_sums
// tree, so every bit is the global body's -- but one thread first copies a
// span of kSpanBytes bytes of each peer's row (4 sub-tiles of 1024 columns
// of int8, 2 of bf16, 1 of float32) and the same columns of the float32
// vectors the pass reads (v; z in the dot pass) into shared memory with
// cp.async.bulk, completing on an mbarrier, and every thread then reads its
// groups from there. A CTA holds one stage (4 peers: 32 KiB of int8 in the
// update, 48 KiB in the dot pass, 20 KiB of float32) and the copies of one
// CTA overlap the arithmetic of the others resident on its SM; on an H100
// (PERF.md) spans of 2 sub-tiles of int8 and 5 CTAs an SM in the update
// read no faster. A span's copy of the stack is cut at d to whole 16
// bytes; the groups past the cut load from global memory (load_x), the
// same values. Above 8 peers (groups of one column) the norm, update and
// dot passes keep the global body.
// ---------------------------------------------------------------------------
constexpr int kSpanBytes = 4096;  // bytes of a peer's row in a stage

// Columns of a staged span: a whole number of sub-tiles.
template <int DT>
__host__ __device__ constexpr int span_cols() {
  return kSpanBytes / static_cast<int>(sizeof(typename Elem<DT>::T));
}

// Dynamic shared memory of a staged pass over n peers that stages nf
// float32 vectors: their span segments, the n stack rows, the mbarrier.
template <int DT>
__host__ __device__ constexpr int span_smem(int n, int nf) {
  return span_cols<DT>() *
             (4 * nf + n * static_cast<int>(sizeof(typename Elem<DT>::T))) +
         8;
}
static_assert(span_smem<1>(8, 2) <= kStageBudget &&
                  span_smem<2>(8, 2) <= kStageBudget &&
                  span_smem<0>(8, 2) <= kStageBudget,
              "an 8-peer stage fits a CTA");

// Where a group's values come from in the staged body: x, the thread's
// column in the stage's row of peer 0 (the rows a span apart; null where
// the group lies past the copied bytes), and the same column of v's and
// z's segments (null where the pass reads none). The global body's groups
// take all three null and load from global memory.
template <int DT>
struct Src {
  const typename Elem<DT>::T* x;
  const float* v;
  const float* z;
};

// Peer i's values in the group at column k: from the stage where it holds
// them, else load_x.
template <int G, bool VEC, int DT>
__device__ __forceinline__ void src_load_x(const Stack<DT>& s,
                                           const Src<DT>& src, int i,
                                           long long p, long long k, Group g,
                                           float sc, float (&o)[G]) {
  if constexpr (G == 4) {
    if (src.x != nullptr) {
      tile_x<DT>(src.x + static_cast<long long>(i) * span_cols<DT>(), sc, o);
      return;
    }
  }
  load_x<G, VEC>(s, i, p, k, g, sc, o);
}

// The group's columns of a float32 vector (v, z): from its staged segment
// `t` where given, else load_f from `row`.
template <int G, bool VEC>
__device__ __forceinline__ void src_load_f(const float* t, const float* row,
                                           long long k, Group g,
                                           float (&o)[G]) {
  if constexpr (G == 4) {
    if (t != nullptr) {
      const float4 q = *reinterpret_cast<const float4*>(t);
      o[0] = q.x, o[1] = q.y, o[2] = q.z, o[3] = q.w;
      return;
    }
  }
  load_f<G, VEC>(row, k, g, o);
}

// A CTA's walk over the groups of its chunks. STAGED false (the global
// body): thread t takes the groups at k0 + G t, k0 + G (t + 256), ... with
// every source null. STAGED: the chunk in spans, each copied into the
// CTA's one stage (NF staged float32 vectors: v, then z) and walked in the
// same order, thread t at columns 4t + 1024 u of the span.
template <int DT, bool STAGED, int NF>
struct Walk {
  using T = typename Elem<DT>::T;
  static constexpr int kSpan = span_cols<DT>();
  unsigned char* stage;
  unsigned long long* bar;
  unsigned phase;

  // Every thread of the CTA constructs it (the mbarrier's initialisation
  // ends on a barrier).
  __device__ explicit Walk(int n) : stage(nullptr), bar(nullptr), phase(0) {
    if constexpr (STAGED) {
      extern __shared__ __align__(128) unsigned char span_stage[];
      stage = span_stage;
      bar = reinterpret_cast<unsigned long long*>(
          stage + (span_smem<DT>(n, NF) - 8));
      if (threadIdx.x == 0) {
        mbar_init(bar);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      __syncthreads();
    }
  }

  // body(k, src) for each of the thread's groups of chunk ch of partition
  // p, in order; v and z are the partition's rows of the vectors the pass
  // reads (null: none; v null reads as zeros).
  template <int G, typename Body>
  __device__ __forceinline__ void run(const Stack<DT>& s, const Chunk& ch,
                                      long long p, const float* v,
                                      const float* z, Body&& body) {
    if constexpr (!STAGED) {
      for (long long k = ch.k0 + threadIdx.x * G; k < ch.k1;
           k += kThreads * G)
        body(k, Src<DT>{nullptr, nullptr, nullptr});
    } else {
      static_assert(G == 4, "the staged body takes groups of 4");
      const float* vs = reinterpret_cast<const float*>(stage);
      const float* zs = vs + (NF - 1) * kSpan;
      T* xs = reinterpret_cast<T*>(stage + kSpan * 4 * NF);
      for (long long kb = ch.k0; kb < ch.k1; kb += kSpan) {
        const long long cols = min(static_cast<long long>(kSpan), ch.k1 - kb);
        const long long valid =
            max(0LL, min(cols, s.d - (p * s.part + kb)));
        const long long lim =
            static_cast<long long>((valid * sizeof(T)) & ~15LL) /
            static_cast<long long>(sizeof(T));
        if (threadIdx.x == 0) {
          // the stage's last reads (generic proxy) before the copies
          // (async proxy) that overwrite it
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          const unsigned fb = static_cast<unsigned>(cols * 4);
          const unsigned xb = static_cast<unsigned>(lim * sizeof(T));
          mbar_expect_tx(bar, (v != nullptr ? fb : 0u) +
                                  (NF == 2 && z != nullptr ? fb : 0u) +
                                  xb * s.n);
          if (v != nullptr) bulk_copy(stage, v + kb, fb, bar);
          if (NF == 2 && z != nullptr)
            bulk_copy(stage + kSpan * 4, z + kb, fb, bar);
          if (xb != 0) {
            for (int i = 0; i < s.n; ++i)
              bulk_copy(xs + static_cast<long long>(i) * kSpan,
                        s.x + static_cast<long long>(i) * s.ld + p * s.part +
                            kb,
                        xb, bar);
          }
        }
        mbar_wait(bar, phase);
        phase ^= 1u;
        // one call of the body (so the compiler inlines it, its arrays in
        // registers) per sub-tile, in order
#pragma unroll 1
        for (int u = 0; u < kSpan / kSubCols; ++u) {
          const long long c = u * kSubCols + threadIdx.x * 4;
          if (kb + c < ch.k1) {
            body(kb + c, Src<DT>{c + 4 <= lim ? xs + c : nullptr,
                                 v != nullptr ? vs + c : nullptr,
                                 NF == 2 && z != nullptr ? zs + c : nullptr});
          }
        }
        __syncthreads();  // every thread is done with the stage
      }
    }
  }
};

// The reduction passes above 32 peers (see "Peer tiles"): the CTA walks
// its chunk once per tile of MAXN peers, in index order, and writes the
// tile's slice of its column of the (rows, n, C) partials: <x_i - v, z>
// into dot_out (DOT) and ||x_i - v||^2 into sq_out (SQ), peer i at
// [i * C]. vp null: v = 0.
template <int MAXN, int DT, bool DOT, bool SQ>
__device__ void reduce_tiled(const Stack<DT>& s, long long p, long long k0,
                             long long k1, int C, const float* vp,
                             const float* zp, float* dot_out, float* sq_out) {
  for (int i0 = 0; i0 < s.n; i0 += MAXN) {
    const int nt = min(MAXN, s.n - i0);
    float dacc[MAXN], sacc[MAXN], sc[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      dacc[i] = sacc[i] = 0.f;
      sc[i] = peer_scale(s, i0 + i, p);
    }
    for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
      const float vk = vp == nullptr ? 0.f : vp[k];
      const float zk = DOT ? zp[k] : 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i < nt) {
          const float df = __fsub_rn(load_x1(s, i0 + i, p, k, sc[i]), vk);
          if (DOT) dacc[i] = __fmaf_rn(df, zk, dacc[i]);
          if (SQ) sacc[i] = __fmaf_rn(df, df, sacc[i]);
        }
      }
    }
    if (DOT) block_sums<MAXN>(dacc, nt, dot_out + i0 * C, C);
    if (SQ) block_sums<MAXN>(sacc, nt, sq_out + i0 * C, C);
  }
}

// Pass: per-peer partial sums of ||x_i - v||^2 over each chunk; v null
// reads as zero (the prologue of a cold start). At 16 peers the compiler's
// own choice is 119 registers (2 CTAs an SM); 3 CTAs keep it near its
// earlier 75. STAGED: the staged body (VEC, up to 8 peers).
template <int MAXN, int DT, bool VEC, bool STAGED = false>
__global__ void __launch_bounds__(kThreads, MAXN == 16 ? 3 : 1)
sq_pass_kernel(Stack<DT> s, const float* v, long long cs, int C, int rows,
               float* __restrict__ sq_part) {
  constexpr int G = group_cols<MAXN>();
  Walk<DT, STAGED, 1> walk(s.n);
  const long long chunks = static_cast<long long>(rows) * C;
  for (long long q = blockIdx.x; q < chunks; q += gridDim.x) {
    const Chunk ch = chunk_at(q, C, cs, s.part);
    const long long p = ch.r;
    const float* vp = v == nullptr ? nullptr : v + p * s.part;
    float* out = sq_part + p * s.n * C + ch.c;
    if (MAXN == kTile && s.n > MAXN) {
      reduce_tiled<MAXN, DT, false, true>(s, p, ch.k0, ch.k1, C, vp, nullptr,
                                          nullptr, out);
      continue;
    }
    float acc[MAXN], sc[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      acc[i] = 0.f;
      sc[i] = peer_scale(s, i, p);
    }
    walk.template run<G>(s, ch, p, vp, nullptr, [&](long long k,
                                                    const Src<DT>& src) {
      const Group g = group_at<G, VEC>(s, p, k, ch.k1);
      float vg[G];
      src_load_f<G, VEC>(src.v, vp, k, g, vg);
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i < s.n) {
          float xg[G];
          src_load_x<G, VEC>(s, src, i, p, k, g, sc[i], xg);
#pragma unroll
          for (int e = 0; e < G; ++e) {
            if (e < g.nv) {
              const float df = __fsub_rn(xg[e], vg[e]);
              acc[i] = __fmaf_rn(df, df, acc[i]);
            }
          }
        }
      }
    });
    block_sums<MAXN>(acc, s.n, out, C);
  }
}

// The update pass above 32 peers (see "Peer tiles"): sweep 1 forms each
// column's update over all n peers in index order; with SQ it keeps the
// update in `up` and sweep 2 walks the peer tiles for the next norms, the
// last tile writing v; without SQ sweep 1 writes v. The arithmetic is the
// untiled pass's, peer by peer. vi null: v = 0.
template <int MAXN, int DT, bool SQ, bool D2>
__device__ void update_tiled(const Stack<DT>& s, long long p, int c, int C,
                             long long k0, long long k1, const float* vi,
                             float* vo, const float* cwp, float ws,
                             float* sq_part, float* d2_part, float* up) {
  float dacc = 0.f;
  for (long long k = k0 + threadIdx.x; k < k1; k += kThreads) {
    const float vk = vi == nullptr ? 0.f : vi[k];
    float num = 0.f;
    for (int i = 0; i < s.n; ++i) {
      const float diff =
          __fsub_rn(load_x1(s, i, p, k, peer_scale(s, i, p)), vk);
      num = __fmaf_rn(__ldg(cwp + i), diff, num);
    }
    const float upd = __fdiv_rn(num, ws);
    if (SQ) {
      up[k] = upd;
    } else {
      const float vn = __fadd_rn(vk, upd);
      vo[k] = vn;
      if (D2) {
        const float dv = __fsub_rn(vn, vk);
        dacc = __fmaf_rn(dv, dv, dacc);
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
        const float vk = vi == nullptr ? 0.f : vi[k], upd = up[k];
#pragma unroll
        for (int i = 0; i < MAXN; ++i) {
          if (i < nt) {
            const float nd = __fsub_rn(
                __fsub_rn(load_x1(s, i0 + i, p, k, sc[i]), vk), upd);
            acc[i] = __fmaf_rn(nd, nd, acc[i]);
          }
        }
        if (last) {
          const float vn = __fadd_rn(vk, upd);
          vo[k] = vn;
          if (D2) {
            const float dv = __fsub_rn(vn, vk);
            dacc = __fmaf_rn(dv, dv, dacc);
          }
        }
      }
      block_sums<MAXN>(acc, nt, sq_part + (p * s.n + i0) * C + c, C);
    }
  }
  if (D2) {
    const float t = block_sum1(dacc);
    if (threadIdx.x == 0) d2_part[p * C + c] = t;
  }
}

// Pass: one CenteredClip iteration, v_out = v_in + sum_i cw_i (x_i - v_in)
// / wsum, column by column (in place when v_in == v_out; v_in null reads
// as zero, the first iteration of a cold start). SQ: also the NEXT
// iteration's squared norms, sum ||diff - upd||^2 from values already in
// registers (the fused kernel's incremental norms). D2: also ||v_new -
// v||^2 partials, and partitions with d2[p] <= tol2 are frozen (the
// adaptive loop's select): not read and not written, so v_in != v_out only
// where every d2[p] > tol2 (a first step, d2 = +inf). Above 32 peers:
// update_tiled, with the (P, part) scratch `u` when SQ. STAGED: the staged
// body.
//
// Registers: at 4 peers the compiler's own choice (104-116 a thread, 2
// CTAs an SM) streamed at 2.1 TB/s on an H100 SXM, and a budget of 64 (4
// CTAs, no spills) at 2.8 TB/s (chip_smoke.py --breakdown, PERF.md), so
// the 4-peer instantiations ask for 4 resident CTAs.
template <int MAXN, int DT, bool SQ, bool D2, bool VEC, bool STAGED = false>
__global__ void __launch_bounds__(kThreads, MAXN <= 4 ? 4 : 1)
update_kernel(Stack<DT> s, const float* vin, float* vout,
              const float* __restrict__ cw, const float* __restrict__ wsum,
              long long cs, int C, int rows, float* __restrict__ sq_part,
              float* __restrict__ d2_part, const float* __restrict__ d2,
              float tol2, float* __restrict__ u) {
  constexpr int G = group_cols<MAXN>();
  Walk<DT, STAGED, 1> walk(s.n);
  const float ws = *wsum;
  const long long chunks = static_cast<long long>(rows) * C;
  for (long long q = blockIdx.x; q < chunks; q += gridDim.x) {
    const Chunk ch = chunk_at(q, C, cs, s.part);
    const long long p = ch.r;
    if (D2 && !(d2[p] > tol2)) continue;  // converged partition: frozen
    const float* vi = vin == nullptr ? nullptr : vin + p * s.part;
    float* vo = vout + p * s.part;
    if (MAXN == kTile && s.n > MAXN) {
      update_tiled<MAXN, DT, SQ, D2>(s, p, ch.c, C, ch.k0, ch.k1, vi, vo,
                                     cw + p * s.n, ws, sq_part, d2_part,
                                     SQ ? u + p * s.part : nullptr);
      continue;
    }
    float w[MAXN], acc[MAXN], sc[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      w[i] = i < s.n ? cw[p * s.n + i] : 0.f;
      acc[i] = 0.f;
      sc[i] = peer_scale(s, i, p);
    }
    float dacc = 0.f;
    walk.template run<G>(s, ch, p, vi, nullptr, [&](long long k,
                                                    const Src<DT>& src) {
      const Group g = group_at<G, VEC>(s, p, k, ch.k1);
      float vg[G], num[G], diff[MAXN][G];
      src_load_f<G, VEC>(src.v, vi, k, g, vg);
#pragma unroll
      for (int e = 0; e < G; ++e) num[e] = 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i < s.n) {
          float xg[G];
          src_load_x<G, VEC>(s, src, i, p, k, g, sc[i], xg);
#pragma unroll
          for (int e = 0; e < G; ++e) {
            diff[i][e] = __fsub_rn(xg[e], vg[e]);
            num[e] = __fmaf_rn(w[i], diff[i][e], num[e]);
          }
        }
      }
      float upd[G], vn[G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        upd[e] = __fdiv_rn(num[e], ws);
        vn[e] = __fadd_rn(vg[e], upd[e]);
      }
      store_f<G, VEC>(vo, k, g, vn);
#pragma unroll
      for (int e = 0; e < G; ++e) {
        if (e < g.nv) {
          if (SQ) {
#pragma unroll
            for (int i = 0; i < MAXN; ++i) {
              if (i < s.n) {
                const float nd = __fsub_rn(diff[i][e], upd[e]);
                acc[i] = __fmaf_rn(nd, nd, acc[i]);
              }
            }
          }
          if (D2) {
            const float dv = __fsub_rn(vn[e], vg[e]);
            dacc = __fmaf_rn(dv, dv, dacc);
          }
        }
      }
    });
    if (SQ) block_sums<MAXN>(acc, s.n, sq_part + p * s.n * C + ch.c, C);
    if (D2) {
      const float t = block_sum1(dacc);
      if (threadIdx.x == 0) d2_part[p * C + ch.c] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// The two-phase clip (#4, #12): one read of the stack an iteration.
//
// The JAX kernel runs two passes an iteration, the norms ||x_i - v||^2 and
// then the update. Here a budget of L iterations is a prologue that forms
// the norms from v0 (or from zero) and L update passes; each update pass
// but the last also forms the NEXT iteration's norms, ||x_i - v_new||^2,
// from the values of x it has just read (the two-phase recurrence: x -
// v_new squared and summed, not the fused kernel's (diff - upd)^2). A group
// is 4 columns at every n <= 32, thread t taking columns k0 + 4t + 1024 j
// of its chunk (the 1024-column sub-tile j), so one pass sums each peer's
// norm in the order of sq_pass_kernel at <= 8 peers, and the bits follow
// from the chunk grid alone. Two bodies, one arithmetic: the staged body
// ("The staged body of the norm, update and dot passes") where every row
// start is 16-byte aligned, each thread reading its 4 columns of each peer
// from shared memory twice, once for the update and once for the norms, so
// no thread holds n x 4 values; else the same two sweeps with loads from
// global memory, column by column where unaligned. On an H100 (PERF.md)
// one 69,640-byte stage at 16 peers, 2-3 CTAs an SM, read 3.0 TB/s in the
// update, and one CTA with a ring of 2 or 3 stages 2.3; at 4 peers one
// stage (4 CTAs an SM) matched 2 and 3 and beat a body that kept the
// group's values in registers (3.83 against 4.07 ms for #4).
// Above 32 peers the two-phase clip keeps its two passes an iteration
// (sq_pass_kernel and update_kernel, peer-tiled).
// ---------------------------------------------------------------------------
// Dynamic shared memory of the two-phase pass over n peers: the staged
// body's stage (vec), else none.
template <int DT>
constexpr int clip_smem(int n, bool vec) {
  return vec ? span_smem<DT>(n, 1) : 0;
}
static_assert(clip_smem<0>(32, true) <= kStageBudget &&
                  clip_smem<2>(32, true) <= kStageBudget,
              "a 32-peer stage fits a CTA");

// One group of the two-phase pass. UPD: v_out = v_in + sum_i cw_i (x_i -
// v_in) / wsum, peers in index order (vin null: zeros). NEXT: acc[i] +=
// ||x_i - v||^2 over the group's columns, v the new iterate (UPD) or v_in
// (the prologue), each x_i read again from `src`.
template <int MAXN, int DT, bool UPD, bool NEXT, bool VEC>
__device__ __forceinline__ void clip_group(const Stack<DT>& s,
                                           const Src<DT>& src, long long p,
                                           long long k, Group g,
                                           const float* vi, float* vo,
                                           const float (&w)[MAXN],
                                           const float (&sc)[MAXN], float ws,
                                           float (&acc)[MAXN]) {
  float vg[4], vn[4];
  src_load_f<4, VEC>(src.v, vi, k, g, vg);
  if constexpr (UPD) {
    float num[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < s.n) {
        float xg[4];
        src_load_x<4, VEC>(s, src, i, p, k, g, sc[i], xg);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          num[e] = __fmaf_rn(w[i], __fsub_rn(xg[e], vg[e]), num[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) vn[e] = __fadd_rn(vg[e], __fdiv_rn(num[e], ws));
    store_f<4, VEC>(vo, k, g, vn);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) vn[e] = vg[e];
  }
  if constexpr (NEXT) {
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      if (i < s.n) {
        float xg[4];
        src_load_x<4, VEC>(s, src, i, p, k, g, sc[i], xg);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < g.nv) {
            const float nd = __fsub_rn(xg[e], vn[e]);
            acc[i] = __fmaf_rn(nd, nd, acc[i]);
          }
        }
      }
    }
  }
}

// Pass: the two-phase clip's prologue (!UPD: the norms at v_in), an update
// carrying the next norms (UPD, NEXT) or the last update (UPD only), over
// n <= 32 peers; VEC (every row start 16-byte aligned) is the staged body,
// with clip_smem bytes of dynamic shared memory, else the global body. The
// register budget keeps 4 CTAs an SM at 4 peers.
template <int MAXN, int DT, bool UPD, bool NEXT, bool VEC>
__global__ void __launch_bounds__(kThreads, MAXN <= 4 ? 4 : 1)
clip_pass_kernel(Stack<DT> s, const float* vin, float* vout,
                 const float* __restrict__ cw, const float* __restrict__ wsum,
                 long long cs, int C, int rows, float* __restrict__ sq_part) {
  static_assert(UPD || NEXT, "a pass updates, forms norms, or both");
  Walk<DT, VEC, 1> walk(s.n);
  const float ws = UPD ? *wsum : 1.f;
  const long long chunks = static_cast<long long>(rows) * C;
  for (long long q = blockIdx.x; q < chunks; q += gridDim.x) {
    const Chunk ch = chunk_at(q, C, cs, s.part);
    const long long p = ch.r;
    const float* vi = vin == nullptr ? nullptr : vin + p * s.part;
    float* vo = UPD ? vout + p * s.part : nullptr;
    float w[MAXN], acc[MAXN], sc[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      w[i] = UPD && i < s.n ? cw[p * s.n + i] : 0.f;
      acc[i] = 0.f;
      sc[i] = peer_scale(s, i, p);
    }
    walk.template run<4>(s, ch, p, vi, nullptr, [&](long long k,
                                                    const Src<DT>& src) {
      const Group g = group_at<4, VEC>(s, p, k, ch.k1);
      clip_group<MAXN, DT, UPD, NEXT, VEC>(s, src, p, k, g, vi, vo, w, sc,
                                           ws, acc);
    });
    if (NEXT) block_sums<MAXN>(acc, s.n, sq_part + p * s.n * C + ch.c, C);
  }
}

// Pass: per-peer partials of <x_i - v, z> and, with SQ, ||x_i - v||^2.
// Row j of the chunk grid reads partition p = j, or p = rows_at[j] when
// given (the sampled-digest pass: only the k sampled partitions are read),
// and writes row j of the partials. The body is the same either way, so
// row j of a sampled pass has the bits of row rows_at[j] of the full pass.
// STAGED: the staged body (v and z staged with the stack).
template <int MAXN, int DT, bool SQ, bool VEC, bool STAGED = false>
__global__ void __launch_bounds__(kThreads)
dot_pass_kernel(Stack<DT> s, const float* v, const float* __restrict__ z,
                long long cs, int C, int rows, float* __restrict__ dot_part,
                float* __restrict__ sq_part, const int* __restrict__ rows_at) {
  constexpr int G = group_cols<MAXN>();
  Walk<DT, STAGED, 2> walk(s.n);
  const long long chunks = static_cast<long long>(rows) * C;
  for (long long q = blockIdx.x; q < chunks; q += gridDim.x) {
    const Chunk ch = chunk_at(q, C, cs, s.part);
    const long long j = ch.r;
    const long long p =
        rows_at == nullptr ? j : static_cast<long long>(rows_at[j]);
    const float* vp = v == nullptr ? nullptr : v + p * s.part;
    const float* zp = z + p * s.part;
    float* dout = dot_part + j * s.n * C + ch.c;
    float* sout = SQ ? sq_part + j * s.n * C + ch.c : nullptr;
    if (MAXN == kTile && s.n > MAXN) {
      reduce_tiled<MAXN, DT, true, SQ>(s, p, ch.k0, ch.k1, C, vp, zp, dout,
                                       sout);
      continue;
    }
    float dacc[MAXN], sacc[MAXN], sc[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      dacc[i] = sacc[i] = 0.f;
      sc[i] = peer_scale(s, i, p);
    }
    walk.template run<G>(s, ch, p, vp, zp, [&](long long k,
                                               const Src<DT>& src) {
      const Group g = group_at<G, VEC>(s, p, k, ch.k1);
      float vg[G], zg[G];
      src_load_f<G, VEC>(src.v, vp, k, g, vg);
      src_load_f<G, VEC>(src.z, zp, k, g, zg);
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i < s.n) {
          float xg[G];
          src_load_x<G, VEC>(s, src, i, p, k, g, sc[i], xg);
#pragma unroll
          for (int e = 0; e < G; ++e) {
            if (e < g.nv) {
              const float df = __fsub_rn(xg[e], vg[e]);
              dacc[i] = __fmaf_rn(df, zg[e], dacc[i]);
              if (SQ) sacc[i] = __fmaf_rn(df, df, sacc[i]);
            }
          }
        }
      }
    });
    block_sums<MAXN>(dacc, s.n, dout, C);
    if (SQ) block_sums<MAXN>(sacc, s.n, sout, C);
  }
}

// ---------------------------------------------------------------------------
// verified:mean (#5, #8): the weighted mean and its digests in one read of
// the stack. Replaces the passes of mean_digest_fused_pallas and
// mean_digest_fused_dequant_pallas (_md_kernel and _md_dequant_kernel,
// src/repro/kernels/centered_clip.py).
//
// The JAX kernel reads x twice because its grid runs in order: phase 0
// writes the mean, phase 1 reads x again against it. The mean of a column
// needs only that column's n values, so here the thread that holds a
// group's columns of all n peers forms v there, stores it, and sums <x_i -
// v, z> and ||x_i - v||^2 from the same values. Bound: bytes. The pass
// moves S + 2V (the stack and z read, v written), which is the bound,
// against 2S + 3V for a mean pass and a dot pass.
//
// The bits are those of those two passes, so a validator's recompute
// (#6, and #9 at the sampled rows, against this v) gives them back:
//   * v[k] = (sum_i w_i x_i[k]) / max(sum_i w_i, 1e-30), the sum by
//     __fmaf_rn over the peers in index order, then __fdiv_rn, the
//     weights' sum in index order: every column on its own, so the group
//     a column falls in changes nothing;
//   * the dots in dot_pass_kernel's group order, with its _rn intrinsics
//     and its block_sums tree, against that same v.
// Bodies: the staged body up to 8 peers where every row start is 16-byte
// aligned (the rows and z staged, z in the stage's one vector slot, Src::v;
// v is written, not read); else the global body. Up to 8 peers (groups of
// 4 columns) a thread loads and dequantizes its group's n x 4 values once
// and keeps them, and the weights, in registers for the dots; at 9-32
// peers (groups of one column) it reads them again for the dots (mostly
// from L1) and the weights from cache, so no thread holds n values beside
// dot_pass_kernel's dacc, sacc and sc. v is written through (store_wt):
// on an H100 (PERF.md, chip_smoke.py --breakdown) the staged pass at 4
// peers with plain stores of v moved 2.0 TB/s over int8 stacks and 2.3
// over bf16 (3.0 over float32, where v is a sixth of the bytes, not a
// third or a quarter); written through, 2.7 and 2.8. The register budget
// keeps 4 CTAs an SM at 4 peers, as the update's.
// Above 32 peers each chunk is walked twice: the mean over all peers in
// index order, writing the chunk's v, then reduce_tiled against that v;
// each thread reads back only the columns it wrote, so nothing crosses
// threads.
// ---------------------------------------------------------------------------
// v's columns of a group, written through (st.global.wt), VEC as store_f.
template <int G, bool VEC>
__device__ __forceinline__ void store_wt(float* row, long long k, Group g,
                                         const float (&o)[G]) {
  if constexpr (VEC) {
    __stwt(reinterpret_cast<float4*>(row + k),
           make_float4(o[0], o[1], o[2], o[3]));
    return;
  }
#pragma unroll
  for (int e = 0; e < G; ++e) {
    if (e < g.nv) __stwt(row + k + e, o[e]);
  }
}

template <int MAXN, int DT, bool VEC, bool STAGED = false>
__global__ void __launch_bounds__(kThreads, MAXN <= 4 ? 4 : 1)
mean_dot_pass_kernel(Stack<DT> s, const float* __restrict__ w, float* v,
                     const float* __restrict__ z, long long cs, int C,
                     int rows, float* __restrict__ dot_part,
                     float* __restrict__ sq_part) {
  constexpr int G = group_cols<MAXN>();
  constexpr bool HOLD = G == 4;  // the group's values kept in registers
  Walk<DT, STAGED, 1> walk(s.n);
  float wt = 0.f;
  for (int i = 0; i < s.n; ++i) wt += w[i];
  const float ws = fmaxf(wt, 1e-30f);
  float wr[HOLD ? MAXN : 1];
#pragma unroll
  for (int i = 0; i < (HOLD ? MAXN : 1); ++i) wr[i] = i < s.n ? w[i] : 0.f;
  const long long chunks = static_cast<long long>(rows) * C;
  for (long long q = blockIdx.x; q < chunks; q += gridDim.x) {
    const Chunk ch = chunk_at(q, C, cs, s.part);
    const long long p = ch.r;
    float* vp = v + p * s.part;
    const float* zp = z + p * s.part;
    float* dout = dot_part + p * s.n * C + ch.c;
    float* sout = sq_part + p * s.n * C + ch.c;
    if (MAXN == kTile && s.n > MAXN) {
      for (long long k = ch.k0 + threadIdx.x; k < ch.k1; k += kThreads) {
        float num = 0.f;
        for (int i = 0; i < s.n; ++i)
          num = __fmaf_rn(__ldg(w + i),
                          load_x1(s, i, p, k, peer_scale(s, i, p)), num);
        vp[k] = __fdiv_rn(num, ws);
      }
      reduce_tiled<MAXN, DT, true, true>(s, p, ch.k0, ch.k1, C, vp, zp, dout,
                                         sout);
      continue;
    }
    float dacc[MAXN], sacc[MAXN], sc[MAXN];
#pragma unroll
    for (int i = 0; i < MAXN; ++i) {
      dacc[i] = sacc[i] = 0.f;
      sc[i] = peer_scale(s, i, p);
    }
    walk.template run<G>(s, ch, p, zp, nullptr, [&](long long k,
                                                    const Src<DT>& src) {
      const Group g = group_at<G, VEC>(s, p, k, ch.k1);
      float vg[G], zg[G], xh[HOLD ? MAXN : 1][G];
      src_load_f<G, VEC>(src.v, zp, k, g, zg);
#pragma unroll
      for (int e = 0; e < G; ++e) vg[e] = 0.f;
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i < s.n) {
          const float wi = HOLD ? wr[HOLD ? i : 0] : __ldg(w + i);
          float(&xg)[G] = xh[HOLD ? i : 0];
          src_load_x<G, VEC>(s, src, i, p, k, g, sc[i], xg);
#pragma unroll
          for (int e = 0; e < G; ++e) vg[e] = __fmaf_rn(wi, xg[e], vg[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < G; ++e) vg[e] = __fdiv_rn(vg[e], ws);
      store_wt<G, VEC>(vp, k, g, vg);
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i < s.n) {
          float(&xg)[G] = xh[HOLD ? i : 0];
          if constexpr (!HOLD)
            src_load_x<G, VEC>(s, src, i, p, k, g, sc[i], xg);
#pragma unroll
          for (int e = 0; e < G; ++e) {
            if (e < g.nv) {
              const float df = __fsub_rn(xg[e], vg[e]);
              dacc[i] = __fmaf_rn(df, zg[e], dacc[i]);
              sacc[i] = __fmaf_rn(df, df, sacc[i]);
            }
          }
        }
      }
    });
    block_sums<MAXN>(dacc, s.n, dout, C);
    block_sums<MAXN>(sacc, s.n, sout, C);
  }
}

// Finish: CTA (p, b) of a (P, B) grid (kThreads threads) takes partition
// p's peers i = b, b + B, ... sq[p, i] = the fixed tree's sum of peer i's
// C partials, cw[p, i] = clip_weight(sq, tau) * w[i]; wsum = max(sum_i
// w_i, 1e-30). With d2/d2_part (the adaptive step) only the partitions
// that took this step (d2[p] > tol2) are finished, and CTA (p, 0) also
// sums their ||dv||^2 into d2[p] and counts the step in iters[p]: all its
// threads read d2[p] before its barriers and thread 0 writes it after
// them. Another CTA of p may read d2[p] before or after that write; if
// after, and p has just converged, it leaves p's sq and cw as they were,
// which no later step reads (p is frozen). d2_seen (pinned host memory,
// mapped; may be null): thread 0 of CTA (p, 0) also writes d2[p] there,
// for the host to read once an event behind this kernel has completed.
__global__ void __launch_bounds__(kThreads) finish_weights_kernel(
    const float* __restrict__ sq_part, int C, int n,
    const float* __restrict__ w, float tau, float* __restrict__ sq_out,
    float* __restrict__ cw_out, float* __restrict__ wsum_out,
    const float* __restrict__ d2_part, float* d2, int* __restrict__ iters,
    float tol2, float* d2_seen) {
  const long long p = blockIdx.x;
  if (p == 0 && blockIdx.y == 0 && threadIdx.x == 0 && wsum_out != nullptr) {
    float t = 0.f;
    for (int j = 0; j < n; ++j) t += w[j];
    *wsum_out = fmaxf(t, 1e-30f);
  }
  if (d2 != nullptr) {
    const float was = d2[p];
    if (!(was > tol2)) {  // frozen partition
      if (blockIdx.y == 0 && threadIdx.x == 0 && d2_seen != nullptr)
        d2_seen[p] = was;
      return;
    }
  }
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const float sq = fixed_sum(sq_part + (p * n + i) * C, C);
    if (threadIdx.x == 0) {
      sq_out[p * n + i] = sq;
      cw_out[p * n + i] = clip_weight(sq, tau) * w[i];
    }
  }
  if (d2 != nullptr && blockIdx.y == 0) {
    const float now = fixed_sum(d2_part + p * C, C);
    if (threadIdx.x == 0) {
      d2[p] = now;
      iters[p] += 1;
      if (d2_seen != nullptr) d2_seen[p] = now;
    }
  }
}

// Finish the tables: CTA (j, b) takes row j of the partials (a partition,
// or a sampled one) and its peers b, b + B, ..., as above. dot from
// partials, sq from partials (sq_part) or a carried buffer (sq_in). CLIP
// (the Alg. 6 tables of butterfly_clip): s = min(1, tau / ||x - v||) *
// dot, tau = inf -> dot. Without CLIP (the verified:* digests, which carry
// no tau): s = dot. norm = ||x - v|| either way.
template <bool CLIP>
__global__ void __launch_bounds__(kThreads) finish_tables_kernel(
    const float* __restrict__ dot_part, const float* __restrict__ sq_part,
    const float* __restrict__ sq_in, int C, int n, float tau,
    float* __restrict__ s_out, float* __restrict__ norm_out) {
  const long long p = blockIdx.x;
  for (int i = blockIdx.y; i < n; i += gridDim.y) {
    const float dot = fixed_sum(dot_part + (p * n + i) * C, C);
    const float sq = sq_part != nullptr
                         ? fixed_sum(sq_part + (p * n + i) * C, C)
                         : sq_in[p * n + i];
    if (threadIdx.x == 0) {
      const float nrm = sqrtf(fmaxf(sq, 0.f));
      if (CLIP) {
        const float cwv =
            isinf(tau) ? 1.f : fminf(1.f, tau / fmaxf(nrm, 1e-30f));
        s_out[p * n + i] = cwv * dot;
      } else {
        s_out[p * n + i] = dot;
      }
      norm_out[p * n + i] = nrm;
    }
  }
}

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

// CTAs of a persistent pass: as many as the card holds at once (its SM
// count times the kernel's resident CTAs per SM at `smem` bytes of dynamic
// shared memory), at most one per chunk. The logical chunk grid, and so
// every bit, does not depend on it. The card's count is asked once per
// (kernel, device, smem) and kept; rank threads launch at once, so the
// table is locked.
template <typename Kernel>
inline int persistent_ctas(Kernel kernel, long long chunks, int smem = 0) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, int>, long long> held;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key =
      std::make_tuple(reinterpret_cast<const void*>(kernel), dev, smem);
  long long full = 0;
  {
    std::lock_guard<std::mutex> guard(lock);
    const auto it = held.find(key);
    if (it != held.end()) full = it->second;
  }
  if (full == 0) {
    int sms = 1, per_sm = 1;
    const bool asked =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem) ==
            cudaSuccess;
    full = static_cast<long long>(sms > 0 ? sms : 1) *
           (per_sm > 0 ? per_sm : 1);
    if (asked) {
      std::lock_guard<std::mutex> guard(lock);
      held[key] = full;
    }
  }
  return static_cast<int>(chunks < full ? chunks : full);
}

// Launch a pass over the rows x C chunk grid on its persistent grid.
template <typename... Params, typename... Args>
inline void launch_pass(void (*kernel)(Params...), long long chunks,
                        cudaStream_t st, Args... args) {
  kernel<<<persistent_ctas(kernel, chunks), kThreads, 0, st>>>(args...);
}

// Let `kernel` take up to `most` bytes of dynamic shared memory, above the
// default 48 KB: once per (kernel, device), at the most any launch of it
// takes, so that rank threads launching it at once never lower the limit
// under one another's launch.
template <typename Kernel>
inline int allow_smem(Kernel kernel, int most) {
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, bool> allowed;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  std::lock_guard<std::mutex> guard(lock);
  if (allowed.count(key) != 0) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e == cudaSuccess) allowed[key] = true;
  return static_cast<int>(e);
}

// launch_pass with `smem` bytes of dynamic shared memory, the kernel
// allowed `most` (allow_smem) first; a refusal is returned (and the kernel
// not launched).
template <typename... Params, typename... Args>
inline int launch_pass_smem(void (*kernel)(Params...), long long chunks,
                            int smem, int most, cudaStream_t st,
                            Args... args) {
  if (smem > 0) {
    const int e = allow_smem(kernel, most);
    if (e != 0) return e;
  }
  kernel<<<persistent_ctas(kernel, chunks, smem), kThreads, smem, st>>>(
      args...);
  return 0;
}

// Registers, local (spill) bytes and resident CTAs per SM of a kernel at
// `smem` bytes of dynamic shared memory (out[0..2]; out[3] = smem), the
// kernel allowed `most` as a launch allows it.
template <typename... Params>
inline int kernel_info(void (*kernel)(Params...), int* out, int smem = 0,
                       int most = 0) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[3] = smem;
  if (smem > 0) {
    const int rc = allow_smem(kernel, most);
    if (rc != 0) return rc;
  }
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, kernel,
                                                    kThreads, smem));
}

inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// `vec` of a pass that has a staged body: 0 column by column, 1 the 16-byte
// loads, kStaged the staged body ("The staged body of the norm, update
// and dot passes"; verified:mean's pass too).
constexpr int kStaged = 2;

// 0 where the staged body can run over s with the float32 vectors f0, f1
// (null: not read): n <= most (8; the two-phase clip's 32) and every row
// start of the stack and each vector 16-byte aligned; else the error its
// launcher returns, unlaunched.
template <int DT>
int staged_status(const Stack<DT>& s, const void* f0, const void* f1,
                  int most = 8) {
  constexpr long long es = sizeof(typename Elem<DT>::T);
  if (s.n > most) return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = aligned16(s.x) && (s.ld * es) % 16 == 0 &&
                  (s.part * es) % 16 == 0 && aligned16(f0) && aligned16(f1);
  return ok ? 0 : static_cast<int>(cudaErrorMisalignedAddress);
}

// Launch one pass of the two-phase clip over P partitions (vout null: the
// prologue's norms at vin; sq_part null: the last update). Up to 32 peers
// it is clip_pass_kernel, the staged body where `vec` says every row start
// is 16-byte aligned; above, the peer-tiled norm pass or update (two passes
// an iteration, no next norms). Returns cudaErrorInvalidValue for an ask
// it does not take and cudaErrorMisalignedAddress for a staged pass over
// rows off 16 bytes.
template <int DT>
int clip_pass(const Stack<DT>& s, int P, long long cs, int C, int vec,
              const float* vin, float* vout, const float* cw,
              const float* wsum, float* sq_part, cudaStream_t st) {
  const bool upd = vout != nullptr, next = sq_part != nullptr;
  const long long chunks = static_cast<long long>(P) * C;
  if ((!upd && !next) || (upd && (cw == nullptr || wsum == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (s.n > kTile) {
    if (upd && next) return static_cast<int>(cudaErrorInvalidValue);
    if (upd) {
      launch_pass(update_kernel<kTile, DT, false, false, false>, chunks, st,
                  s, vin, vout, cw, wsum, cs, C, P, nullptr, nullptr,
                  nullptr, 0.f, nullptr);
    } else {
      launch_pass(sq_pass_kernel<kTile, DT, false>, chunks, st, s, vin, cs,
                  C, P, sq_part);
    }
    return launch_status();
  }
  int rc = vec ? staged_status(s, vin, vout, kTile) : 0;
  if (rc != 0) return rc;
#define CC_CLIP_LAUNCH(N, V)                                                 \
  do {                                                                       \
    const int smem = clip_smem<DT>(s.n, V), most = clip_smem<DT>(N, V);      \
    if (upd && next) {                                                       \
      rc = launch_pass_smem(clip_pass_kernel<N, DT, true, true, V>, chunks,  \
                            smem, most, st, s, vin, vout, cw, wsum, cs, C,   \
                            P, sq_part);                                     \
    } else if (upd) {                                                        \
      rc = launch_pass_smem(clip_pass_kernel<N, DT, true, false, V>, chunks, \
                            smem, most, st, s, vin, vout, cw, wsum, cs, C,   \
                            P, sq_part);                                     \
    } else {                                                                 \
      rc = launch_pass_smem(clip_pass_kernel<N, DT, false, true, V>, chunks, \
                            smem, most, st, s, vin, vout, cw, wsum, cs, C,   \
                            P, sq_part);                                     \
    }                                                                        \
  } while (0)
  CC_DISPATCH_CLIP(s.n, vec, CC_CLIP_LAUNCH);
#undef CC_CLIP_LAUNCH
  return rc != 0 ? rc : launch_status();
}

// What the compiler made of the two-phase pass at n <= 32 peers (`mode` 0:
// the prologue, 1: an update with the next norms, 2: the last update), as
// kernel_info, with the dynamic shared memory a launch gives it.
template <int DT>
int clip_pass_info(int mode, int n, int vec, int* out) {
  if (n < 1 || n > kTile || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
#define CC_CLIP_INFO(N, V)                                                 \
  do {                                                                     \
    const int smem = clip_smem<DT>(n, V), most = clip_smem<DT>(N, V);      \
    if (mode == 1)                                                         \
      return kernel_info(clip_pass_kernel<N, DT, true, true, V>, out, smem, \
                         most);                                            \
    if (mode == 2)                                                         \
      return kernel_info(clip_pass_kernel<N, DT, true, false, V>, out,     \
                         smem, most);                                      \
    return kernel_info(clip_pass_kernel<N, DT, false, true, V>, out, smem, \
                       most);                                              \
  } while (0)
  CC_DISPATCH_CLIP(n, vec, CC_CLIP_INFO);
#undef CC_CLIP_INFO
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cc

// Return from the launcher after launching the staged instantiation
// KERNEL(N) (N = 4 or 8; KERNEL defined by the caller) of a pass over n
// peers that stages NF float32 vectors, with its stage's dynamic shared
// memory (the kernel allowed its N-peer stage once). Needs DT, n, chunks
// and st in scope.
#define CC_LAUNCH_STAGED(NF, ...)                                           \
  do {                                                                      \
    const int smem = cc::span_smem<DT>(n, NF);                              \
    const int rc_ =                                                         \
        n <= 4 ? cc::launch_pass_smem(KERNEL(4), chunks, smem,              \
                                      cc::span_smem<DT>(4, NF), st,         \
                                      __VA_ARGS__)                          \
               : cc::launch_pass_smem(KERNEL(8), chunks, smem,              \
                                      cc::span_smem<DT>(8, NF), st,         \
                                      __VA_ARGS__);                         \
    return rc_ != 0 ? rc_ : cc::launch_status();                            \
  } while (0)

// Instantiate LAUNCH(MAXN, VEC) for the smallest register budget that holds
// n peers, with 16-byte loads (VEC) where the host found every row start
// aligned and a group holds 4 columns; above 32 peers the kTile
// instantiation walks them in tiles.
#define CC_DISPATCH_PEERS(n, vec, LAUNCH) \
  do {                                    \
    if ((n) <= 4) {                       \
      if (vec) {                          \
        LAUNCH(4, true);                  \
      } else {                            \
        LAUNCH(4, false);                 \
      }                                   \
    } else if ((n) <= 8) {                \
      if (vec) {                          \
        LAUNCH(8, true);                  \
      } else {                            \
        LAUNCH(8, false);                 \
      }                                   \
    } else if ((n) <= 16) {               \
      LAUNCH(16, false);                  \
    } else {                              \
      LAUNCH(cc::kTile, false);           \
    }                                     \
  } while (0)

namespace cc {

// Launch verified:mean's one pass (mean_dot_pass_kernel) over P
// partitions: v written, the (P, n, C) partials of <x_i - v, z> and
// ||x_i - v||^2 into dot_part and sq_part. `vec` as for the norm, update
// and dot passes (kStaged: the staged body, refused above 8 peers or off
// 16 bytes, never run another way).
template <int DT>
int mean_dot_pass(const Stack<DT>& s, int P, long long cs, int C, int vec,
                  const float* w, float* v, const float* z, float* dot_part,
                  float* sq_part, cudaStream_t st) {
  const int n = s.n;
  const long long chunks = static_cast<long long>(P) * C;
  if (vec == kStaged) {
    const int rc = staged_status(s, v, z);
    if (rc != 0) return rc;
#define KERNEL(N) mean_dot_pass_kernel<N, DT, true, true>
    CC_LAUNCH_STAGED(1, s, w, v, z, cs, C, P, dot_part, sq_part);
#undef KERNEL
  }
#define LAUNCH(N, V)                                                       \
  launch_pass(mean_dot_pass_kernel<N, DT, V>, chunks, st, s, w, v, z, cs, \
              C, P, dot_part, sq_part)
  CC_DISPATCH_PEERS(n, vec, LAUNCH);
#undef LAUNCH
  return launch_status();
}

// What the compiler made of verified:mean's pass at n peers and `vec`, as
// kernel_info, with the dynamic shared memory a launch gives it.
template <int DT>
int mean_dot_pass_info(int n, int vec, int* out) {
  out[3] = 0;
  if (vec == kStaged) {
    if (n < 1 || n > 8) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = span_smem<DT>(n, 1);
    if (n <= 4)
      return kernel_info(mean_dot_pass_kernel<4, DT, true, true>, out, smem,
                         span_smem<DT>(4, 1));
    return kernel_info(mean_dot_pass_kernel<8, DT, true, true>, out, smem,
                       span_smem<DT>(8, 1));
  }
#define INFO(N, V) return kernel_info(mean_dot_pass_kernel<N, DT, V>, out)
  CC_DISPATCH_PEERS(n, vec, INFO);
#undef INFO
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cc
