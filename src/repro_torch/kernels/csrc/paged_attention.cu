// Paged decode attention: one new query token per sequence attends to its
// KV cache, which lies in fixed-size pages that a block table names (the
// pages are allocated through a Honeycomb store; serving/kv_cache.py).
// For sequence b and query head h (KV head kvh = h / G, G = H / KVH):
//   s_j = (q_h . k_j) * scale, then softcap * tanh(s_j / softcap) when
//         softcap != 0, for the visible positions
//         max(start_pos[b], 0) <= j < min(seq_lens[b], PPS * P),
//         k_j the row of KV head kvh at slot j % P of page
//         block_tables[b][j / P];
//   out_h = sum_j softmax(s)_j v_j, in f32, cast to q's type;
//   an empty window gives zeros (l = 0, acc = 0, out = acc / max(l, 1e-30)).
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py:
// paged_attention.  The TPU kernel walks the pages as a sequential grid
// dimension, carries the online-softmax state in VMEM scratch from one page
// to the next and lets the DMA engine fetch each page through the
// scalar-prefetched block table.  Here one block serves one (sequence, KV
// head) and a loop inside the block walks the visible positions in tiles
// of T positions (256 for bf16 pools at D <= 128), so the state stays on
// the SM:
//   0. the tile's K and V rows are copied into shared memory with
//      cp.async, every 16-byte piece of the tile in flight at once (the
//      tile is 128 KB at D = 128 in bf16), each row padded by 16 bytes so
//      that neighbouring threads' rows fall in different banks;
//   1. each thread takes one position of the tile and scores its K row
//      against all G query heads of the KV head, whose q rows sit in
//      shared memory as f32 (the G heads share every K element loaded);
//   2. one warp per head folds the tile's scores into the running max m and
//      sum l (online softmax, f32) and leaves the probabilities in shared
//      memory;
//   3. each thread owns two dims of every head's output and a phase of the
//      tile's positions, and accumulates p * v for all G heads; after the
//      last tile the phases' partial sums are added in shared memory and
//      divided by l.
// The loop ends at the last visible position, so pages past seq_lens (the
// engine points them at its scratch page 0) are never read; a page the
// TPU kernel would visit with no visible position changes nothing there
// (alpha = 1, p = 0).  Page ids are trusted: the caller checks them
// against the pool (serving/engine.py checks each decode step's block
// table on the host).
//
// Bound: bytes.  The call must read the K and V rows of every visible
// position once (2 * KVH * D elements a position), q and the block-table
// entries, and write the output: at the serving path's shapes (B = 8,
// KVH = 2, D = 128, bf16, 1,024-4,000 visible positions a sequence) some
// 20 MB, about 6 us at 3.35 TB/s; its 4 * H * D flops a position take
// well under a microsecond.  The design reads each K/V byte once and keeps
// a whole tile of copies in flight, but with B * KVH blocks (16 at those
// shapes) on 132 SMs, one SM's copy and FMA rate, not the card's, sets its
// time, and a tile's copies do not overlap the previous tile's arithmetic.
// Splitting a sequence's positions across blocks with a combining pass,
// and double-buffering the tiles, are the redesigns that close the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = kThreads; // one position a thread in phase 1
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f; // the Pallas kernel's initial max
constexpr size_t kSmemBudget = 200 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive elements of shared memory as floats (16-byte aligned)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// 2 consecutive elements of shared memory as floats
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Elements of a K or V row in shared memory: D plus 16 bytes of padding.
template <typename TKV>
__host__ __device__ inline int row_stride(int D) {
  return D + 16 / (int)sizeof(TKV);
}

// Shared memory: the K and V tiles [T][row_stride], then in floats q
// [G][D], scores/probabilities [G][T], alpha [G], l [G], the output
// phases' partial sums [nph][G][D], then the tile's pool rows [T] (ints).
template <typename TKV>
__host__ __device__ inline size_t smem_bytes(int G, int D, int T) {
  const int nph = kThreads / (D / 2);
  return 2 * (size_t)T * row_stride<TKV>(D) * sizeof(TKV) +
         sizeof(float) * ((size_t)G * D + (size_t)G * T + 2 * G +
                          (size_t)nph * G * D) +
         sizeof(int) * (size_t)T;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                       const TKV* __restrict__ vp,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens,
                       const int* __restrict__ start_pos,
                       TQ* __restrict__ out, int H, int KVH, int D, int P,
                       int PPS, int T, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KVH;
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int pairs = D / 2, nph = kThreads / pairs;
  const int rs = row_stride<TKV>(D);
  TKV* ks = reinterpret_cast<TKV*>(smem);             // [T][rs]
  TKV* vs = ks + (size_t)T * rs;                       // [T][rs]
  float* qs = reinterpret_cast<float*>(vs + (size_t)T * rs);  // [G][D]
  float* ps = qs + G * D;                              // [G][T]
  float* alpha = ps + G * T;                           // [G]
  float* lsum = alpha + G;                             // [G]
  float* red = lsum + G;                               // [nph][G][D]
  int* rows = reinterpret_cast<int*>(red + (size_t)nph * G * D);  // [T]

  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = to_f32(q[head0 * D + i]);
  const int hi = min(seq_lens[b], PPS * P);
  const int lo = max(start_pos[b], 0);
  const int* bt = block_tables + (size_t)b * PPS;
  const size_t kv_stride = (size_t)KVH * D;  // elements between pool rows
  constexpr int kPiece = 16 / sizeof(TKV);   // elements in 16 bytes
  const int pieces = D / kPiece;             // 16-byte pieces of a row

  // phase-3 ownership: dims 2 * dp, 2 * dp + 1 of every head, positions
  // 4 * ph + 4 * nph * k .. + 3 of each tile
  const int dp = tid % pairs, ph = tid / pairs;
  const bool owns = ph < nph;
  float acc[kMaxG][2];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g][0] = acc[g][1] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // heads warp, warp+8

  for (int j0 = lo; j0 < hi; j0 += T) {
    const int n = min(T, hi - j0);
    // 0. the tile's pool rows, then its K and V rows into shared memory
    if (tid < n) {
      const int pos = j0 + tid;
      rows[tid] = bt[pos / P] * P + pos % P;
    }
    __syncthreads();
    for (int i = tid; i < n * pieces; i += kThreads) {
      const int j = i / pieces, c = (i - j * pieces) * kPiece;
      const size_t src = (size_t)rows[j] * kv_stride + (size_t)kvh * D + c;
      cp_async16(ks + j * rs + c, kp + src);
      cp_async16(vs + j * rs + c, vp + src);
    }
    cp_async_wait_all();
    __syncthreads();
    // 1. scores of position j0 + tid against the G heads
    float s[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
    if (tid < n) {
      const TKV* kr = ks + tid * rs;
      for (int c = 0; c < D; c += 8) {
        float kf[8];
        load8(kr + c, kf);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4 qa = *reinterpret_cast<const float4*>(qs + g * D + c);
            const float4 qb =
                *reinterpret_cast<const float4*>(qs + g * D + c + 4);
            float d = s[g];
            d = fmaf(qa.x, kf[0], d); d = fmaf(qa.y, kf[1], d);
            d = fmaf(qa.z, kf[2], d); d = fmaf(qa.w, kf[3], d);
            d = fmaf(qb.x, kf[4], d); d = fmaf(qb.y, kf[5], d);
            d = fmaf(qb.z, kf[6], d); d = fmaf(qb.w, kf[7], d);
            s[g] = d;
          }
        }
      }
    }
    if (tid < T) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float x = s[g] * scale;
          if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
          ps[g * T + tid] = tid < n ? x : kNegInf;
        }
      }
    }
    __syncthreads();
    // 2. online softmax, one warp per head
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + 8 * r;
      if (g < G) {                            // uniform across the warp
        float* sg = ps + g * T;
        float mc = kNegInf;
        for (int j = lane; j < n; j += 32) mc = fmaxf(mc, sg[j]);
        const float m_new = fmaxf(m[r], warp_max(mc));
        float sum = 0.f;
        for (int j = lane; j < T; j += 32) {
          const float p = j < n ? expf(sg[j] - m_new) : 0.f;
          sg[j] = p;
          sum += p;
        }
        const float a = expf(m[r] - m_new);
        l[r] = l[r] * a + warp_sum(sum);
        m[r] = m_new;
        if (lane == 0) alpha[g] = a;
      }
    }
    __syncthreads();
    // 3. P.V for this thread's two dims and positions
    if (owns) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          acc[g][0] *= alpha[g];
          acc[g][1] *= alpha[g];
        }
      }
      for (int j = 4 * ph; j < n; j += 4 * nph) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = j + u < n ? load2(vs + (j + u) * rs + 2 * dp)
                           : make_float2(0.f, 0.f);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float4 p4 = *reinterpret_cast<const float4*>(ps + g * T + j);
            acc[g][0] = fmaf(p4.x, v[0].x, acc[g][0]);
            acc[g][1] = fmaf(p4.x, v[0].y, acc[g][1]);
            acc[g][0] = fmaf(p4.y, v[1].x, acc[g][0]);
            acc[g][1] = fmaf(p4.y, v[1].y, acc[g][1]);
            acc[g][0] = fmaf(p4.z, v[2].x, acc[g][0]);
            acc[g][1] = fmaf(p4.z, v[2].y, acc[g][1]);
            acc[g][0] = fmaf(p4.w, v[3].x, acc[g][0]);
            acc[g][1] = fmaf(p4.w, v[3].y, acc[g][1]);
          }
        }
      }
    }
    __syncthreads();   // the next tile rewrites rows, the tiles and ps
  }

  // the phases' partial sums, then out = acc / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = warp + 8 * r;
    if (g < G && lane == 0) lsum[g] = l[r];
  }
  if (owns) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float* dst = red + ((size_t)ph * G + g) * D + 2 * dp;
        dst[0] = acc[g][0];
        dst[1] = acc[g][1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float x = 0.f;
    for (int p = 0; p < nph; ++p) x += red[(size_t)p * G * D + i];
    out[head0 * D + i] = from_f32<TQ>(x / fmaxf(lsum[g], 1e-30f));
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* seq_lens, const void* start_pos, void* out, int B,
           int H, int KVH, int D, int P, int PPS, float scale, float softcap,
           cudaStream_t stream) {
  const int G = H / KVH;
  int T = kMaxTile;                 // the largest tile within the budget
  while (T > 32 && smem_bytes<TKV>(G, D, T) > kSmemBudget) T /= 2;
  const size_t smem = smem_bytes<TKV>(G, D, T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_attention_kernel<TQ, TKV><<<dim3(B, KVH), kThreads, smem, stream>>>(
      (const TQ*)q, (const TKV*)kp, (const TKV*)vp, (const int*)bt,
      (const int*)seq_lens, (const int*)start_pos, (TQ*)out, H, KVH, D, P,
      PPS, T, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q_bf16 / kv_bf16: 1 when that operand is bfloat16, 0 when float32.
// The wrapper (kernels/paged_attention.py) checks 1 <= G <= 16,
// D % 8 == 0, 8 <= D <= 256, 16-byte aligned q and pools, and contiguity.
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* bt,
                                      const void* seq_lens,
                                      const void* start_pos, void* out,
                                      int B, int H, int KVH, int D, int P,
                                      int PPS, int q_bf16, int kv_bf16,
                                      float scale, float softcap,
                                      void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16 && kv_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kp, vp, bt, seq_lens,
                                                start_pos, out, B, H, KVH, D,
                                                P, PPS, scale, softcap, s);
  if (q_bf16)
    return launch<__nv_bfloat16, float>(q, kp, vp, bt, seq_lens, start_pos,
                                        out, B, H, KVH, D, P, PPS, scale,
                                        softcap, s);
  if (kv_bf16)
    return launch<float, __nv_bfloat16>(q, kp, vp, bt, seq_lens, start_pos,
                                        out, B, H, KVH, D, P, PPS, scale,
                                        softcap, s);
  return launch<float, float>(q, kp, vp, bt, seq_lens, start_pos, out, B, H,
                              KVH, D, P, PPS, scale, softcap, s);
}
