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
//   an empty window gives zeros.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py:
// paged_attention.  The TPU kernel walks the pages as a sequential grid
// dimension and carries the online-softmax state in VMEM scratch from one
// page to the next.  Blocks on this card run in parallel and in no order,
// so the positions are split (flash-decoding) and the state is combined by
// a second pass:
//
// paged_attention_kernel_split, grid (B, KVH, n_spans), 256 threads.  Block
// (b, kvh, s) takes the visible positions of span s, [s * span, (s + 1) *
// span), for the G query heads of KV head kvh (they share every K/V byte
// the block reads).  A span outside the window writes m = -1e30, l = 0 and
// leaves.  The loads that need no window (q, the span's page ids) go out
// beside seq_lens/start_pos.  The span is walked in tiles of T positions
// (64 for bf16 pools at D <= 128) through a ring of 2-3 shared-memory
// stages:
//   0. each tile's K and V rows are copied with 16-byte cp.async, one
//      commit group per tile; while tile t is computed, the next stages'
//      copies are in flight (wait_group(stages - 1), not wait_group 0);
//      rows are padded by 16 bytes so neighbouring rows fall in other banks;
//   1. the scores: with bf16 q and pools, D % 16 == 0 and G >= 8, on the
//      tensor cores, mma.sync m16n8k16 with the G heads padded to the 16
//      rows of A (q, from shared memory by ldmatrix) and a warp per 8
//      positions as B; the products of two bf16 are exact in f32, so only
//      the summing order differs from the plain version.  Otherwise 256 / T
//      threads share a position, each scores its slice of the K row
//      against all G heads in f32 FMAs, and shuffles add the slices.  On
//      the card the tensor cores were the faster at G = 8 and the FMAs at
//      G = 2, where padding G to 16 rows leaves most of each mma idle
//      (PERF.md, section 6);
//   2. one warp per head folds the tile's scores into the running max m and
//      sum l (online softmax, f32) and leaves the probabilities, in f32, in
//      shared memory;
//   3. each thread owns four dims of every head and a phase of the tile's
//      positions and accumulates p * v in f32 FMAs (p stays f32: rounding
//      it to bf16 for the tensor cores would cost the bf16 gate).
//   At the span's end the phases' sums are added in shared memory and the
//   partial (m, l, acc[G][D]) go to an f32 workspace.
// G is a template parameter (1, 2, 4, 8 or 16; another G rounds up and the
// extra heads are zeros that are never written out), so no head loop runs
// predicated-off heads.
//
// paged_attention_kernel_combine, grid B * H, 128 threads: for each
// sequence and head, over the spans that hold visible positions (worked
// out from seq_lens and start_pos on the device),
//   M = max_s m_s,
//   out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30),
// so an empty window gives zeros.  A thread takes four dims and a group of
// spans, so that all of a sequence's partials are read at once.
//
// The wrapper (kernels/paged_attention.py:span_plan) picks the span, the
// tile and the stages from the static shapes alone (no read of seq_lens on
// the host, so the call stays free of device syncs) and allocates the
// workspace; the kernels allocate nothing.  Page ids are trusted: the
// caller checks them against the pool (serving/engine.py checks each
// decode step's block table on the host); pages past the last visible
// position are never read.
//
// Bound: bytes.  The call must read the K and V rows of every visible
// position once (2 * KVH * D elements a position), q and the block-table
// entries, and write the output: at the serving path's shapes (B = 8,
// KVH = 2, D = 128, bf16, 1,024-4,000 visible positions a sequence) about
// 17 MB, 5 us at 3.35 TB/s, against 4 * H * D flops a position, about 134
// MFLOP.  Splitting the positions puts every SM to work, the ring keeps
// each block's next copies in flight while it computes, and at G >= 8 the
// tensor cores take the score products.  What is left is latency: a live
// block is a chain of dependent steps (its first loads, the tile copies,
// three barriers a tile, the partials' write) and the combining pass is a
// second launch, so the call stays several times over its byte bound
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // split blocks
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's initial max
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use

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

// 4 consecutive elements of shared memory as floats (8- or 16-byte aligned)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

// ldmatrix: lanes 8i..8i+7 name the rows (16 bytes each) of 8x8 matrix i;
// lane L receives elements 2 (L % 4), 2 (L % 4) + 1 of row L / 4 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 out (the products of two
// bf16 are exact in f32)
__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most stages - 1 groups are pending: the oldest tile is in
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 3)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
__host__ __device__ inline int row_stride(int D, int elem) {
  return D + 16 / elem;
}

// Bytes of the tile ring, which the phases' partial sums [nph][GT][D]
// (floats; nph = kThreads / (D / 4)) reuse after the last tile.
__host__ __device__ inline size_t ring_bytes(int GT, int D, int T,
                                             int stages, int elem) {
  const size_t ring = (size_t)stages * 2 * T * row_stride(D, elem) * elem;
  const size_t red = (size_t)(kThreads / (D / 4)) * GT * D * sizeof(float);
  return ring > red ? ring : red;
}

// Shared memory: the ring; q as bf16 [16][D + 8] (the tensor cores' 16
// rows; 16-byte aligned rows for ldmatrix); in floats q [GT][D], the
// scores [GT][T], the probabilities [T][GT] and alpha [GT]; the span's page
// ids [kThreads] (ints).
// kernels/paged_attention.py:smem_bytes mirrors it.
__host__ __device__ inline size_t smem_bytes(int GT, int D, int T, int stages,
                                             int elem) {
  return ring_bytes(GT, D, T, stages, elem) +
         sizeof(float) * ((size_t)GT * D + 2 * (size_t)GT * T + GT) +
         2 * 16 * (size_t)row_stride(D, 2) + sizeof(int) * kThreads;
}

template <typename TKV, int GT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel_split(const void* __restrict__ qv, int q_bf16,
                             const TKV* __restrict__ kp,
                             const TKV* __restrict__ vp,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ seq_lens,
                             const int* __restrict__ start_pos,
                             float* __restrict__ ws_acc,
                             float* __restrict__ ws_m,
                             float* __restrict__ ws_l, int H, int KVH, int G,
                             int D, int P, int PPS, int span, int n_spans,
                             int T, int stages, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int HPW = (GT + 7) / 8;  // heads per warp in phase 2
  const int b = blockIdx.x, kvh = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rs = row_stride(D, sizeof(TKV));
  const size_t stage_elems = 2 * (size_t)T * rs;     // K tile, then V tile
  TKV* ring = reinterpret_cast<TKV*>(smem);
  const int qrs = row_stride(D, 2);
  __nv_bfloat16* qsb = reinterpret_cast<__nv_bfloat16*>(
      smem + ring_bytes(GT, D, T, stages, sizeof(TKV)));  // [16][qrs]
  float* qs = reinterpret_cast<float*>(qsb + 16 * qrs);   // [GT][D]
  float* ps = qs + GT * D;                                // [GT][T]
  float* pt = ps + GT * T;                                // [T][GT]
  float* alpha = pt + GT * T;                             // [GT]
  int* pages = reinterpret_cast<int*>(alpha + GT);        // [kThreads]
  // QK^T on the tensor cores when q and the pools are bf16 and G >= 8: q
  // as the 16 rows of A (heads past G are zeros), a warp per 8 positions
  // as B
  constexpr bool kMma = sizeof(TKV) == 2 && GT >= 8;
  const bool use_mma = kMma && q_bf16 && D % 16 == 0;
  float* red = reinterpret_cast<float*>(smem);  // [nph][GT][D], at the end

  // The loads that do not depend on the window go out together with the
  // window's own: q, the span's page ids
  // and seq_lens/start_pos; their stores to shared memory are unconditional
  // so that no load waits behind the window check.
  const size_t head0 = (size_t)b * H + (size_t)kvh * G;
  const int* bt = block_tables + (size_t)b * PPS;
  const int first_page = sp * span / P;
  const int n_pages = (min(sp * span + span, PPS * P) - 1) / P - first_page + 1;
  const bool cached_pages = n_pages <= kThreads;
  constexpr int kQ = GT * 256 / kThreads;  // G * D <= GT * 256 elements
  float qr[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = tid + k * kThreads;
    qr[k] = 0.f;
    if (i < G * D) {
      const size_t at = head0 * D + i;
      qr[k] = q_bf16 ? __bfloat162float(
                           reinterpret_cast<const __nv_bfloat16*>(qv)[at])
                     : reinterpret_cast<const float*>(qv)[at];
    }
  }
  const int pg = cached_pages && tid < n_pages ? bt[first_page + tid] : 0;
  const int hi = min(seq_lens[b], PPS * P);
  const int lo = max(start_pos[b], 0);
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = tid + k * kThreads;
    if (i < GT * D) {
      qs[i] = qr[k];
      if (use_mma)   // exact: q is bf16
        qsb[(i / D) * qrs + i % D] = __float2bfloat16(qr[k]);
    }
  }
  if (use_mma)
    for (int i = GT * D + tid; i < 16 * D; i += kThreads)
      qsb[(i / D) * qrs + i % D] = __float2bfloat16(0.f);
  pages[tid] = pg;
  const int s_lo = max(lo, sp * span);
  const int s_hi = min(hi, sp * span + span);
  const size_t slot = ((size_t)b * KVH + kvh) * n_spans + sp;
  if (s_lo >= s_hi) {            // no visible position in this span
    if (tid < G) {
      ws_m[slot * G + tid] = kNegInf;
      ws_l[slot * G + tid] = 0.f;
    }
    return;
  }
  __syncthreads();               // qs and pages
  const size_t kv_stride = (size_t)KVH * D;  // elements between pool rows
  const TKV* kbase = kp + (size_t)kvh * D;
  const TKV* vbase = vp + (size_t)kvh * D;
  constexpr int kPiece = 16 / sizeof(TKV);   // elements in 16 bytes
  const int pieces = D / kPiece;             // 16-byte pieces of a row
  const int n_tiles = (s_hi - s_lo + T - 1) / T;

  // copy tile t of the span into its ring stage, one commit group a tile
  auto fetch = [&](int t) {
    if (t < n_tiles) {
      TKV* ks = ring + (size_t)(t % stages) * stage_elems;
      TKV* vs = ks + (size_t)T * rs;
      const int p0 = s_lo + t * T;
      const int n = min(T, s_hi - p0);
      for (int i = tid; i < n * pieces; i += kThreads) {
        const int j = i / pieces, c = (i - j * pieces) * kPiece;
        const int pos = p0 + j, page = pos / P;
        const size_t row =
            (size_t)(cached_pages ? pages[page - first_page] : bt[page]) * P +
            (pos - page * P);
        const size_t src = row * kv_stride + c;
        cp_async16(ks + j * rs + c, kbase + src);
        cp_async16(vs + j * rs + c, vbase + src);
      }
    }
    cp_async_commit();   // an empty group past the last tile keeps count
  };

  // phase 1 without the tensor cores: kThreads / T threads a position, pw
  // positions a warp
  const int tpp = kThreads / T, pw = 32 / tpp;
  const int jl = warp * pw + lane % pw, split = lane / pw;
  // phase 3: dims 4 * dq .. 4 * dq + 3 of every head, positions
  // ph + nph * k of each tile
  const int quads = D / 4, nph = kThreads / quads;
  const int dq = tid % quads, ph = tid / quads;
  const bool owns = ph < nph;
  float acc[GT][4];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  float m[HPW], l[HPW];          // heads warp + 8 * r
#pragma unroll
  for (int r = 0; r < HPW; ++r) m[r] = kNegInf, l[r] = 0.f;

  for (int t = 0; t < stages - 1; ++t) fetch(t);
  for (int t = 0; t < n_tiles; ++t) {
    fetch(t + stages - 1);       // into the stage tile t - 1 freed
    cp_async_wait_ring(stages);  // tile t has landed (this thread's part)
    __syncthreads();             // ... and every thread's
    const TKV* ks = ring + (size_t)(t % stages) * stage_elems;
    const TKV* vs = ks + (size_t)T * rs;
    const int n = min(T, s_hi - (s_lo + t * T));

    // 1. scores
    if (use_mma) {
      if constexpr (kMma) {
        // a warp per 8 positions (nt), against the 16 rows of q
        for (int nt = warp; nt < T / 8; nt += kThreads / 32) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          const TKV* kt = ks + nt * 8 * rs;
          for (int k0 = 0; k0 < D; k0 += 16) {
            uint32_t a[4], bb[2];
            ldmatrix_x4(a, qsb + ((lane & 7) + 8 * ((lane >> 3) & 1)) * qrs +
                               k0 + 8 * (lane >> 4));
            ldmatrix_x2(bb, kt + (lane & 7) * rs + k0 + 8 * ((lane >> 3) & 1));
            mma_bf16_16816(c, a, bb);
          }
          // c[e]: head lane / 4 (+ 8 for e >= 2), position 2 (lane % 4) + e % 2
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int g = (lane >> 2) + 8 * (e >> 1);
            const int j = nt * 8 + 2 * (lane & 3) + (e & 1);
            if (g < GT) {
              float x = c[e] * scale;
              if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
              ps[g * T + j] = j < n ? x : kNegInf;
            }
          }
        }
      }
    } else {
      // position jl against the GT heads, a slice of D a thread
      float s[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) s[g] = 0.f;
      if (jl < n) {
        const TKV* kr = ks + jl * rs;
        for (int c = split * 8; c < D; c += tpp * 8) {
          float kf[8];
          load8(kr + c, kf);
#pragma unroll
          for (int g = 0; g < GT; ++g) {
            const float4 qa =
                *reinterpret_cast<const float4*>(qs + g * D + c);
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
      for (int o = pw; o < 32; o <<= 1) {
#pragma unroll
        for (int g = 0; g < GT; ++g) s[g] += __shfl_xor_sync(~0u, s[g], o);
      }
      if (split == 0) {
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          float x = s[g] * scale;
          if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
          ps[g * T + jl] = jl < n ? x : kNegInf;
        }
      }
    }
    __syncthreads();
    // 2. online softmax, one warp per head
#pragma unroll
    for (int r = 0; r < HPW; ++r) {
      const int g = warp + 8 * r;
      if (g < GT) {                            // uniform across the warp
        float* sg = ps + g * T;
        float mc = kNegInf;
        for (int j = lane; j < n; j += 32) mc = fmaxf(mc, sg[j]);
        const float m_new = fmaxf(m[r], warp_max(mc));
        float sum = 0.f;
        for (int j = lane; j < T; j += 32) {
          const float p = j < n ? expf(sg[j] - m_new) : 0.f;
          pt[j * GT + g] = p;
          sum += p;
        }
        const float a = expf(m[r] - m_new);
        l[r] = l[r] * a + warp_sum(sum);
        m[r] = m_new;
        if (lane == 0) alpha[g] = a;
      }
    }
    __syncthreads();
    // 3. P.V for this thread's four dims and positions
    if (owns) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float a = alpha[g];
        acc[g][0] *= a; acc[g][1] *= a; acc[g][2] *= a; acc[g][3] *= a;
      }
      for (int j = ph; j < n; j += nph) {
        float v[4];
        load4(vs + j * rs + 4 * dq, v);
        const float* pj = pt + j * GT;
#pragma unroll
        for (int g0 = 0; g0 < GT; g0 += 4) {
          float p[4];
          if constexpr (GT >= 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pj + g0);
            p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
          } else {
#pragma unroll
            for (int u = 0; u < GT; ++u) p[u] = pj[u];
          }
#pragma unroll
          for (int u = 0; u < (GT < 4 ? GT : 4); ++u) {
            float* ag = acc[g0 + u];
            ag[0] = fmaf(p[u], v[0], ag[0]);
            ag[1] = fmaf(p[u], v[1], ag[1]);
            ag[2] = fmaf(p[u], v[2], ag[2]);
            ag[3] = fmaf(p[u], v[3], ag[3]);
          }
        }
      }
    }
    __syncthreads();   // the next fetch rewrites this stage, ps, pt, alpha
  }

  // the span's partial state: m and l from the phase-2 warps, acc summed
  // over the phases in the (now idle) ring
#pragma unroll
  for (int r = 0; r < HPW; ++r) {
    const int g = warp + 8 * r;
    if (g < G && lane == 0) {
      ws_m[slot * G + g] = m[r];
      ws_l[slot * G + g] = l[r];
    }
  }
  if (owns) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float* dst = red + ((size_t)ph * GT + g) * D + 4 * dq;
      dst[0] = acc[g][0]; dst[1] = acc[g][1];
      dst[2] = acc[g][2]; dst[3] = acc[g][3];
    }
  }
  __syncthreads();
  float* wa = ws_acc + slot * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    float x = 0.f;
    for (int p = 0; p < nph; ++p) x += red[(size_t)p * GT * D + i];
    wa[i] = x;
  }
}

__device__ __forceinline__ float block_reduce(float x, float* scratch,
                                              bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = is_max ? warp_max(x) : warp_sum(x);
  __syncthreads();               // scratch is free again
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = scratch[0];
  for (int w = 1; w < kCombineThreads / 32; ++w)
    x = is_max ? fmaxf(x, scratch[w]) : x + scratch[w];
  return x;
}

template <typename TQ>
__global__ void __launch_bounds__(kCombineThreads)
paged_attention_kernel_combine(const float* __restrict__ ws_acc,
                               const float* __restrict__ ws_m,
                               const float* __restrict__ ws_l,
                               const int* __restrict__ seq_lens,
                               const int* __restrict__ start_pos,
                               TQ* __restrict__ out, int H, int KVH, int G,
                               int D, int P, int PPS, int span, int n_spans) {
  __shared__ float w[kCombineThreads];   // a chunk of spans' weights
  __shared__ float scratch[kCombineThreads / 32];
  __shared__ float4 part[kCombineThreads];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / G, g = h % G, tid = threadIdx.x;
  TQ* o = out + ((size_t)b * H + h) * D;
  const size_t base = ((size_t)b * KVH + kvh) * n_spans;
  // the first chunk's m and l go out with the window's loads
  const float m0 = tid < n_spans ? ws_m[(base + tid) * G + g] : kNegInf;
  const float l0 = tid < n_spans ? ws_l[(base + tid) * G + g] : 0.f;
  const int hi = min(seq_lens[b], PPS * P);
  const int lo = max(start_pos[b], 0);
  if (lo >= hi) {                // empty window: zeros
    for (int d = tid; d < D; d += kCombineThreads) o[d] = from_f32<TQ>(0.f);
    return;
  }
  const int s0 = lo / span, s1 = (hi - 1) / span;   // the live spans
  // M and L over the live spans, a span a thread
  float M = kNegInf;
  for (int s = tid; s <= s1; s += kCombineThreads)
    if (s >= s0)
      M = fmaxf(M, s < kCombineThreads ? m0 : ws_m[(base + s) * G + g]);
  M = block_reduce(M, scratch, true);
  float L = 0.f;
  for (int s = tid; s <= s1; s += kCombineThreads)
    if (s >= s0)
      L += s < kCombineThreads
               ? expf(m0 - M) * l0
               : expf(ws_m[(base + s) * G + g] - M) * ws_l[(base + s) * G + g];
  const float inv = 1.f / fmaxf(block_reduce(L, scratch, false), 1e-30f);
  // out = sum_s w_s acc_s / L: four dims and a group of spans a thread, so
  // that every load of a chunk is in flight at once
  const int quads = D / 4, groups = kCombineThreads / quads;
  const int dq = tid % quads, sg = tid / quads;
  const size_t stride = (size_t)G * D;   // floats between spans
  const float* acc = ws_acc + (base * G + g) * D + 4 * dq;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = s0; c0 <= s1; c0 += kCombineThreads) {
    const int n = min(kCombineThreads, s1 - c0 + 1);
    __syncthreads();             // the last chunk's weights are used
    if (tid < n)
      w[tid] = expf((c0 == 0 ? m0 : ws_m[(base + c0 + tid) * G + g]) - M);
    __syncthreads();
    if (sg < groups) {
#pragma unroll 8
      for (int k = sg; k < n; k += groups) {
        const float4 a =
            *reinterpret_cast<const float4*>(acc + (size_t)(c0 + k) * stride);
        const float wk = w[k];
        x.x = fmaf(wk, a.x, x.x); x.y = fmaf(wk, a.y, x.y);
        x.z = fmaf(wk, a.z, x.z); x.w = fmaf(wk, a.w, x.w);
      }
    }
  }
  if (sg < groups) part[tid] = x;
  __syncthreads();
  for (int q = tid; q < quads; q += kCombineThreads) {
    float4 y = part[q];
    for (int k = 1; k < groups; ++k) {
      const float4 z = part[k * quads + q];
      y.x += z.x; y.y += z.y; y.z += z.z; y.w += z.w;
    }
    o[4 * q] = from_f32<TQ>(y.x * inv);
    o[4 * q + 1] = from_f32<TQ>(y.y * inv);
    o[4 * q + 2] = from_f32<TQ>(y.z * inv);
    o[4 * q + 3] = from_f32<TQ>(y.w * inv);
  }
}

template <typename TKV, int GT>
cudaError_t launch_split(dim3 grid, size_t smem, cudaStream_t stream,
                         const void* q, int q_bf16, const void* kp,
                         const void* vp, const int* bt, const int* sl,
                         const int* sp, float* ws_acc, float* ws_m,
                         float* ws_l, int H, int KVH, int G, int D, int P,
                         int PPS, int span, int n_spans, int T, int stages,
                         float scale, float softcap) {
  // raise the dynamic shared-memory limit once per instantiation
  static cudaError_t configured = cudaFuncSetAttribute(
      paged_attention_kernel_split<TKV, GT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (configured != cudaSuccess) return configured;
  paged_attention_kernel_split<TKV, GT><<<grid, kThreads, smem, stream>>>(
      q, q_bf16, (const TKV*)kp, (const TKV*)vp, bt, sl, sp, ws_acc, ws_m,
      ws_l, H, KVH, G, D, P, PPS, span, n_spans, T, stages, scale, softcap);
  return cudaGetLastError();
}

template <typename TKV>
cudaError_t dispatch_split(int GT, dim3 grid, size_t smem, cudaStream_t s,
                           const void* q, int q_bf16, const void* kp,
                           const void* vp, const int* bt, const int* sl,
                           const int* sp, float* wa, float* wm, float* wl,
                           int H, int KVH, int G, int D, int P, int PPS,
                           int span, int n_spans, int T, int stages,
                           float scale, float softcap) {
#define PA_SPLIT(N)                                                         \
  launch_split<TKV, N>(grid, smem, s, q, q_bf16, kp, vp, bt, sl, sp, wa, wm, \
                       wl, H, KVH, G, D, P, PPS, span, n_spans, T, stages,  \
                       scale, softcap)
  switch (GT) {
    case 1: return PA_SPLIT(1);
    case 2: return PA_SPLIT(2);
    case 4: return PA_SPLIT(4);
    case 8: return PA_SPLIT(8);
    default: return PA_SPLIT(16);
  }
#undef PA_SPLIT
}

}  // namespace

// q_bf16 / kv_bf16: 1 when that operand is bfloat16, 0 when float32.
// ws: an f32 workspace of B * KVH * n_spans * G * (D + 2) floats (acc, then
// m, then l).  span, n_spans, tile and stages come from
// kernels/paged_attention.py:span_plan.  The wrapper checks 1 <= G <= 16,
// D % 8 == 0, 8 <= D <= 256, 16-byte aligned q and pools, and contiguity.
// Launches the split kernel, then the combining kernel, on `stream`;
// returns the first cudaError_t (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* kp,
                                      const void* vp, const void* bt,
                                      const void* seq_lens,
                                      const void* start_pos, void* out,
                                      void* ws, int B, int H, int KVH, int D,
                                      int P, int PPS, int q_bf16, int kv_bf16,
                                      int span, int n_spans, int tile,
                                      int stages, float scale, float softcap,
                                      void* stream) {
  if (B <= 0) return 0;
  const int G = H / KVH;
  if (KVH <= 0 || H % KVH || G < 1 || G > 16 || D % 8 || D < 8 ||
      D > 256 || P <= 0 || PPS <= 0 ||
      (tile != 16 && tile != 32 && tile != 64) || span % tile ||
      (stages != 2 && stages != 3) || (long long)span * n_spans <
      (long long)PPS * P || n_spans > 65535 || KVH > 65535)
    return (int)cudaErrorInvalidValue;
  int GT = 1;
  while (GT < G) GT *= 2;
  const int elem = kv_bf16 ? 2 : 4;
  const size_t smem = smem_bytes(GT, D, tile, stages, elem);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t n_ws = (size_t)B * KVH * n_spans * G;
  float* ws_acc = (float*)ws;
  float* ws_m = ws_acc + n_ws * D;
  float* ws_l = ws_m + n_ws;
  const dim3 grid(B, KVH, n_spans);
  const cudaError_t e =
      kv_bf16 ? dispatch_split<__nv_bfloat16>(
                    GT, grid, smem, s, q, q_bf16, kp, vp, (const int*)bt,
                    (const int*)seq_lens, (const int*)start_pos, ws_acc,
                    ws_m, ws_l, H, KVH, G, D, P, PPS, span, n_spans, tile,
                    stages, scale, softcap)
              : dispatch_split<float>(
                    GT, grid, smem, s, q, q_bf16, kp, vp, (const int*)bt,
                    (const int*)seq_lens, (const int*)start_pos, ws_acc,
                    ws_m, ws_l, H, KVH, G, D, P, PPS, span, n_spans, tile,
                    stages, scale, softcap);
  if (e != cudaSuccess) return (int)e;
  if (q_bf16)
    paged_attention_kernel_combine<__nv_bfloat16>
        <<<B * H, kCombineThreads, 0, s>>>(
        ws_acc, ws_m, ws_l, (const int*)seq_lens, (const int*)start_pos,
        (__nv_bfloat16*)out, H, KVH, G, D, P, PPS, span, n_spans);
  else
    paged_attention_kernel_combine<float><<<B * H, kCombineThreads, 0, s>>>(
        ws_acc, ws_m, ws_l, (const int*)seq_lens, (const int*)start_pos,
        (float*)out, H, KVH, G, D, P, PPS, span, n_spans);
  return (int)cudaGetLastError();
}
