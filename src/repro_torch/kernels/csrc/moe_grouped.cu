// Grouped expert FFN for the MoE layers of prefill: each token goes through
// its top-k experts only, as the reference's ragged path does
// (repro/models/moe.py:moe_ragged, jax.lax.ragged_dot), and not through all
// E experts as the dense path does.  No Pallas kernel of the reference is
// replaced: the reference leaves its ragged products to XLA.  This kernel
// was added because the dense MoE computes E / k times the products a
// token needs (8x in olmoe-1b-7b, 64 experts top 8; 8x in jamba-v0.1-52b,
// 16 top 2) and most of prefill's device time went there (PERF.md).
//
// One layer is five launches on the caller's stream, none of which reads
// anything back to the host:
//
//   moe_dispatch_kernel, one block of 1,024 threads.  The T * k (token,
//     slot) pairs are ordered stably by expert.  The block stages the
//     expert ids in shared memory; each of its 32 warps takes a contiguous
//     segment of pairs, counts its experts 32 pairs at a time
//     (__match_any_sync groups the lanes of one expert), the counts are
//     scanned over the warps and then over the experts, and a second walk
//     gives every pair its row in the sorted order: pos[t * k + j].  meta
//     gets each expert's first row (E + 1 entries) and its first row tile
//     (E + 1 entries, tiles of `bm` rows).
//   moe_gather_kernel, a block a token: x's row t copied to its k sorted
//     rows of xs [T * k, d].
//   grouped_gemm_wgmma<0> (gate and up) and <1> (down), bf16 at tile-exact
//     widths.  A block computes a 128-row tile of one expert's sorted rows
//     against a 256-column tile of that expert's weights:
//       * the grid is sized from the bound ceil(T * k / 128) + E row tiles
//         times the column tiles; a block finds its (expert, column tile,
//         row tile) from meta, expert-major and then column-major, so the
//         row tiles of one expert's column tile run side by side and read
//         that weight tile from L2 once; blocks past the last tile exit;
//       * warp-specialised: one producer thread keeps a ring of 4 stages
//         of 16 KB of A (128 rows x 64 of K, TMA from xs or h, K-major,
//         128-byte swizzle; rows past the expert's last are computed and
//         dropped, rows past T * k are zeros) and 32 KB of B (64 of K x
//         four 64-column chunks, TMA from the [E, K, N] weights, N-major,
//         128-byte swizzle) in flight, full/empty mbarriers a stage;
//       * two consumer warpgroups each issue wgmma.m64n256k16 (bf16 in, f32
//         accumulators in registers, B transposed) over their 64 rows;
//       * gate/up loads the column chunks (gate n, gate n + 64, up n, up n +
//         64), so one thread holds g and u of the same element; the
//         epilogue rounds as the dense path does: g and u to bf16, SiLU in
//         f32, to bf16, times u in f32, to bf16; it writes h [T * k, f].
//         Down writes y [T * k, d] in bf16.
//   grouped_gemm_simt<T, mode>, the same products and rounding for f32, or
//     for widths that are not whole tiles (the smoke configurations): 64 x
//     64 tiles in f32 FMAs.
//   moe_combine_kernel, a block a token: out[t] = sum over j = 0..k-1 of
//     gate[t, j] * f32(y[pos[t * k + j]]), in f32 in slot order, with no
//     atomics, then rounded to the output type.
//
// Bound: the larger of the products at 989 TFLOP/s (6 * T * k * d * f
// FLOPs) and the bytes at 3.35 TB/s: the touched experts' weights once,
// and x, h and y once each.  At olmoe-1b-7b's widths and T = 1,536
// prompt tokens: 155 GFLOP (0.156 ms) against 0.89 GB (0.265 ms); at
// jamba-v0.1-52b's, T = 2,048: 1.44 TFLOP (1.46 ms) against 5.80 GB
// (1.73 ms): both near the ridge.  The design reads each weight tile from
// device memory once (expert-major order), keeps TMA loads in flight while
// the tensor cores run, and keeps the accumulators in registers; what it
// does not do is overlap a tile's epilogue with the next tile's loads
// (one tile a block, not persistent), and a group that is not a multiple
// of 128 rows computes the rest of its last tile for nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// silu(g) * u with the dense path's rounding: g and u in the model type,
// silu in f32 rounded to it, the product in f32 rounded to it
template <typename T>
__device__ __forceinline__ T swiglu(float g, float u) {
  const float gt = to_f(from_f<T>(g));
  const float ut = to_f(from_f<T>(u));
  const float s = to_f(from_f<T>(gt / (1.0f + expf(-gt))));
  return from_f<T>(s * ut);
}

// ---------------------------------------------------------------- dispatch
constexpr int kDispatchThreads = 1024;
constexpr int kMaxExperts = 256;

__global__ void __launch_bounds__(kDispatchThreads)
    moe_dispatch_kernel(const int64_t* __restrict__ ids, int* __restrict__ pos,
                        int* __restrict__ meta, int n, int E, int bm) {
  extern __shared__ uint8_t sid[];                 // the n expert ids
  __shared__ int cnt[32][kMaxExperts];             // per warp and expert
  __shared__ int first[kMaxExperts];               // totals, then offsets
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  for (int i = tid; i < n; i += kDispatchThreads)
    sid[i] = static_cast<uint8_t>(ids[i]);
  for (int e = lane; e < E; e += 32) cnt[w][e] = 0;
  __syncthreads();
  // warp w's pairs: [lo, hi), whole chunks of 32 (every lane runs the
  // same trips, so the warp-wide intrinsics see all 32 lanes)
  const int seg = (n + kDispatchThreads - 1) / kDispatchThreads * 32;
  const int lo = w * seg, hi = min(n, lo + seg);
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const int e = i < hi ? sid[i] : -1;
    const unsigned m = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && lane == __ffs(m) - 1) cnt[w][e] += __popc(m);
    __syncwarp();
  }
  __syncthreads();
  // each expert's count over the warps before w, and its total
  for (int e = w; e < E; e += 32) {
    const int v = cnt[lane][e];
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    cnt[lane][e] = incl - v;
    if (lane == 31) first[e] = incl;
  }
  __syncthreads();
  // the experts' first rows and first row tiles
  if (w == 0) {
    int rows = 0, tiles = 0;
    for (int b = 0; b < E; b += 32) {
      const int e = b + lane;
      const int c = e < E ? first[e] : 0;
      const int t = (c + bm - 1) / bm;
      int ic = c, it = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int sc = __shfl_up_sync(0xffffffffu, ic, o);
        const int st = __shfl_up_sync(0xffffffffu, it, o);
        if (lane >= o) {
          ic += sc;
          it += st;
        }
      }
      if (e < E) {
        first[e] = rows + ic - c;
        meta[e] = rows + ic - c;
        meta[E + 1 + e] = tiles + it - t;
      }
      rows += __shfl_sync(0xffffffffu, ic, 31);
      tiles += __shfl_sync(0xffffffffu, it, 31);
    }
    if (lane == 0) {
      meta[E] = rows;
      meta[2 * E + 1] = tiles;
    }
  }
  __syncthreads();
  for (int b = lo; b < hi; b += 32) {
    const int i = b + lane;
    const int e = i < hi ? sid[i] : -1;
    const unsigned m = __match_any_sync(0xffffffffu, e);
    if (e >= 0) pos[i] = first[e] + cnt[w][e] + __popc(m & ((1u << lane) - 1));
    __syncwarp();
    if (e >= 0 && lane == __ffs(m) - 1) cnt[w][e] += __popc(m);
    __syncwarp();
  }
}

// ------------------------------------------------------ gather and combine
template <typename T>
__global__ void moe_gather_kernel(const T* __restrict__ x,
                                  const int* __restrict__ pos,
                                  T* __restrict__ xs, int k, int d) {
  const int t = blockIdx.x;
  const int nv = d * static_cast<int>(sizeof(T)) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(t) * d);
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    const uint4 v = src[c];
    for (int j = 0; j < k; ++j) {
      const size_t row = static_cast<size_t>(pos[t * k + j]);
      reinterpret_cast<uint4*>(xs + row * d)[c] = v;
    }
  }
}

template <typename T>
__global__ void moe_combine_kernel(const T* __restrict__ y,
                                   const int* __restrict__ pos,
                                   const float* __restrict__ gates,
                                   T* __restrict__ out, int k, int d) {
  constexpr int V = 16 / sizeof(T);
  const int t = blockIdx.x;
  const int nv = d / V;
  for (int c = threadIdx.x; c < nv; c += blockDim.x) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    for (int j = 0; j < k; ++j) {
      const float g = gates[t * k + j];
      const size_t row = static_cast<size_t>(pos[t * k + j]);
      const uint4 raw = reinterpret_cast<const uint4*>(y + row * d)[c];
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i)   // no FMA: the plain version's mul, add
        acc[i] = __fadd_rn(acc[i], __fmul_rn(g, to_f(v[i])));
    }
    uint4 res;
    T* o = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = from_f<T>(acc[i]);
    reinterpret_cast<uint4*>(out + static_cast<size_t>(t) * d)[c] = res;
  }
}

// A block's (expert, column tile, row tile): blocks run expert-major, then
// column tile, then row tile.  Returns false past the last tile.
__device__ __forceinline__ bool find_tile(const int* __restrict__ meta, int E,
                                          int n_ct, int& e, int& ct,
                                          int& rt) {
  const int* tile_off = meta + E + 1;
  const long long L = blockIdx.x;
  if (L >= static_cast<long long>(tile_off[E]) * n_ct) return false;
  int lo = 0, hi = E - 1;     // the last expert whose first block <= L
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (static_cast<long long>(tile_off[mid]) * n_ct <= L)
      lo = mid;
    else
      hi = mid - 1;
  }
  e = lo;
  const int nt = tile_off[e + 1] - tile_off[e];
  const int local = static_cast<int>(L - static_cast<long long>(tile_off[e]) * n_ct);
  ct = local / nt;
  rt = local % nt;
  return true;
}

// ------------------------------------------------------- wgmma grouped GEMM
constexpr int kBM = 128, kBK = 64, kBN = 256, kStages = 4;
constexpr int kABytes = kBM * kBK * 2;              // 16 KB
constexpr int kBChunk = kBK * 64 * 2;               // 8 KB: 64 of K x 64 cols
constexpr int kStageBytes = kABytes + kBN / 64 * kBChunk;  // 48 KB
constexpr int kWgmmaSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
constexpr int kWgmmaThreads = 384;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// a shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// d[64 x 256] += a[64 x 16] (K-major) * b[16 x 256] (N-major), bf16 in, f32
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// MODE 0: h = swiglu(a . b0[e], a . b1[e]), 128 columns of f a block;
// MODE 1: y = a . b0[e], 256 columns of d a block.  a: [rows, K] bf16;
// b0, b1: [E, K, N] bf16; out: [rows, n_out] bf16.
template <int MODE>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    grouped_gemm_wgmma(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b0,
                       const __grid_constant__ CUtensorMap map_b1,
                       const int* __restrict__ meta, bf16* __restrict__ out,
                       int E, int K, int n_out, int n_ct) {
  int e, ct, rt;
  if (!find_tile(meta, E, n_ct, e, ct, rt)) return;
  const int row0 = meta[e] + rt * kBM;
  const int rows = min(kBM, meta[e + 1] - row0);
  const int nk = K / kBK;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + kStages * kStageBytes;   // kStages mbarriers
  const uint32_t empty = full + kStages * 8;            // kStages mbarriers
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);    // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {            // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t st = base + s * kStageBytes;
        mbar_expect_tx(bar, kStageBytes);
        tma_2d(st, &map_a, bar, it * kBK, row0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const CUtensorMap* m = (MODE == 0 && c >= 2) ? &map_b1 : &map_b0;
          const int col = MODE == 0 ? ct * 128 + (c & 1) * 64 : ct * 256 + c * 64;
          tma_3d(st + kABytes + c * kBChunk, m, bar, col, it * kBK, e);
        }
      }
    }
  } else {                            // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int lane = threadIdx.x & 31;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t a = base + s * kStageBytes + wg * (kABytes / 2);
      const uint32_t b = base + s * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64n256k16(acc, gmma_desc(a + kk * 32, 16, 1024),
                         gmma_desc(b + kk * 2048, kBChunk, 1024));
      wgmma_commit();
      wgmma_wait0();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // accumulator layout: row 16 * warp + lane / 4 (+ 8 for acc[4j + 2,
    // 3]), column 8 j + 2 (lane % 4) (+ 1), j = 0..31
    const int r0 = wg * 64 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      if (r < rows) {
        bf16* o = out + static_cast<size_t>(row0 + r) * n_out;
        if (MODE == 0) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            __nv_bfloat162 v;
            v.x = swiglu<bf16>(acc[4 * j + 2 * i], acc[4 * (j + 16) + 2 * i]);
            v.y = swiglu<bf16>(acc[4 * j + 2 * i + 1],
                               acc[4 * (j + 16) + 2 * i + 1]);
            *reinterpret_cast<__nv_bfloat162*>(o + ct * 128 + 8 * j + c0) = v;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            __nv_bfloat162 v;
            v.x = __float2bfloat16(acc[4 * j + 2 * i]);
            v.y = __float2bfloat16(acc[4 * j + 2 * i + 1]);
            *reinterpret_cast<__nv_bfloat162*>(o + ct * 256 + 8 * j + c0) = v;
          }
        }
      }
    }
  }
}

// --------------------------------------------------------- SIMT grouped GEMM
constexpr int kSBM = 64, kSBN = 64, kSBK = 16, kSimtThreads = 256;

// a: [rows, K]; b0, b1: [E, K, N]; out: [rows, N]; MODE as above
template <typename T, int MODE>
__global__ void __launch_bounds__(kSimtThreads)
    grouped_gemm_simt(const T* __restrict__ a, const T* __restrict__ b0,
                      const T* __restrict__ b1, const int* __restrict__ meta,
                      T* __restrict__ out, int E, int K, int N, int n_ct) {
  int e, ct, rt;
  if (!find_tile(meta, E, n_ct, e, ct, rt)) return;
  const int row0 = meta[e] + rt * kSBM;
  const int rows = min(kSBM, meta[e + 1] - row0);
  const int col0 = ct * kSBN;
  __shared__ float as[kSBK][kSBM];
  __shared__ float bs[2][kSBK][kSBN];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[2][4][4] = {};
  const size_t wbase = static_cast<size_t>(e) * K * N;
  for (int k0 = 0; k0 < K; k0 += kSBK) {
    for (int idx = threadIdx.x; idx < kSBK * kSBM; idx += kSimtThreads) {
      const int r = idx / kSBK, kk = idx % kSBK;
      as[kk][r] = (r < rows && k0 + kk < K)
                      ? to_f(a[static_cast<size_t>(row0 + r) * K + k0 + kk])
                      : 0.0f;
      const int kb = idx / kSBN, c = idx % kSBN;
      const bool in = k0 + kb < K && col0 + c < N;
      const size_t off = wbase + static_cast<size_t>(k0 + kb) * N + col0 + c;
      bs[0][kb][c] = in ? to_f(b0[off]) : 0.0f;
      if (MODE == 0) bs[1][kb][c] = in ? to_f(b1[off]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSBK; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = as[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[0][i][j] = fmaf(av, bs[0][kk][tx * 4 + j], acc[0][i][j]);
          if (MODE == 0)
            acc[1][i][j] = fmaf(av, bs[1][kk][tx * 4 + j], acc[1][i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c >= N) continue;
      out[static_cast<size_t>(row0 + r) * N + c] =
          MODE == 0 ? swiglu<T>(acc[0][i][j], acc[1][i][j])
                    : from_f<T>(acc[0][i][j]);
    }
  }
}

// ------------------------------------------------------------ host helpers
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int kEncodeFailed = 10000;   // + the driver's CUresult

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rows x cols bf16, row-major, boxes of box_rows x 64
int map_2d(CUtensorMap* m, const void* p, int rows, int cols, int box_rows) {
  EncodeTiled f = encode_fn();
  if (!f) return kEncodeFailed;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                       const_cast<void*>(p), dims, strides, box, elem,
                       CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// [E, K, N] bf16, boxes of 64 of K x 64 of N
int map_3d(CUtensorMap* m, const void* p, int E, int K, int N) {
  EncodeTiled f = encode_fn();
  if (!f) return kEncodeFailed;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                 static_cast<cuuint64_t>(K) * N * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                       const_cast<void*>(p), dims, strides, box, elem,
                       CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

// A kernel's dynamic shared memory above the default is allowed per
// device: once on each device a launch meets (set[] keeps which).
constexpr int kMaxDevices = 64;
int allow_smem(const void* fn, int bytes, bool (&set)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && set[dev]) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) set[dev] = true;
  return 0;
}

template <int MODE>
int launch_wgmma(const void* a, const void* b0, const void* b1,
                 const int* meta, void* out, int rows, int E, int K, int N,
                 cudaStream_t st) {
  static bool set[kMaxDevices] = {};
  int err = allow_smem(reinterpret_cast<const void*>(grouped_gemm_wgmma<MODE>),
                       kWgmmaSmem, set);
  if (err) return err;
  CUtensorMap ma, mb0, mb1;
  err = map_2d(&ma, a, rows, K, kBM);
  if (!err) err = map_3d(&mb0, b0, E, K, N);
  if (!err) err = map_3d(&mb1, b1, E, K, N);
  if (err) return err;
  const int n_ct = MODE == 0 ? N / 128 : N / 256;
  const long long blocks =
      static_cast<long long>((rows + kBM - 1) / kBM + E) * n_ct;
  grouped_gemm_wgmma<MODE><<<static_cast<unsigned>(blocks), kWgmmaThreads,
                             kWgmmaSmem, st>>>(
      ma, mb0, mb1, meta, static_cast<bf16*>(out), E, K, N, n_ct);
  return cudaGetLastError();
}

template <typename T, int MODE>
int launch_simt(const void* a, const void* b0, const void* b1,
                const int* meta, void* out, int rows, int E, int K, int N,
                cudaStream_t st) {
  const int n_ct = (N + kSBN - 1) / kSBN;
  const long long blocks =
      static_cast<long long>((rows + kSBM - 1) / kSBM + E) * n_ct;
  grouped_gemm_simt<T, MODE><<<static_cast<unsigned>(blocks), kSimtThreads,
                               0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b0),
      static_cast<const T*>(b1), meta, static_cast<T*>(out), E, K, N, n_ct);
  return cudaGetLastError();
}

int threads_for(int nv) { return nv < 32 ? 32 : (nv > 1024 ? 1024 : nv); }

}  // namespace

extern "C" {

// the row tile the wgmma kernels take, and the SIMT kernels'
int moe_grouped_tile_rows(int wgmma) { return wgmma ? kBM : kSBM; }

// ids: [n] int64 expert ids, pair i = token i / k, slot i % k; pos: [n]
// int32; meta: [2 (E + 1)] int32.  n * 1 byte of shared memory.
int moe_dispatch_launch(const void* ids, void* pos, void* meta, int n, int E,
                        int bm, void* stream) {
  static bool set[kMaxDevices] = {};
  const int err = allow_smem(reinterpret_cast<const void*>(moe_dispatch_kernel),
                             232448 - 36 * 1024, set);
  if (err) return err;
  moe_dispatch_kernel<<<1, kDispatchThreads, n,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ids), static_cast<int*>(pos),
      static_cast<int*>(meta), n, E, bm);
  return cudaGetLastError();
}

int moe_gather_launch(const void* x, const void* pos, void* xs, int T, int k,
                      int d, int bf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = d * (bf ? 2 : 4) / 16;
  if (bf)
    moe_gather_kernel<bf16><<<T, threads_for(nv), 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const int*>(pos),
        static_cast<bf16*>(xs), k, d);
  else
    moe_gather_kernel<float><<<T, threads_for(nv), 0, st>>>(
        static_cast<const float*>(x), static_cast<const int*>(pos),
        static_cast<float*>(xs), k, d);
  return cudaGetLastError();
}

// a: [rows, K]; b0, b1: [E, K, N]; out: [rows, N]; mode 0 gate/up (N = f),
// 1 down (b1 unused, N = d)
int moe_grouped_gemm_launch(const void* a, const void* b0, const void* b1,
                            const void* meta, void* out, int rows, int E,
                            int K, int N, int mode, int bf, int wgmma,
                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(meta);
  if (wgmma)
    return mode == 0 ? launch_wgmma<0>(a, b0, b1, m, out, rows, E, K, N, st)
                     : launch_wgmma<1>(a, b0, b0, m, out, rows, E, K, N, st);
  if (bf)
    return mode == 0
               ? launch_simt<bf16, 0>(a, b0, b1, m, out, rows, E, K, N, st)
               : launch_simt<bf16, 1>(a, b0, b0, m, out, rows, E, K, N, st);
  return mode == 0
             ? launch_simt<float, 0>(a, b0, b1, m, out, rows, E, K, N, st)
             : launch_simt<float, 1>(a, b0, b0, m, out, rows, E, K, N, st);
}

int moe_combine_launch(const void* y, const void* pos, const void* gates,
                       void* out, int T, int k, int d, int bf, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nv = d * (bf ? 2 : 4) / 16;
  if (bf)
    moe_combine_kernel<bf16><<<T, threads_for(nv), 0, st>>>(
        static_cast<const bf16*>(y), static_cast<const int*>(pos),
        static_cast<const float*>(gates), static_cast<bf16*>(out), k, d);
  else
    moe_combine_kernel<float><<<T, threads_for(nv), 0, st>>>(
        static_cast<const float*>(y), static_cast<const int*>(pos),
        static_cast<const float*>(gates), static_cast<float*>(out), k, d);
  return cudaGetLastError();
}

}  // extern "C"
