// KSU floor search (paper Section 4.2, Fig. 6): for each request b, the
// largest candidate index i with valid[b, i] and keys[b, i] <= q[b], or -1
// when no valid candidate is <= the query.  Keys are big-endian u32 lanes:
// a candidate compares at the first lane that differs, as unsigned words;
// where all key_words lanes are equal it is <= the query when its length is
// <= the query's (signed int32, as the Pallas kernel compares them).
//
// Replaces the Pallas kernels repro/kernels/key_search.py: key_search
// (block mode: candidates, lengths and a valid mask as separate operands)
// and key_search_image (image mode: the candidate block is read out of
// each request's packed node-image row at static word offsets, and
// valid = i < count with the count word read as signed int32, so a count
// with its top bit set leaves no candidate).  The Pallas kernels compare a
// whole [block_b, N] tile of candidates in one vector op and reduce with a
// masked max.  Here one warp serves one request and a warp max-reduce
// gives the floor.
//
// Bound: bytes, and in practice latency.  The call must read each
// request's query and its count word (image mode) or valid mask (block
// mode), the lanes and length of each live candidate, and write one
// index: at most about 2.3 KB per request at the sorted block of the
// default geometry (N = 64, key_words = 8), so a batch of 256 moves under
// 0.6 MB, a fraction of a microsecond at the card's memory rate.  What
// sets the time is the launch and the chain of dependent memory round
// trips each warp waits on; both modes cut that chain to one.
//
// Both modes: the warp first copies everything its request needs into a
// shared-memory buffer of its own in one burst of cp.async copies
// (cp_async.cuh), lane l taking copies l, l + 32, ... of each kind.  No
// copy waits on the count, the valid mask or a compare, and there is one
// wait.  Then each lane compares its candidates (lane, lane + 32, ...)
// from shared memory with no early exit, masks them afterwards (i < count,
// or valid != 0), and the warp max-reduces.  KW is a template parameter
// at the stores' width, 8, with a generic instance for other widths.  A
// block too large for the warp's buffer is searched in chunks, a burst a
// chunk (``image_plan`` and ``block_plan`` in key_search.py set the warps
// a block and the chunk; the launchers check the block's shared memory).
// No pointer passes through shared memory, so every load keeps its
// global state space.
//
// Image mode: rows sit at a 5,092-byte stride at the default geometry, so
// only 4-byte copies are aligned.  Each candidate's lanes and length lie
// side by side at an odd stride (KW + 1) | 1, so the lanes of a warp
// reading candidates lane, lane + 32, ... hit distinct banks.  Candidates
// past the count are copied too: they are words of the request's own row,
// inside the bounds the wrapper checks.
//
// Block mode: the keys are a contiguous [B, N, KW] tensor, copied word
// by word, so one copy instruction of the warp reads 128 consecutive
// bytes of the request's block whatever its alignment.  A candidate's
// lanes, length and valid word lie side by side at an odd stride of
// words.  Loading valid[c] first and the lanes only where it is set,
// exiting at the first lane that differs, would make each warp wait on a
// chain of dependent round trips.  16-byte copies of aligned keys were
// no faster at a batch of 256 and slower where bytes bind the call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

// Either mode: the most warps (requests) a block may take, and the words
// of one warp's buffer that image_plan and block_plan (key_search.py) may
// fill: 4 warps of 8 KB stay below the 48 KB a block takes without opt-in
constexpr int kMaxWarps = 4;
constexpr int kWarpWords = 2048;

// Words between two candidates in a warp's buffer: the lanes, the
// length, and a pad to an odd count.
__host__ __device__ constexpr int cand_stride(int kw) { return (kw + 1) | 1; }

// Words of one warp's buffer: count, query length, query lanes, then
// `chunk` candidates.
__host__ __device__ constexpr int image_warp_words(int kw, int chunk) {
  return 2 + kw + chunk * cand_stride(kw);
}

// One warp per request.  KW_T > 0 fixes the key width at compile time;
// KW_T == 0 takes it from `kw_rt`.
template <int KW_T>
__global__ void key_search_image_kernel(const uint32_t* __restrict__ q,
                                        const int* __restrict__ qlen,
                                        const uint32_t* __restrict__ img,
                                        int* __restrict__ out, int B, int IW,
                                        int keys_off, int lens_off,
                                        int count_off, int n_keys, int kw_rt,
                                        int chunk) {
  extern __shared__ uint32_t smem[];
  const int KW = KW_T > 0 ? KW_T : kw_rt;
  const int ST = cand_stride(KW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;                   // uniform across the warp
  uint32_t* s = smem + warp * image_warp_words(KW, chunk);
  uint32_t* cand = s + 2 + KW;
  const uint32_t* row = img + (size_t)b * IW;

  int count = 0, ql = 0, best = -1;
  uint32_t qr[KW_T > 0 ? KW_T : 1];     // the query's lanes, KW_T > 0
  for (int i0 = 0; i0 < n_keys; i0 += chunk) {
    const int n = min(chunk, n_keys - i0);
    if (i0 == 0)                        // count, query length, query lanes
      for (int w = lane; w < 2 + KW; w += 32)
        cp_async4(s + w, w == 0   ? row + count_off
                         : w == 1 ? (const uint32_t*)qlen + b
                                  : q + (size_t)b * KW + (w - 2));
    const uint32_t* keys = row + keys_off + (size_t)i0 * KW;
    for (int w = lane; w < n * KW; w += 32)
      cp_async4(cand + (w / KW) * ST + w % KW, keys + w);
    for (int i = lane; i < n; i += 32)
      cp_async4(cand + i * ST + KW, row + lens_off + i0 + i);
    cp_async_wait_all();
    __syncwarp();
    if (i0 == 0) {
      count = (int)s[0];
      ql = (int)s[1];
      if constexpr (KW_T > 0) {
#pragma unroll
        for (int w = 0; w < KW_T; ++w) qr[w] = s[2 + w];
      }
    }
    for (int i = lane; i < n; i += 32) {
      const uint32_t* c = cand + i * ST;
      bool leq = (int)c[KW] <= ql;      // where every lane is equal
      if constexpr (KW_T > 0) {         // the first difference decides
#pragma unroll
        for (int w = KW_T - 1; w >= 0; --w)
          if (c[w] != qr[w]) leq = c[w] < qr[w];
      } else {
        for (int w = KW - 1; w >= 0; --w)
          if (c[w] != s[2 + w]) leq = c[w] < s[2 + w];
      }
      if (leq && i0 + i < count) best = i0 + i;    // indices rise
    }
    __syncwarp();                       // the buffer is read: refill it
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) out[b] = best;
}

// Block mode.  A pass stages `chunk` candidates' lanes [w0, w0 + span)
// and the query's.  A warp's buffer: the query's lanes of the pass, its
// length at word `span`, then the candidates at `block_stride` words
// apart, each its lanes of the pass, its length (word `span`) and its
// valid word (`span` + 1), padded to an odd stride so that the lanes of a
// warp reading candidates lane, lane + 32, ... hit distinct banks.
__host__ __device__ constexpr int block_stride(int span) {
  return (span + 2) | 1;
}
__host__ __device__ constexpr int block_warp_words(int span, int chunk) {
  return span + 1 + chunk * block_stride(span);
}

// One warp per request.  KW_T > 0 fixes the key width at compile time
// (a pass then holds the whole key); KW_T == 0 takes it from `kw_rt` and
// the lanes a pass from `span`.  A key wider than one pass (span < KW)
// is compared a pass of lanes at a time, the highest lanes first, each
// lane carrying its one candidate's verdict (the plan then takes at most
// 32 candidates a chunk).
template <int KW_T>
__global__ void key_search_kernel(const uint32_t* __restrict__ q,
                                  const int* __restrict__ qlen,
                                  const uint32_t* __restrict__ keys,
                                  const int* __restrict__ klens,
                                  const int* __restrict__ valid,
                                  int* __restrict__ out, int B, int N,
                                  int kw_rt, int chunk, int span) {
  extern __shared__ uint32_t smem[];
  const int KW = KW_T > 0 ? KW_T : kw_rt;
  const int SP = KW_T > 0 ? KW_T : span;
  const int ST = block_stride(SP);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;                   // uniform across the warp
  uint32_t* s = smem + warp * block_warp_words(SP, chunk);
  uint32_t* cand = s + SP + 1;
  const uint32_t* qb = q + (size_t)b * KW;
  const int* lb = klens + (size_t)b * N;
  const int* vb = valid + (size_t)b * N;

  int best = -1;
  bool carry = false;                   // a wide key's verdict so far
  for (int i0 = 0; i0 < N; i0 += chunk) {
    const int n = min(chunk, N - i0);
    const uint32_t* kc = keys + ((size_t)b * N + i0) * KW;
    for (int w0 = (KW - 1) / SP * SP; w0 >= 0; w0 -= SP) {
      const int ws = min(SP, KW - w0);  // lanes of this pass
      const bool top = w0 + SP >= KW, last = w0 == 0;
      // ---- the burst: query lanes and length, candidates' lanes, and
      // (first pass of a chunk) their lengths and valid words
      for (int w = lane; w <= ws; w += 32)
        cp_async4(s + (w < ws ? w : SP),
                  w < ws ? qb + w0 + w : (const uint32_t*)qlen + b);
      for (int w = lane; w < n * ws; w += 32) {
        const int i = w / ws, p = w % ws;
        cp_async4(cand + i * ST + p, kc + (size_t)i * KW + w0 + p);
      }
      if (top)
        for (int i = lane; i < n; i += 32) {
          cp_async4(cand + i * ST + SP, lb + i0 + i);
          cp_async4(cand + i * ST + SP + 1, vb + i0 + i);
        }
      cp_async_wait_all();
      __syncwarp();
      // ---- compares, no early exit
      const int ql = (int)s[SP];
      uint32_t qr[KW_T > 0 ? KW_T : 1];
      if constexpr (KW_T > 0) {
#pragma unroll
        for (int w = 0; w < KW_T; ++w) qr[w] = s[w];
      }
      for (int i = lane; i < n; i += 32) {
        const uint32_t* c = cand + i * ST;
        const int ok = (int)c[SP + 1];  // the valid word
        // where every lane is equal: the length decides
        bool leq = top ? (int)c[SP] <= ql : carry;
        if constexpr (KW_T > 0) {       // the first difference decides
#pragma unroll
          for (int w = KW_T - 1; w >= 0; --w)
            if (c[w] != qr[w]) leq = c[w] < qr[w];
        } else {
          for (int w = ws - 1; w >= 0; --w)
            if (c[w] != s[w]) leq = c[w] < s[w];
        }
        if (!last) carry = leq;         // one candidate a lane (plan)
        else if (leq && ok != 0) best = i0 + i;    // indices rise
      }
      __syncwarp();                     // the buffer is read: refill it
    }
  }
  best = __reduce_max_sync(0xffffffffu, best);
  if (lane == 0) out[b] = best;
}

template <int KW_T>
void launch_block(const void* q, const void* qlen, const void* keys,
                  const void* klens, const void* valid, void* out, int B,
                  int N, int KW, int warps, int chunk, int span,
                  cudaStream_t st) {
  const size_t smem = sizeof(uint32_t) * warps * block_warp_words(span, chunk);
  key_search_kernel<KW_T><<<(B + warps - 1) / warps, 32 * warps, smem,
                            st>>>(
      (const uint32_t*)q, (const int*)qlen, (const uint32_t*)keys,
      (const int*)klens, (const int*)valid, (int*)out, B, N, KW, chunk,
      span);
}

}  // namespace

extern "C" int key_search_launch(const void* q, const void* qlen,
                                 const void* keys, const void* klens,
                                 const void* valid, void* out, int B, int N,
                                 int KW, int warps, int chunk, int span,
                                 void* stream) {
  if (B <= 0) return 0;
  if (KW < 1 || N < 1 || chunk < 1 || warps < 1 || warps > kMaxWarps ||
      span < 1 || span > KW || (span < KW && chunk > 32) ||
      block_warp_words(span, chunk) > kWarpWords)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (KW == 8 && span == 8)
    launch_block<8>(q, qlen, keys, klens, valid, out, B, N, KW, warps,
                    chunk, span, st);
  else
    launch_block<0>(q, qlen, keys, klens, valid, out, B, N, KW, warps,
                    chunk, span, st);
  return (int)cudaGetLastError();
}

extern "C" int key_search_image_launch(const void* q, const void* qlen,
                                       const void* img, void* out, int B,
                                       int IW, int keys_off, int lens_off,
                                       int count_off, int n_keys, int KW,
                                       int warps, int chunk, void* stream) {
  if (B <= 0) return 0;
  if (KW < 1 || chunk < 1 || n_keys < 1 || warps < 1 ||
      warps > kMaxWarps || image_warp_words(KW, chunk) > kWarpWords)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(uint32_t) * warps * image_warp_words(KW, chunk);
  const int blocks = (B + warps - 1) / warps;
  const cudaStream_t st = (cudaStream_t)stream;
  if (KW == 8)
    key_search_image_kernel<8><<<blocks, 32 * warps, smem, st>>>(
        (const uint32_t*)q, (const int*)qlen, (const uint32_t*)img,
        (int*)out, B, IW, keys_off, lens_off, count_off, n_keys, KW, chunk);
  else
    key_search_image_kernel<0><<<blocks, 32 * warps, smem, st>>>(
        (const uint32_t*)q, (const int*)qlen, (const uint32_t*)img,
        (int*)out, B, IW, keys_off, lens_off, count_off, n_keys, KW, chunk);
  return (int)cudaGetLastError();
}
