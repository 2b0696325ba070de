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
// Block mode: the 32 lanes stride over the N candidates, each lane keeps
// the largest index it found <= the query; the valid mask gates each
// candidate's loads.
//
// Image mode: the warp first copies everything its request needs into
// shared memory in one burst of 4-byte cp.async copies (cp_async.cuh),
// lane l taking words l, l + 32, ...: the count word, the query's length
// and lanes, and the n_keys candidates' lanes and lengths, each
// candidate's lanes and length side by side at an odd stride
// (KW + 1) | 1, so the lanes of a warp reading candidates lane,
// lane + 32, ... hit distinct banks.  No load waits on the count and
// there is one wait.  Then each lane compares its candidates from shared
// memory with no early exit (KW is a template parameter at the stores'
// width, 8, and a runtime value otherwise), masks them with i < count
// after the compares, and the warp max-reduces.  A block that outgrows
// the warp's buffer is searched in chunks (``image_plan`` in
// key_search.py sets the warps a block and the chunk; the launcher
// checks the block's shared memory).  Candidates past the count are
// copied too: they are words of the request's own row, inside the bounds
// the wrapper checks.
//
// Bound: bytes.  The call must read each request's query and its count
// word (image mode) or valid mask (block mode), the lanes and length of
// each live candidate, and write one index: at most about 2.3 KB per
// request at the sorted block of the default geometry (N = 64,
// key_words = 8), less in a part-full node, so a batch of 256 moves under
// 0.6 MB, a fraction of a microsecond at the card's memory rate; the
// launch and one memory round trip set the time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

// candidate (lanes k, length klen) <= query (lanes q, length qlen)
__device__ __forceinline__ bool key_leq(const uint32_t* __restrict__ k,
                                        int klen,
                                        const uint32_t* __restrict__ q,
                                        int qlen, int kw) {
  for (int w = 0; w < kw; ++w) {
    const uint32_t a = k[w], b = q[w];
    if (a != b) return a < b;
  }
  return klen <= qlen;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int s = 16; s > 0; s >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

__global__ void key_search_kernel(const uint32_t* __restrict__ q,
                                  const int* __restrict__ qlen,
                                  const uint32_t* __restrict__ keys,
                                  const int* __restrict__ klens,
                                  const int* __restrict__ valid,
                                  int* __restrict__ out, int B, int N,
                                  int KW) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;                   // uniform across the warp
  const uint32_t* qb = q + (size_t)b * KW;
  const int ql = qlen[b];
  int best = -1;                        // a lane's indices rise: last wins
  for (int i = lane; i < N; i += 32) {
    const size_t c = (size_t)b * N + i;
    if (valid[c] != 0 && key_leq(keys + c * KW, klens[c], qb, ql, KW))
      best = i;
  }
  best = warp_max(best);
  if (lane == 0) out[b] = best;
}

// image mode: the most warps (requests) a block may take, and the words
// of one warp's buffer that image_plan (key_search.py) may fill: 4 warps
// of 8 KB stay below the 48 KB a block takes without opt-in
constexpr int kMaxImageWarps = 4;
constexpr int kImageWarpWords = 2048;

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

int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" int key_search_launch(const void* q, const void* qlen,
                                 const void* keys, const void* klens,
                                 const void* valid, void* out, int B, int N,
                                 int KW, void* stream) {
  if (B <= 0) return 0;
  key_search_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0,
                      (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const int*)qlen, (const uint32_t*)keys,
      (const int*)klens, (const int*)valid, (int*)out, B, N, KW);
  return (int)cudaGetLastError();
}

extern "C" int key_search_image_launch(const void* q, const void* qlen,
                                       const void* img, void* out, int B,
                                       int IW, int keys_off, int lens_off,
                                       int count_off, int n_keys, int KW,
                                       int warps, int chunk, void* stream) {
  if (B <= 0) return 0;
  if (KW < 1 || chunk < 1 || n_keys < 1 || warps < 1 ||
      warps > kMaxImageWarps ||
      image_warp_words(KW, chunk) > kImageWarpWords)
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
