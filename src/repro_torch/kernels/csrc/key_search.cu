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
// masked max.  Here one warp serves one request: the 32 lanes stride over
// the N candidates (8 shortcuts or 64 sorted items at the default
// geometry; any N works), each lane keeps the largest index it found <=
// the query, and a warp max-reduce gives the floor.
//
// Bound: bytes.  The call must read each request's query and its count
// word (image mode) or valid mask (block mode), the lanes and length of
// each live candidate, and write one index: at most about 2.3 KB per
// request at the sorted block of the default geometry (N = 64,
// key_words = 8), less in a part-full node, so a batch of 256 moves under
// 0.6 MB, a fraction of a microsecond at the card's memory rate; the
// launch sets the time.  Neither kernel loads a dead candidate.  A lane
// reads its candidate's lanes in order from a 32-byte stride, so a warp
// touches one contiguous block per step.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void key_search_image_kernel(const uint32_t* __restrict__ q,
                                        const int* __restrict__ qlen,
                                        const uint32_t* __restrict__ img,
                                        int* __restrict__ out, int B, int IW,
                                        int keys_off, int lens_off,
                                        int count_off, int n_keys, int KW) {
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;                   // uniform across the warp
  const uint32_t* row = img + (size_t)b * IW;
  const uint32_t* qb = q + (size_t)b * KW;
  const int ql = qlen[b];
  const int count = (int)row[count_off];
  int best = -1;
  for (int i = lane; i < n_keys && i < count; i += 32) {
    if (key_leq(row + keys_off + (size_t)i * KW, (int)row[lens_off + i], qb,
                ql, KW))
      best = i;
  }
  best = warp_max(best);
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
                                       void* stream) {
  if (B <= 0) return 0;
  key_search_image_kernel<<<blocks_for(B), 32 * kWarpsPerBlock, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t*)q, (const int*)qlen, (const uint32_t*)img, (int*)out,
      B, IW, keys_off, lens_off, count_off, n_keys, KW);
  return (int)cudaGetLastError();
}
