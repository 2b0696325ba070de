// The delta sync's dirty-row copy, shared by row_scatter.cu (the packed
// image: one field of IW words) and multi_scatter.cu (the legacy layout:
// one tensor per node field, 24 fields of 1 to 512 words at the default
// geometry).  Both copy, for every dirty row i and every word of its
// FLATTENED row (the fields concatenated in schema order, W words):
//
//   dst[f][rows[i] * W_f + j] = upd[f][i * W_f + j]
//
// Bound: bytes.  The call must read each distinct dirty row's update once,
// write it once and read the D row indices: (2 * d * W + D) * 4 bytes over
// the card's memory rate (d distinct rows of the D; the store pads a delta
// to a power of two by repeating its last row).  A row is 1273 words at
// the default geometry, a 5092-byte stride, so a packed row starts only
// 4-byte aligned: 16-byte vectors and TMA (which need 16-byte addresses
// and strides) do not fit, while a warp's 32 neighbouring 4-byte words
// already move whole 128-byte lines.  What sets the time is the number of
// dependent memory round trips a block makes and the bytes in flight.
// Measured (chip_smoke.py, PERF.md): a launch that copies one row of the
// 1,024 takes about half the time of the whole delta, so the fixed chain
// (launch, the row index's round trip, the row's) weighs as much as the
// bytes; and with the L2 full of dirty lines, as the image clone before
// every apply leaves it, each line the copy allocates writes one back.
//
// The design (the plan comes from delta_scatter.scatter_plan):
// - One block copies one row; its T threads cover the W flattened words
//   in chunks of K * T words: thread t takes words c * K * T + k * T + t
//   for k < K, so neighbouring threads move neighbouring words.
// - Each thread issues ALL K loads of a chunk, then its K stores, so a
//   block waits about one memory round trip for its row (after the one
//   for its row index), not one per field or loop step.  K is a template
//   parameter and the K words live in registers; a row wider than K * T
//   (8 * 256 words) takes more chunks, each loading before it stores.
// - Bytes in flight: at the default geometry K = 8 and T = 160 cover a
//   row in one chunk; a delta of D = 1,024 rows is 1,024 blocks, at most 8
//   a streaming multiprocessor (1,280 of its 2,048 threads; 40 registers
//   a thread), one wave on the H100's 132.  So each SM has its blocks'
//   rows, about 35-40 KB (7-8 rows of 5,092 B), in flight at once: more
//   than the ~16-20 KB Little's law asks per SM at 3.35 TB/s.
// - The row index is loaded first; while it travels, the field pointers
//   and the prefix offsets of the widths are staged in shared memory,
//   spread over the block's warps (a warp reads the parameter bank at one
//   address per lane in turn, so one warp reading all 73 entries of the
//   legacy table would serialise them).  A word finds its field by a
//   branch-free binary search of the staged offsets.  Pointers read from
//   shared memory lose their state space, so each load and store asserts
//   __isGlobal: without it nvcc emits generic LD/ST and 60 registers at
//   K = 8 (40 with it), 6 blocks an SM, and a delta of 1,024 rows takes
//   two waves (PERF.md).
// - A row equal to its predecessor in `rows` is skipped, loads and stores:
//   exact under the contract that repeated rows carry identical data
//   (the first of a run writes it).  This saves the store's pad repeats.
// - Negative rows wrap Python-style.  The wrapper raises on a row outside
//   [-S, S) before it launches; the kernel still skips such a row so that
//   no launch writes outside a field.  Any 4-byte element type copies the
//   same way.

#pragma once

#include <climits>
#include <type_traits>
#include <cuda_runtime.h>

namespace scatter {

constexpr int kMaxFields = 32;    // delta_scatter.MAX_FIELDS
constexpr int kMaxThreads = 256;  // delta_scatter.MAX_THREADS

// By value as a kernel parameter (about 650 B): the field pointers and
// the prefix offsets of their widths, off[nf] = W.
struct FlatTable {
  int* dst[kMaxFields];
  const int* upd[kMaxFields];
  int off[kMaxFields + 1];
  int nf;
};

__device__ __forceinline__ int wrap_row(int r, int S) {
  if (r < 0) r += S;
  return (r < 0 || r >= S) ? -1 : r;
}

// The copy of one block: dirty row i = blockIdx.x (the grid is D blocks).
template <int K>
__device__ __forceinline__ void copy_row(const FlatTable& t, int S,
                                         const int* __restrict__ rows) {
  __shared__ int* s_dst[kMaxFields];
  __shared__ const int* s_upd[kMaxFields];
  __shared__ int s_off[kMaxFields + 1];   // INT_MAX past off[nf]
  __shared__ int s_row;                   // target row, -1: skip the row
  const int tid = threadIdx.x, T = blockDim.x, nf = t.nf;
  const int W = t.off[nf];
  const long long i = blockIdx.x;
  // the row index first: its round trip hides the table's staging
  if (tid == 0) {
    int r = wrap_row(rows[i], S);
    if (i > 0 && wrap_row(rows[i - 1], S) == r) r = -1;   // a repeat
    s_row = r;
  }
  // the table's 3 * nf + 1 live entries, a few to each warp
  const int warps = T >> 5;
  for (int e = (tid & 31) * warps + (tid >> 5); e <= 3 * nf; e += T) {
    if (e < nf) s_dst[e] = t.dst[e];
    else if (e < 2 * nf) s_upd[e - nf] = t.upd[e - nf];
    else s_off[e - 2 * nf] = t.off[e - 2 * nf];
  }
  if (tid > nf && tid <= kMaxFields) s_off[tid] = INT_MAX;
  __syncthreads();
  const int r = s_row;
  if (r < 0) return;

  for (int base = 0; base < W; base += K * T) {
    int v[K];
    int* d[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = 0;
      d[k] = nullptr;
      const int w = base + k * T + tid;   // the word within the row
      if (w < W) {
        int f = 0;                        // largest f with off[f] <= w
        if (nf > 1) {
#pragma unroll
          for (int s = kMaxFields / 2; s > 0; s >>= 1)
            if (s_off[f + s] <= w) f += s;
        }
        const int j = w - s_off[f];
        const long long wf = s_off[f + 1] - s_off[f];
        const int* src = s_upd[f] + i * wf + j;
        __builtin_assume(__isGlobal(src));
        v[k] = *src;
        d[k] = s_dst[f] + (long long)r * wf + j;
        __builtin_assume(__isGlobal(d[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (d[k] != nullptr) *d[k] = v[k];
  }
}

// Check the plan and launch the kernel instance of k (delta_scatter.
// K_CHOICES):
// ``launch(std::integral_constant<int, K>)`` launches ``kernel<K>``.
template <class Launch>
int dispatch(int threads, int k, Launch&& launch) {
  if (threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  switch (k) {
    case 2: launch(std::integral_constant<int, 2>{}); break;
    case 4: launch(std::integral_constant<int, 4>{}); break;
    case 8: launch(std::integral_constant<int, 8>{}); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace scatter
