// RSU leaf merge (paper Section 4.3, Figs. 7-8): the emission order of a
// leaf's sorted block (N slots) and log block (L slots) without key
// compares.  Per leaf b:
//   1. the order-hint shift-register sort of the log block: for each live
//      entry j < nlog in arrival order, every earlier entry at a position
//      >= hint[j] moves up one and entry j takes position hint[j];
//   2. ranks: sorted item i ranks i * (L + 1) + L, log entry l ranks
//      backptr[l] * (L + 1) + pos[l] (it goes right before the sorted item
//      its back pointer names, hint order breaking ties); unused slots
//      (i >= nitems, l >= nlog) rank INT32_MAX;
//   3. perm = the stable order of the T = N + L ranks, valid = used slots.
//
// Replaces the Pallas kernel repro/kernels/leaf_merge.py: leaf_merge.  The
// TPU kernel evaluates the shift register as one vector step per entry
// over a block of leaves, and inverts the ranks through [T, T] pairwise
// and one-hot tiles.
//
// Bound: bytes.  The call must read nitems, nlog and the back pointers
// and hints of each leaf's live log entries and write 2 * T words: at
// most 8 * (1 + L + T) bytes a leaf (776 at N = 64, L = 16), so the
// smoke's 9,464 leaves move about 7 MB, some 2 us at the card's memory
// rate.  A count over all T x T pairs (6,400 compares a leaf) and a
// shift register in shared memory with a barrier a step would make the
// call bound by instruction issue instead.
//
// What the design does about it.  The stable order needs no T x T count:
// the live sorted ranks ascend (i * (L + 1) + L for i < nitems) and the
// unused ones are a suffix of INT32_MAX, so
//   - sorted slot i goes to i + #{log l : rank_l < rank_i};
//   - log slot l goes to #{sorted i : rank_i <= rank_l} (sorted slots win
//     ties) + #{log m : rank_m < rank_l, or rank_m == rank_l and m < l};
//   - the first term of a log slot has a closed form: 0 below L, N at
//     INT32_MAX, min(live sorted, (rank_l - L) / (L + 1) + 1) between.
// That is O(T * L) compares a leaf (1,280 at N = 64, L = 16), all against
// the L log ranks.  The register instance (L <= 16, the stores' log
// blocks) gives a leaf a half-warp, two leaves a warp: it loads nitems,
// nlog and lane l's back pointer and hint in one burst, runs the shift
// register in registers with hint[j] broadcast by __shfl_sync (no shared
// memory, no barrier), forms lane l's rank, broadcasts all L ranks into
// every lane's registers, and counts there; unused ranks are INT32_MAX
// and count nothing.  The generic instance (L > 16, one warp a leaf)
// keeps the hints, positions and back pointers in shared memory, copied
// in one burst of 4-byte cp.async (cp_async.cuh), and counts the same
// way from there; no store's log block takes it.  The pairs (rank,
// slot) are distinct, so the positions are a permutation of 0..T-1 for
// ANY input and no write leaves the leaf's row.
// Rank arithmetic wraps as int32 does in torch and JAX (computed
// unsigned, never signed overflow); ranks compare as signed int32.  No
// pointer passes through shared memory.

#include <cuda_runtime.h>
#include <limits.h>

#include "cp_async.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// #{sorted i : rank_i <= r}: the live sorted ranks i * (L + 1) + L,
// i < nv, ascend; the unused ones are INT32_MAX
__device__ __forceinline__ int sorted_before(int r, int nv, int N, int L) {
  if (r == INT_MAX) return N;
  if (r < L) return 0;
  return min(nv, (int)((unsigned)(r - L) / (unsigned)(L + 1)) + 1);
}

// Register instance: a half-warp a leaf, L <= kG.
constexpr int kG = 16;

__global__ void leaf_merge_kernel(const int* __restrict__ nitems,
                                  const int* __restrict__ nlog,
                                  const int* __restrict__ backptr,
                                  const int* __restrict__ hints,
                                  int* __restrict__ perm,
                                  int* __restrict__ valid, int B, int N,
                                  int L) {
  const int gl = threadIdx.x & (kG - 1);      // lane within the leaf's group
  const int b = blockIdx.x * (blockDim.x / kG) + threadIdx.x / kG;
  const bool here = b < B;  // a group past B still joins the shuffles
  // ---- the burst: counts, and lane l's back pointer and hint
  int ni = 0, nl = 0, bp = 0, h = 0;
  if (here) {
    ni = nitems[b];
    nl = nlog[b];
    if (gl < L) {
      bp = backptr[(size_t)b * L + gl];
      h = hints[(size_t)b * L + gl];
    }
  }
  // ---- 1. the shift register: lane l holds entry l's position
  int pos = 0;
  for (int j = 0; j < L; ++j) {               // L is uniform: every lane
    const int hj = __shfl_sync(kFull, h, j, kG);
    if (j < nl) {
      if (gl < j && pos >= hj) pos = (int)((unsigned)pos + 1u);
      if (gl == j) pos = hj;
    }
  }
  // ---- 2. ranks: lane l's own, then all L in every lane
  const unsigned stride = (unsigned)L + 1u;
  const int rk = gl < L && gl < nl
                     ? (int)((unsigned)bp * stride + (unsigned)pos)
                     : INT_MAX;
  int r[kG];
#pragma unroll
  for (int m = 0; m < kG; ++m) r[m] = __shfl_sync(kFull, rk, m, kG);
  if (!here) return;
  // ---- 3. positions, O(T * L)
  const int T = N + L;
  const int nv = min(max(ni, 0), N);          // live sorted items
  int* pb = perm + (size_t)b * T;
  int* vb = valid + (size_t)b * T;
  for (int i = gl; i < N; i += kG) {
    const int s = i < nv ? (int)((unsigned)i * stride + (unsigned)L)
                         : INT_MAX;
    int c = i;
#pragma unroll
    for (int m = 0; m < kG; ++m) c += r[m] < s;
    pb[c] = i;
    vb[i] = i < nv;
  }
  if (gl < L) {
    int c = sorted_before(rk, nv, N, L);
#pragma unroll
    for (int m = 0; m < kG; ++m)
      c += (r[m] < rk) | ((r[m] == rk) & (m < gl));
    pb[c] = N + gl;
    vb[N + gl] = gl < nl;
  }
}

// Generic instance: one warp a leaf, any L; the warp's 3 * L words of
// shared memory hold the hints, the positions (then the ranks) and the
// back pointers.
__global__ void leaf_merge_kernel_generic(const int* __restrict__ nitems,
                                          const int* __restrict__ nlog,
                                          const int* __restrict__ backptr,
                                          const int* __restrict__ hints,
                                          int* __restrict__ perm,
                                          int* __restrict__ valid, int B,
                                          int N, int L) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;                         // uniform across the warp
  int* h = smem + warp * 3 * L;
  int* rank = h + L;                          // positions, then ranks
  int* bp = rank + L;
  // ---- the burst
  const int ni = nitems[b], nl = nlog[b];
  for (int l = lane; l < L; l += 32) {
    cp_async4(h + l, hints + (size_t)b * L + l);
    cp_async4(bp + l, backptr + (size_t)b * L + l);
    rank[l] = 0;
  }
  cp_async_wait_all();
  __syncwarp();
  // ---- 1. the shift register; steps j >= nlog change nothing
  for (int j = 0; j < L && j < nl; ++j) {
    const int hj = h[j];
    for (int i = lane; i < j; i += 32)
      if (rank[i] >= hj) rank[i] = (int)((unsigned)rank[i] + 1u);
    if (lane == (j & 31)) rank[j] = hj;       // no lane reads it this step
    __syncwarp();
  }
  // ---- 2. ranks, each by the lane that holds its position
  const unsigned stride = (unsigned)L + 1u;
  for (int l = lane; l < L; l += 32)
    rank[l] = l < nl ? (int)((unsigned)bp[l] * stride + (unsigned)rank[l])
                     : INT_MAX;
  __syncwarp();
  // ---- 3. positions, O(T * L)
  const int T = N + L;
  const int nv = min(max(ni, 0), N);
  int* pb = perm + (size_t)b * T;
  int* vb = valid + (size_t)b * T;
  for (int i = lane; i < N; i += 32) {
    const int s = i < nv ? (int)((unsigned)i * stride + (unsigned)L)
                         : INT_MAX;
    int c = i;
    for (int m = 0; m < L; ++m) c += rank[m] < s;
    pb[c] = i;
    vb[i] = i < nv;
  }
  for (int l = lane; l < L; l += 32) {
    const int rl = rank[l];
    int c = sorted_before(rl, nv, N, L);
    for (int m = 0; m < L; ++m)
      c += (rank[m] < rl) | ((rank[m] == rl) & (m < l));
    pb[c] = N + l;
    vb[N + l] = l < nl;
  }
}

}  // namespace

// group: 16 for the register instance (a half-warp a leaf, L <= 16), or 0
// for the generic instance (one warp a leaf, 12 * L bytes of shared memory
// a warp); warps: warps a block.
extern "C" int leaf_merge_launch(const void* nitems, const void* nlog,
                                 const void* backptr, const void* hints,
                                 void* perm, void* valid, int B, int N, int L,
                                 int group, int warps, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = group ? 0 : 12 * (size_t)warps * L;
  if (N < 0 || L < 0 || warps < 1 || warps > 8 ||
      (group != 0 && group != kG) || (group && L > kG) || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int *ni = (const int*)nitems, *nl = (const int*)nlog,
            *bp = (const int*)backptr, *h = (const int*)hints;
  int *pm = (int*)perm, *vd = (int*)valid;
  if (group) {
    const int leaves = warps * 32 / kG;       // leaves a block
    leaf_merge_kernel<<<(B + leaves - 1) / leaves, 32 * warps, 0, st>>>(
        ni, nl, bp, h, pm, vd, B, N, L);
  } else {
    leaf_merge_kernel_generic<<<(B + warps - 1) / warps, 32 * warps, smem,
                                st>>>(ni, nl, bp, h, pm, vd, B, N, L);
  }
  return (int)cudaGetLastError();
}
