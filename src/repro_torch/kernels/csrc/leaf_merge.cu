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
// and one-hot tiles.  Here one warp serves one leaf, with its log
// positions and ranks in shared memory: one lane per log entry runs each
// insertion step, then each lane counts, for its slots i,
//   out_pos[i] = #{j : rank[j] < rank[i] or (rank[j] == rank[i], j < i)}
// and writes perm[out_pos[i]] = i.  The pairs (rank, slot) are distinct,
// so out_pos is a permutation of 0..T-1 for ANY input and no write leaves
// the leaf's row; unused slots (all INT32_MAX) follow in slot order, as
// the reference's stable argsort puts them.  Rank arithmetic wraps as
// int32 does in torch and JAX (computed unsigned, never signed overflow);
// ranks compare as signed int32.
//
// Bound: bytes.  The call must read nitems, nlog and the back pointers
// and hints of each leaf's live log entries and write 2 * T words: at
// most 8 * (1 + L + T) bytes a leaf (776 at N = 64, L = 16), so a few
// thousand leaves move a few MB, about a microsecond at the card's memory
// rate.  The T * T count (6,400
// compares a leaf) runs from shared memory, where every lane of the warp
// reads the same rank[j] at once (a broadcast).

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void leaf_merge_kernel(const int* __restrict__ nitems,
                                  const int* __restrict__ nlog,
                                  const int* __restrict__ backptr,
                                  const int* __restrict__ hints,
                                  int* __restrict__ perm,
                                  int* __restrict__ valid, int B, int N,
                                  int L) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  const int T = N + L;
  int* rank = smem + warp * (T + L);    // [T] this leaf's ranks
  int* pos = rank + T;                  // [L] its log entries' positions
  if (b >= B) return;                   // uniform across the warp
  const int ni = nitems[b], nl = nlog[b];
  const int* bp = backptr + (size_t)b * L;
  const int* h = hints + (size_t)b * L;

  // 1. shift-register sort; steps j >= nlog change nothing
  for (int i = lane; i < L; i += 32) pos[i] = 0;
  __syncwarp();
  for (int j = 0; j < L && j < nl; ++j) {
    const int hj = h[j];
    for (int i = lane; i < j; i += 32)
      if (pos[i] >= hj) pos[i] = (int)((unsigned)pos[i] + 1u);
    if (lane == (j & 31)) pos[j] = hj;  // no lane reads pos[j] this step
    __syncwarp();
  }

  // 2. ranks
  const unsigned stride = (unsigned)L + 1u;
  for (int i = lane; i < T; i += 32) {
    int r = INT_MAX;
    if (i < N) {
      if (i < ni) r = (int)((unsigned)i * stride + (unsigned)L);
    } else if (i - N < nl) {
      r = (int)((unsigned)bp[i - N] * stride + (unsigned)pos[i - N]);
    }
    rank[i] = r;
  }
  __syncwarp();

  // 3. out_pos by counting, then the inverse permutation and the mask
  int* pb = perm + (size_t)b * T;
  int* vb = valid + (size_t)b * T;
  for (int i = lane; i < T; i += 32) {
    const int ri = rank[i];
    int p = 0;
    for (int j = 0; j < T; ++j) {
      const int rj = rank[j];
      p += (rj < ri) | ((rj == ri) & (j < i));
    }
    pb[p] = i;
    vb[i] = i < N ? (i < ni) : (i - N < nl);
  }
}

}  // namespace

extern "C" int leaf_merge_launch(const void* nitems, const void* nlog,
                                 const void* backptr, const void* hints,
                                 void* perm, void* valid, int B, int N, int L,
                                 void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = sizeof(int) * kWarpsPerBlock * (size_t)(N + 2 * L);
  leaf_merge_kernel<<<blocks, 32 * kWarpsPerBlock, smem,
                      (cudaStream_t)stream>>>(
      (const int*)nitems, (const int*)nlog, (const int*)backptr,
      (const int*)hints, (int*)perm, (int*)valid, B, N, L);
  return (int)cudaGetLastError();
}
