// Log-replay scatter for the log-shipped replication feed, in place:
// entry i (a marshalled record of EW = kw + vw + 6 words: key lanes,
// keylen, value lanes, vallen, op, backptr, hint, vdelta) is written into
// image row rows[i] at log slot j = slots[i], each per-slot field at its
// static layout offset plus j times its width, and the row's nlog word is
// SET to the highest slots + 1 among the call's entries for that row.
//
// Replaces the Pallas kernel repro/kernels/delta_scatter.py:
// log_replay_scatter (body _log_replay_kernel), whose grid walked the
// entries in order and stored nlog = slots[i] + 1 at each step, so the
// last write of a row won.  Here entries run in parallel in any order.
// To stay order-free each entry's warp scans all D (row, slot) pairs for
// its row's maximum slots + 1, so every entry of a row writes the same
// nlog.  That is the plain version's function on any input, also where a
// row's old nlog lies above every new slot (an atomicMax against the old
// word would keep the old count and compute another function).  D is at
// most a few thousand per epoch, so the scan is a few KB from L2 per warp.
//
// Bound: bytes.  The call must read D entries and D (row, slot) pairs and
// write D entries plus one nlog word each: D * (EW * 8 + 12) bytes over
// the card's memory rate, a few nanoseconds at an epoch's size, so the
// launch sets the time.  One warp per entry: lane w moves record word w
// (EW = 18 at the default geometry), the warp's lanes then cover one
// record's words, which lie in a few short runs of its image row.
//
// Negative rows wrap Python-style.  The wrapper raises on a row outside
// [-S, S) or a slot outside [0, log_cap) before it launches, as the plain
// version does; the kernel still skips such a row so that no launch
// writes outside the image.

#include <cuda_runtime.h>

namespace {

struct Offsets {
  int kw, vw, nlog, log_keys, log_keylen, log_vals, log_vallen, log_op,
      log_backptr, log_hint, log_vdelta;
};

constexpr int kWarpsPerBlock = 4;

__global__ void log_replay_kernel(int* __restrict__ image, int S, int IW,
                                  const int* __restrict__ rows,
                                  const int* __restrict__ slots,
                                  const int* __restrict__ entries, int D,
                                  int EW, Offsets o) {
  const int entry = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (entry >= D) return;               // uniform across the warp
  int r = rows[entry];
  if (r < 0) r += S;
  if (r < 0 || r >= S) return;          // uniform across the warp
  const int j = slots[entry];

  // the row's final log count: max slots + 1 over this call's entries
  int best = 0;
  for (int i = lane; i < D; i += 32) {
    int ri = rows[i];
    if (ri < 0) ri += S;
    if (ri == r) best = max(best, slots[i] + 1);
  }
  for (int s = 16; s > 0; s >>= 1)
    best = max(best, __shfl_xor_sync(0xffffffffu, best, s));

  int* row = image + (size_t)r * IW;
  const int* e = entries + (size_t)entry * EW;
  const int kw = o.kw, vw = o.vw;
  for (int w = lane; w < EW; w += 32) {
    int dst;
    if (w < kw)
      dst = o.log_keys + j * kw + w;
    else if (w == kw)
      dst = o.log_keylen + j;
    else if (w <= kw + vw)
      dst = o.log_vals + j * vw + (w - kw - 1);
    else if (w == kw + vw + 1)
      dst = o.log_vallen + j;
    else if (w == kw + vw + 2)
      dst = o.log_op + j;
    else if (w == kw + vw + 3)
      dst = o.log_backptr + j;
    else if (w == kw + vw + 4)
      dst = o.log_hint + j;
    else
      dst = o.log_vdelta + j;
    row[dst] = e[w];
  }
  if (lane == 0) row[o.nlog] = best;
}

}  // namespace

extern "C" int log_replay_launch(void* image, int S, int IW, const void* rows,
                                 const void* slots, const void* entries,
                                 int D, int EW, int kw, int vw, int nlog,
                                 int log_keys, int log_keylen, int log_vals,
                                 int log_vallen, int log_op, int log_backptr,
                                 int log_hint, int log_vdelta, void* stream) {
  if (D <= 0) return 0;
  Offsets o{kw,     vw,          nlog,     log_keys,  log_keylen, log_vals,
            log_vallen, log_op, log_backptr, log_hint, log_vdelta};
  const int blocks = (D + kWarpsPerBlock - 1) / kWarpsPerBlock;
  log_replay_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                      (cudaStream_t)stream>>>(
      (int*)image, S, IW, (const int*)rows, (const int*)slots,
      (const int*)entries, D, EW, o);
  return (int)cudaGetLastError();
}
