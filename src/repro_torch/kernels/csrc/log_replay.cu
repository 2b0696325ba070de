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
// To stay order-free every entry of a row writes the row's highest
// slots + 1 over all D (row, slot) pairs of the call.  That is the plain
// version's function on any input, also where a row's old nlog lies above
// every new slot (an atomicMax against the old word would keep the old
// count and compute another function).
//
// Up to D = kEntries = 8 pairs fit a thread's registers: then every
// block loads all D (row, slot) pairs and takes one entry, so the record
// stores of different entries issue from different SMs, and no block
// walks pairs in memory or waits at a barrier.  Above that a block takes
// 8 consecutive entries; ``replay_plan`` in delta_scatter.py sets the
// threads, one a record word where a block's records allow (a thread's
// stores issue one after another, each waiting on its address), and the
// launcher checks the plan and the shared memory.  In one burst, before
// any load is used, a block issues the cp.async copies of its records
// into shared memory, the loads of its entries' rows and slots, and each
// thread's first kPairsPerThread pairs.  Every thread keeps the block's 8
// rows in registers and compares each of its pairs with all 8, keeping 8
// running maxima; a warp max-reduce and one word per warp and entry in
// shared memory combine them.  So a block reads the D pairs once, the
// call D / 8 times, and no step waits on a value another step of the
// same thread loaded from shared memory.
//
// The same pass (up to 8 pairs, the registers) makes the range check.
// Every block reads every pair, so every block reaches the same verdict:
// some row outside [-S, S) (bit 0) or some slot outside [0, log_cap)
// (bit 1).  When it is bad no block writes the image.  Block 0 writes
// the verdict to `flag` on every call, so the flag needs no memset; the
// wrapper reads it back once after the launch and raises as the plain
// version does.  Every block finishes its verdict and its entries' maxima
// before its first store.
//
// Bound: bytes.  The call must read D entries and D (row, slot) pairs and
// write D entries plus one nlog word each: D * (EW * 8 + 12) bytes over
// the card's memory rate, a few nanoseconds at an epoch's size, so the
// launch and one memory round trip set the time.  Records are copied
// and stored word by word: their image rows' fields lie in a few short
// runs at a 4-byte-aligned stride.
//
// Negative rows wrap Python-style.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

struct Offsets {
  int kw, vw, nlog, log_keys, log_keylen, log_vals, log_vallen, log_op,
      log_backptr, log_hint, log_vdelta;
};

constexpr int kEntries = 8;            // entries a block takes
constexpr int kPairsPerThread = 4;     // pairs a thread loads, then compares
constexpr int kMaxThreads = 512;
constexpr int kMaxSmemBytes = 48 * 1024;

// Shared-memory words of a block: its records and each warp's maxima for
// its entries.
inline long replay_words(int EW, int threads) {
  return (long)kEntries * (EW + threads / 32);
}

// The image-row word of record word w of an entry at log slot j.
__device__ __forceinline__ int field_word(const Offsets& o, int w, int j) {
  const int kw = o.kw, vw = o.vw;
  if (w < kw) return o.log_keys + j * kw + w;
  if (w == kw) return o.log_keylen + j;
  if (w <= kw + vw) return o.log_vals + j * vw + (w - kw - 1);
  if (w == kw + vw + 1) return o.log_vallen + j;
  if (w == kw + vw + 2) return o.log_op + j;
  if (w == kw + vw + 3) return o.log_backptr + j;
  if (w == kw + vw + 4) return o.log_hint + j;
  return o.log_vdelta + j;
}

__device__ __forceinline__ void load_pairs(int* pr, int* ps,
                                           const int* __restrict__ rows,
                                           const int* __restrict__ slots,
                                           int base, int T, int D) {
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int i = base + k * T + (int)threadIdx.x;
    if (i < D) {
      pr[k] = rows[i];
      ps[k] = slots[i];
    }
  }
}

// x[e] for a runtime e < kEntries, x held in registers.
__device__ __forceinline__ int pick(const int* x, int e) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < kEntries; ++i) v = i == e ? x[i] : v;
  return v;
}

__global__ void log_replay_kernel(int* __restrict__ image, int S, int IW,
                                  const int* __restrict__ rows,
                                  const int* __restrict__ slots,
                                  const int* __restrict__ entries, int D,
                                  int EW, int log_cap,
                                  int* __restrict__ flag, Offsets o) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  int* rec = smem;                      // [kEntries * EW] the records
  int* part = rec + kEntries * EW;      // [T / 32][kEntries] warp maxima
  // D <= kEntries: every block holds all D pairs in registers and takes
  // one entry
  const bool held = D <= kEntries;
  const int E = held ? 1 : kEntries;
  const int e0 = blockIdx.x * E;
  const int ne = min(E, D - e0);
  const int p0 = held ? 0 : e0;    // the first pair in registers
  const int np = held ? D : ne;    // pairs in registers
  const int q0 = e0 - p0;               // the block's first entry among them

  // ---- one burst: records, the entries' rows and slots, the first pairs
  for (int u = tid; u < ne * EW; u += T)
    cp_async4(rec + u, entries + (size_t)e0 * EW + u);
  int er[kEntries], es[kEntries];
#pragma unroll
  for (int e = 0; e < kEntries; ++e) {
    er[e] = e < np ? rows[p0 + e] : 0;
    es[e] = e < np ? slots[p0 + e] : 0;
  }
  int pr[kPairsPerThread] = {}, ps[kPairsPerThread] = {};
  if (!held) load_pairs(pr, ps, rows, slots, 0, T, D);

  // ---- the verdict, and each entry's highest slots + 1 in the call
  int bad_row = 0, bad_slot = 0, best[kEntries] = {};
  if (held) {
#pragma unroll
    for (int e = 0; e < kEntries; ++e) {
      if (e >= np) continue;
      bad_row |= !(er[e] >= -S && er[e] < S);
      bad_slot |= !(es[e] >= 0 && es[e] < log_cap);
    }
  }
#pragma unroll
  for (int e = 0; e < kEntries; ++e)   // -1 never equals a wrapped row
    er[e] = e >= np ? -1 : er[e] < 0 ? er[e] + S : er[e];
  if (held) {
#pragma unroll
    for (int e = 0; e < kEntries; ++e)
#pragma unroll
      for (int f = 0; f < kEntries; ++f)
        if (f < np && er[f] == er[e]) best[e] = max(best[e], es[f] + 1);
  } else {
    // every pair, kPairsPerThread at a time
    for (int base = 0;;) {
#pragma unroll
      for (int k = 0; k < kPairsPerThread; ++k) {
        if (base + k * T + tid >= D) continue;
        const int r0 = pr[k], s = ps[k];
        const bool row_ok = r0 >= -S && r0 < S;
        const bool slot_ok = s >= 0 && s < log_cap;
        bad_row |= !row_ok;
        bad_slot |= !slot_ok;
        const int r = !row_ok || !slot_ok ? -2 : r0 < 0 ? r0 + S : r0;
#pragma unroll
        for (int e = 0; e < kEntries; ++e)
          if (r == er[e]) best[e] = max(best[e], s + 1);
      }
      base += kPairsPerThread * T;
      if (base >= D) break;
      load_pairs(pr, ps, rows, slots, base, T, D);
    }
#pragma unroll
    for (int e = 0; e < kEntries; ++e)
      best[e] = __reduce_max_sync(0xffffffffu, best[e]);
    if (lane == 0) {
#pragma unroll
      for (int e = 0; e < kEntries; ++e) part[warp * kEntries + e] = best[e];
    }
  }
  cp_async_wait_all();                  // a thread stores the words it copied
  if (!held) {                     // the same branch in every block
    bad_row = __syncthreads_or(bad_row);  // also: the warps' maxima seen
    bad_slot = __syncthreads_or(bad_slot);
  }
  if (blockIdx.x == 0 && tid == 0)
    *flag = (bad_row ? 1 : 0) | (bad_slot ? 2 : 0);
  if (bad_row || bad_slot) return;      // the same verdict in every block

  // ---- stores: each record word to its field, each entry's nlog
  for (int u = tid; u < ne * EW; u += T) {
    const int e = u / EW, q = q0 + e;
    image[(size_t)pick(er, q) * IW + field_word(o, u - e * EW, pick(es, q))] =
        rec[u];
  }
  if (tid < ne) {
    int m = pick(best, q0 + tid);
    if (!held)
      for (int w = 0; w < T / 32; ++w) m = max(m, part[w * kEntries + tid]);
    image[(size_t)pick(er, q0 + tid) * IW + o.nlog] = m;
  }
}

}  // namespace

extern "C" int log_replay_launch(void* image, int S, int IW, const void* rows,
                                 const void* slots, const void* entries,
                                 int D, int EW, int log_cap, int E,
                                 int threads, void* flag, int kw, int vw,
                                 int nlog, int log_keys, int log_keylen,
                                 int log_vals, int log_vallen, int log_op,
                                 int log_backptr, int log_hint,
                                 int log_vdelta, void* stream) {
  if (D <= 0) return 0;
  if (E != (D <= kEntries ? 1 : kEntries) || threads < 32 ||
      threads > kMaxThreads ||
      threads % 32 || replay_words(EW, threads) * 4 > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  Offsets o{kw,     vw,          nlog,     log_keys,  log_keylen, log_vals,
            log_vallen, log_op, log_backptr, log_hint, log_vdelta};
  const size_t smem = replay_words(EW, threads) * sizeof(int);
  log_replay_kernel<<<(D + E - 1) / E, threads, smem,
                      (cudaStream_t)stream>>>(
      (int*)image, S, IW, (const int*)rows, (const int*)slots,
      (const int*)entries, D, EW, log_cap, (int*)flag, o);
  return (int)cudaGetLastError();
}
