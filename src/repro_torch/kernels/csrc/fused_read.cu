// Fused GET/SCAN: the whole per-request read traversal in ONE kernel.
//
// Replaces the Pallas megakernel repro/kernels/fused_read.py:_fused_kernel
// (entry points batched_scan_fused and batched_get_fused).  It computes
// bit for bit what repro_torch/kernels/ref.py:batched_{scan,get}_fused_ref
// compute, the [vmem_hits, heap_gathers, lb_routed] meters included:
// cache-tiered descend, floor pre-pass over left siblings, forward scan
// over right siblings with the order-hint log merge and MVCC version
// resolution, and for GET the equality pass over the SCAN(K, K) result.
//
// Design.  One warp serves one request; a block holds WARPS = 2 requests,
// so a batch of 256 spreads over 128 blocks (one an SM) where 4 warps a
// block used 64.  Each request is a chain of dependent reads, and the
// design cuts the round trips to device memory along that chain:
//   - the C cache LIDs are copied once a block into shared memory (one
//     4-byte cp.async a word, all in flight) and probed there, a lane per
//     LID and a min-reduce: a miss, as at the never-cached leaf level,
//     costs no global trip;
//   - the root's cache row (slot 0 of the tier, fetched in the same burst
//     as the LIDs) is copied once a block into shared memory; every
//     request not routed to the heap pipe starts from it;
//   - every other row a request reads (interior rows, each MVCC hop, the
//     leaves) is staged whole into the warp's buffer R in ONE burst of
//     4-byte cp.async (IW = 1273 words make a 5,092-byte row stride, so
//     16-byte copies would be aligned for every fourth row only), then
//     read from shared memory: the version check, the shortcut and segment
//     floors (lane-parallel key compares reduced with shuffles) and the
//     leaf resolve.  The row the descent ends on is the leaf, so it is
//     already staged;
//   - resolve_leaf places each used slot in O(L): a sorted item t goes to
//     t + #(log entries ranked below it) (the sorted ranks t * (L + 1) + L
//     rise strictly), a log entry to #(sorted items ranked <= it) + #(log
//     entries ranked below it, or equal with a lower index), the former by
//     division; ranks are int32 and may wrap, as in the plain version.
// A heap level costs two round trips (the page-table word, then the row),
// a cached level one, the root none beyond the block's first burst.  Per
// leaf the warp derives the log entries' shift-register positions, the
// merge order, the runs of equal keys and each run's newest visible
// version, then emits with ballot prefix counts into result slots held in
// shared memory.  What bounds a request after these cuts is the chain of
// its warp's own dependent steps (probes, key compares, shuffles, the
// leaf resolve), a few microseconds even with every row in L2.
//
// The TPU kernel pinned the whole cache tier in VMEM.  256 rows x 5092 B is
// about 1.3 MB, far over the 227 KB of shared memory a block may use, so
// here the cache rows below the root stay in device memory and are served
// through L2; cache membership, not memory placement, decides the meters.
//
// Bound.  Each request is a chain of dependent row reads (root to leaf,
// then sibling leaves), so latency, not bandwidth, bounds this kernel: the
// latency bound is the longest request's dependent row reads (`loads`,
// about max(height, 1) + scanned leaves + MVCC hops) times one round trip
// to device memory, beside the byte bound, which counts the distinct rows
// a batch reads (`touched`).  Pass `touched` to have the kernel mark the
// rows it reads and `loads` for the per-request count of dependent row
// reads.
//
// Out-of-range indices wrap once as Python indexing does and then clamp,
// so a corrupt image can never make the kernel read outside its inputs.

#include <cuda_runtime.h>
#include <cstring>

#include "cp_async.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NULL_ID = -1;
constexpr int LEAF = 1;
constexpr int LOG_DELETE = 2;
constexpr int I32_MIN = -2147483647 - 1;
constexpr int I32_MAX = 2147483647;
constexpr int WARPS = 2;  // requests per block, one warp each
constexpr int MAX_SMEM = 232448;  // 227 KB, the most a block may use

// Geometry and packed-image word offsets.  The wrapper
// (repro_torch/kernels/fused_read.py:_geometry) fills it in this order.
struct Geo {
  int IW, N, L, NSC, KW, VW, SEG, M;
  int max_height, max_chain, max_scan_leaves;
  int ntype, nitems, version, oldptr, left_child, lsib, rsib;
  int skeys, skeylen, svals, svallen;
  int n_shortcuts, sc_keys, sc_keylen, sc_pos;
  int nlog, log_keys, log_keylen, log_vals, log_vallen;
  int log_op, log_backptr, log_hint, log_vdelta;
};
constexpr int GEO_INTS = sizeof(Geo) / sizeof(int);

struct Args {
  const int* image;   // [S, IW] heap image
  const int* pt;      // [n_lids] page table
  const int* clids;   // [C] cache LIDs, NULL padded
  const int* cimg;    // [C, IW] cache image
  const int* lo;      // [B, KW]
  const int* lolen;   // [B]
  const int* hi;      // [B, KW]
  const int* hilen;   // [B]
  int S, n_lids, C, B, root, rv, routed_k;
  int* count;         // SCAN: [B]
  int* keys;          // SCAN: [B, M, KW]
  int* klens;         // SCAN: [B, M]
  int* found;         // GET: [B]
  int* vals;          // SCAN: [B, M, VW]; GET: [B, VW]
  int* vlens;         // SCAN: [B, M]; GET: [B]
  int* trunc;         // SCAN: [B]
  int* meters;        // [B, 3]
  int* touched;       // optional [S + C]: rows read
  int* loads;         // optional [B]: dependent row reads per request
};

// Shared-memory words one warp needs.
__host__ __device__ inline int warp_words(const Geo& g) {
  return 2 * g.KW                     // query keys lo, hi
         + g.IW                       // staged row: interior, hop or leaf
         + 4 * (g.N + g.L)            // rank/live, merged, vmask, flags
         + g.M * (g.KW + g.VW + 2)    // result slots
         + g.KW + g.VW;               // floor item
}

// Dynamic shared memory of one block: the cache LIDs, the root row, then
// each warp's words (kernels/fused_read.py:smem_bytes mirrors it).
inline size_t block_smem_bytes(const Geo& g, int C) {
  return ((size_t)C + g.IW + (size_t)WARPS * warp_words(g)) * sizeof(int);
}

__device__ __forceinline__ int key_cmp(const int* a, int alen, const int* b,
                                       int blen, int kw) {
  for (int w = 0; w < kw; ++w) {
    unsigned x = (unsigned)a[w], y = (unsigned)b[w];
    if (x != y) return x < y ? -1 : 1;
  }
  return (alen > blen) - (alen < blen);
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Python-style index: a negative index wraps once, then clamps to [0, n).
__device__ __forceinline__ int wrap(int i, int n) {
  if (i < 0) i += n;
  return min(max(i, 0), n - 1);
}

// Row r of the combined view: heap rows [0, S), cache rows [S, S + C); r
// must be wrapped already.
__device__ __forceinline__ const int* row_src(const Args& a, const Geo& g,
                                              int r) {
  return r < a.S ? a.image + (size_t)r * g.IW
                 : a.cimg + (size_t)(r - a.S) * g.IW;
}

// Copy row `src` (IW words) into shared memory with every word's copy in
// flight at once; the caller's warp sees it after the trailing
// __syncwarp.  The row stride is 5,092 bytes at the default geometry, so
// only 4-byte copies are aligned for every row.
__device__ __forceinline__ void stage_burst(int* dst, const int* src, int n,
                                            int first, int step) {
  for (int w = first; w < n; w += step) cp_async4(dst + w, src + w);
  cp_async_wait_all();
}

// Lowest slot whose cache LID equals `lid`, else -1: a lane per LID, then
// a min-reduce over the warp.
__device__ __forceinline__ int probe(const int* clids, int C, int lid,
                                     int lane) {
  int best = I32_MAX;
  for (int i = lane; i < C; i += 32)
    if (clids[i] == lid) {
      best = i;
      break;
    }
  best = __reduce_min_sync(FULL, best);
  return best == I32_MAX ? -1 : best;
}

// Child LID an interior node routes the query to: shortcut floor, then the
// floor inside the selected segment, else left_child.
__device__ int route_child(const Geo& g, const int* row, const int* q,
                           int qlen, int lane) {
  const int nsc = row[g.n_shortcuts];
  int best = -1;
  for (int s = lane; s < g.NSC; s += 32)
    if (s < nsc && key_cmp(row + g.sc_keys + s * g.KW, row[g.sc_keylen + s],
                           q, qlen, g.KW) <= 0)
      best = s;
  const int seg = max(warp_max(best), 0);
  const int base = row[g.sc_pos + seg];
  const int n = row[g.nitems];
  best = -1;
  for (int k = lane; k < g.SEG; k += 32) {
    const int off = base + k;
    const int offc = max(min(off, g.N - 1), 0);
    if (off < n && key_cmp(row + g.skeys + offc * g.KW,
                           row[g.skeylen + offc], q, qlen, g.KW) <= 0)
      best = k;
  }
  const int local = warp_max(best);
  if (local < 0) return row[g.left_child];
  return row[g.svals + max(min(base + local, g.N - 1), 0) * g.VW];
}

// Slot t of a staged leaf: sorted item t < N, else log entry t - N.
__device__ __forceinline__ const int* item_key(const Geo& g, const int* R,
                                               int t) {
  return t < g.N ? R + g.skeys + t * g.KW : R + g.log_keys + (t - g.N) * g.KW;
}
__device__ __forceinline__ int item_klen(const Geo& g, const int* R, int t) {
  return t < g.N ? R[g.skeylen + t] : R[g.log_keylen + t - g.N];
}
__device__ __forceinline__ const int* item_val(const Geo& g, const int* R,
                                               int t) {
  return t < g.N ? R + g.svals + t * g.VW : R + g.log_vals + (t - g.N) * g.VW;
}
__device__ __forceinline__ int item_vlen(const Geo& g, const int* R, int t) {
  return t < g.N ? R[g.svallen + t] : R[g.log_vallen + t - g.N];
}

// Merged, shadow-resolved enumeration of the staged leaf R (the plain
// version is read_path._resolve_leaf).  Returns U, the number of used
// slots; merged[p] is the slot at merged position p < U and live[p] says
// whether it survives version filtering, shadowing and delete markers.
// Positions >= U hold unused slots, which are never live.
__device__ int resolve_leaf(const Geo& g, const int* R, int rv, int* live,
                            int* merged, int* vmask, int* flags, int lane) {
  const int N = g.N, L = g.L, T = N + L;
  const int nv = R[g.version];
  const int nit = max(min(R[g.nitems], N), 0);
  const int nlg = max(min(R[g.nlog], L), 0);
  int* rank = live;  // ranks first; live flags overwrite them at the end
  __syncwarp();      // every lane is done with the last leaf's arrays

  // merge ranks: sorted item i at i*(L+1)+L, log entry j just before the
  // sorted item its back pointer names, ordered by its shift-register
  // position (hint, bumped by each later entry whose hint is <= it)
  for (int t = lane; t < T; t += 32) {
    int r = I32_MAX;
    if (t < N) {
      if (t < nit) r = t * (L + 1) + L;
    } else if (t - N < nlg) {
      const int j = t - N;
      int pos = R[g.log_hint + j];
      for (int k = j + 1; k < nlg; ++k) pos += pos >= R[g.log_hint + k];
      r = (int)((unsigned)R[g.log_backptr + j] * (unsigned)(L + 1) +
                (unsigned)pos);                 // wraps as int32 does
    }
    rank[t] = r;
  }
  __syncwarp();
  // stable argsort of the used slots: a slot's merged position is the
  // number of used slots ranked before it (ties broken by slot index).
  // The sorted items' ranks t * (L + 1) + L rise strictly, so a sorted
  // item has exactly t of them before it, and a log entry of rank r has
  // those with t * (L + 1) + L <= r (a lower slot index wins the tie);
  // only the log block is counted one by one.
  for (int t = lane; t < T; t += 32) {
    if (t < N ? t >= nit : t - N >= nlg) continue;
    const int r = rank[t];
    int pos;
    if (t < N) {
      pos = t;
      for (int u = N; u < N + nlg; ++u) pos += rank[u] < r;
    } else {
      const long long below =
          r < L ? 0 : ((long long)r - L) / (L + 1) + 1;
      pos = (int)(below < nit ? below : nit);
      for (int u = N; u < N + nlg; ++u)
        pos += rank[u] < r || (rank[u] == r && u < t);
    }
    merged[pos] = t;
  }
  __syncwarp();
  // flags: bit 0 starts a run of equal keys, bit 1 visible, bit 2 delete
  const int U = nit + nlg;
  for (int p = lane; p < U; p += 32) {
    const int t = merged[p];
    int ver = nv, f = 2;
    if (t >= N) {
      const int j = t - N;
      ver = (int)((unsigned)nv + (unsigned)R[g.log_vdelta + j]);
      f = (ver <= rv ? 2 : 0) | (R[g.log_op + j] == LOG_DELETE ? 4 : 0);
    }
    bool start = p == 0;
    if (!start) {
      const int tp = merged[p - 1];
      // the stable argsort puts the unused sorted slots (rank I32_MAX)
      // before a log entry whose rank wrapped to I32_MAX, and they end a run
      start = key_cmp(item_key(g, R, t), item_klen(g, R, t),
                      item_key(g, R, tp), item_klen(g, R, tp), g.KW) != 0 ||
              (nit < N && rank[t] == I32_MAX && rank[tp] != I32_MAX);
    }
    flags[p] = f | (start ? 1 : 0);
    vmask[p] = (f & 2) ? ver : I32_MIN;
  }
  __syncwarp();
  // the newest visible version of each run wins; delete markers drop it
  for (int p = lane; p < U; p += 32) {
    int s = p, e = p;
    while (!(flags[s] & 1)) --s;
    while (e + 1 < U && !(flags[e + 1] & 1)) ++e;
    int mx = I32_MIN;
    for (int k = s; k <= e; ++k) mx = max(mx, vmask[k]);
    const int f = flags[p];
    live[p] = (f & 2) && vmask[p] == mx && !(f & 4);
  }
  __syncwarp();
  return U;
}

template <bool GET>
__global__ void __launch_bounds__(32 * WARPS)
fused_read_kernel(const Args a, const Geo g) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int b = blockIdx.x * WARPS + wid;
  const int T = g.N + g.L, KW = g.KW, VW = g.VW, M = g.M;
  int* clids = smem;                  // [C] cache LIDs
  int* RT = clids + a.C;              // [IW] the root's cache row
  int* qlo = RT + g.IW + wid * warp_words(g);
  int* qhi = qlo + KW;
  int* R = qhi + KW;
  int* live = R + g.IW;
  int* merged = live + T;
  int* vmask = merged + T;
  int* flags = vmask + T;
  int* okeys = flags + T;
  int* oklens = okeys + M * KW;
  int* ovals = oklens + M;
  int* ovlens = ovals + M * VW;
  int* fkey = ovlens + M;
  int* fval = fkey + KW;

  // ---- once a block: the cache LIDs, then the root's cache row; the
  // warp's query keys ride in the first burst -----------------------------
  const bool active = b < a.B;
  int lolen = 0, hilen = 0;
  if (active) {
    for (int w = lane; w < KW; w += 32) {
      cp_async4(qlo + w, a.lo + (size_t)b * KW + w);
      cp_async4(qhi + w, a.hi + (size_t)b * KW + w);
    }
    lolen = a.lolen[b];
    hilen = a.hilen[b];
  }
  // the cache tier lists the root first (core/cache.py:frontier_lids), so
  // slot 0's row rides in the same burst; the probe confirms it
  if (a.C > 0)
    for (int w = threadIdx.x; w < g.IW; w += blockDim.x)
      cp_async4(RT + w, a.cimg + w);
  stage_burst(clids, a.clids, a.C, threadIdx.x, blockDim.x);
  __syncthreads();
  const int root_slot = a.root == NULL_ID ? -1
                                          : probe(clids, a.C, a.root, lane);
  if (root_slot > 0) {           // the same in every warp of the block
    stage_burst(RT, a.cimg + (size_t)root_slot * g.IW, g.IW, threadIdx.x,
                blockDim.x);
    __syncthreads();
  }
  if (!active) return;                // a whole warp: no ballot is cut

  for (int w = lane; w < M * KW; w += 32) okeys[w] = 0;
  for (int w = lane; w < M * VW; w += 32) ovals[w] = 0;
  for (int w = lane; w < M; w += 32) oklens[w] = ovlens[w] = 0;
  __syncwarp();
  int loads = 0;

  // R holds row `staged` (a wrapped index); resolve_leaf last ran on row
  // `resolved`, whose merge U spans
  int staged = I32_MIN, resolved = I32_MIN, U = 0;
  auto mark = [&](int r) {
    if (a.touched != nullptr && lane == 0) a.touched[r] = 1;
  };
  // read row p: mark it, and stage it into R in one burst unless R holds it
  auto stage = [&](int p) -> const int* {
    const int r = wrap(p, a.S + a.C);
    mark(r);
    if (r != staged) {
      __syncwarp();                   // every lane is done reading R
      stage_burst(R, row_src(a, g, r), g.IW, lane, 32);
      __syncwarp();
      staged = r;
      resolved = I32_MIN;
    }
    return R;
  };
  // page-table lookup, then the old-version walk (paper Section 3.2): at
  // most max_chain hops while the node is newer than the read version and
  // has an older version; each row it reads is staged, so the last one
  // checked is in R when the walk ends early
  auto heap_row = [&](int lid) -> int {
    ++loads;
    int p = a.pt[wrap(lid, a.n_lids)];
    for (int k = 0; k < g.max_chain; ++k) {
      const int* row = stage(p);
      const int old = row[g.oldptr];
      if (!(row[g.version] > a.rv && old != NULL_ID)) break;
      p = old;
      ++loads;
    }
    return p;
  };

  // ---- descend: cache tier first, heap fall-through ----------------------
  const bool routed = (b % 16) < a.routed_k;
  int lid = a.root, leaf = 0, vh = 0, hg = 0, lr = 0;
  for (int level = 0; level < g.max_height; ++level) {
    const int slot = probe(clids, a.C, lid, lane);
    const bool hit = slot >= 0 && lid != NULL_ID;
    const bool use_cache = hit && !routed;
    const int* row;
    if (use_cache) {
      leaf = a.S + slot;
      ++loads;
      if (slot == root_slot) {        // the block's copy
        mark(wrap(leaf, a.S + a.C));
        row = RT;
      } else {
        row = stage(leaf);
      }
    } else {
      leaf = heap_row(lid);
      row = stage(leaf);
    }
    vh += use_cache;
    hg += !use_cache;
    lr += hit && routed;
    if (row[g.ntype] == LEAF) break;
    lid = route_child(g, row, qlo, lolen, lane);
  }

  // ---- leaf staging: the descent left the leaf in R unless it was the
  // root's block copy ------------------------------------------------------
  auto stage_leaf = [&](int p) {
    stage(p);
    if (staged != resolved) {
      U = resolve_leaf(g, R, a.rv, live, merged, vmask, flags, lane);
      resolved = staged;
    }
  };

  // ---- floor pre-pass: walk left until a visible key <= lo ---------------
  bool have = false;
  int fklen = 0, fvlen = 0;
  int p = leaf;
  for (int step = 0; step < g.max_scan_leaves; ++step) {
    stage_leaf(p);
    int best = -1;
    for (int q = lane; q < U; q += 32) {
      const int t = merged[q];
      if (live[q] && key_cmp(item_key(g, R, t), item_klen(g, R, t), qlo,
                             lolen, KW) <= 0)
        best = q;
    }
    best = warp_max(best);
    if (best >= 0) {
      const int t = merged[best];
      for (int w = lane; w < KW; w += 32) fkey[w] = item_key(g, R, t)[w];
      for (int w = lane; w < VW; w += 32) fval[w] = item_val(g, R, t)[w];
      fklen = item_klen(g, R, t);
      fvlen = item_vlen(g, R, t);
      have = true;
      break;
    }
    const int nxt = R[g.lsib];
    if (nxt == NULL_ID) break;
    p = heap_row(max(nxt, 0));
  }
  __syncwarp();

  // ---- floor emission ----------------------------------------------------
  int count = 0;
  if (have && key_cmp(fkey, fklen, qhi, hilen, KW) <= 0) {
    for (int w = lane; w < KW; w += 32) okeys[w] = fkey[w];
    for (int w = lane; w < VW; w += 32) ovals[w] = fval[w];
    if (lane == 0) {
      oklens[0] = fklen;
      ovlens[0] = fvlen;
    }
    count = 1;
  }

  // ---- forward scan across right siblings --------------------------------
  bool trunc = false, done = false;
  p = leaf;
  for (int step = 0; step < g.max_scan_leaves; ++step) {
    stage_leaf(p);
    int emitted = 0;
    bool past = false;
    for (int base = 0; base < U; base += 32) {
      const int q = base + lane;
      int t = 0;
      bool e = false, beyond = false;
      if (q < U && live[q]) {
        t = merged[q];
        const int* k = item_key(g, R, t);
        const int kl = item_klen(g, R, t);
        const int chi = key_cmp(k, kl, qhi, hilen, KW);
        e = chi <= 0 && key_cmp(k, kl, qlo, lolen, KW) > 0;
        beyond = chi > 0;
      }
      const unsigned m = __ballot_sync(FULL, e);
      past |= __ballot_sync(FULL, beyond) != 0;
      const int slot = count + emitted + __popc(m & ((1u << lane) - 1));
      if (e && slot < M) {
        const int* k = item_key(g, R, t);
        const int* v = item_val(g, R, t);
        for (int w = 0; w < KW; ++w) okeys[slot * KW + w] = k[w];
        for (int w = 0; w < VW; ++w) ovals[slot * VW + w] = v[w];
        oklens[slot] = item_klen(g, R, t);
        ovlens[slot] = item_vlen(g, R, t);
      }
      emitted += __popc(m);
    }
    const int room = max(M - count, 0);
    trunc = emitted > room;
    count += min(emitted, room);
    const int nxt = R[g.rsib];
    done = past || nxt == NULL_ID || trunc;
    if (done) break;
    p = heap_row(max(nxt, 0));
  }
  trunc = trunc || !done;
  __syncwarp();

  // ---- outputs -----------------------------------------------------------
  if (lane == 0) {
    a.meters[(size_t)b * 3 + 0] = vh;
    a.meters[(size_t)b * 3 + 1] = hg;
    a.meters[(size_t)b * 3 + 2] = lr;
    if (a.loads != nullptr) a.loads[b] = loads;
  }
  if (GET) {
    // first result slot holding the key itself; slot 0 on a miss
    int idx = -1;
    for (int base = 0; base < M; base += 32) {
      const int j = base + lane;
      const unsigned m = __ballot_sync(
          FULL, j < count &&
                    key_cmp(okeys + j * KW, oklens[j], qlo, lolen, KW) == 0);
      if (m) {
        idx = base + __ffs(m) - 1;
        break;
      }
    }
    const bool found = idx >= 0;
    if (!found) idx = 0;
    for (int w = lane; w < VW; w += 32)
      a.vals[(size_t)b * VW + w] = ovals[idx * VW + w];
    if (lane == 0) {
      a.found[b] = found;
      a.vlens[b] = ovlens[idx];
    }
  } else {
    for (int w = lane; w < M * KW; w += 32)
      a.keys[(size_t)b * M * KW + w] = okeys[w];
    for (int w = lane; w < M * VW; w += 32)
      a.vals[(size_t)b * M * VW + w] = ovals[w];
    for (int w = lane; w < M; w += 32) {
      a.klens[(size_t)b * M + w] = oklens[w];
      a.vlens[(size_t)b * M + w] = ovlens[w];
    }
    if (lane == 0) {
      a.count[b] = count;
      a.trunc[b] = trunc;
    }
  }
}

}  // namespace

// get_mode 1: outputs (found [B], vals [B, VW], vallens [B]);
// get_mode 0: outputs (count [B], keys [B, M, KW], keylens [B, M],
//             vals [B, M, VW], vallens [B, M], truncated [B]).
// Unused output pointers may be null.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int fused_read_launch(
    int get_mode, const int* geo, int n_geo, const void* image, int S,
    const void* pt, int n_lids, const void* clids, const void* cimg, int C,
    const void* lo, const void* lolen, const void* hi, const void* hilen,
    int B, int root, int rv, int routed_k, void* out0, void* out1,
    void* out2, void* out3, void* out4, void* out5, void* meters,
    void* touched, void* loads, void* stream) {
  if (n_geo != GEO_INTS || n_lids <= 0 || S + C <= 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Geo g;
  std::memcpy(&g, geo, sizeof(Geo));
  Args a = {};
  a.image = (const int*)image;
  a.pt = (const int*)pt;
  a.clids = (const int*)clids;
  a.cimg = (const int*)cimg;
  a.lo = (const int*)lo;
  a.lolen = (const int*)lolen;
  a.hi = (const int*)hi;
  a.hilen = (const int*)hilen;
  a.S = S;
  a.n_lids = n_lids;
  a.C = C;
  a.B = B;
  a.root = root;
  a.rv = rv;
  a.routed_k = routed_k;
  if (get_mode) {
    a.found = (int*)out0;
    a.vals = (int*)out1;
    a.vlens = (int*)out2;
  } else {
    a.count = (int*)out0;
    a.keys = (int*)out1;
    a.klens = (int*)out2;
    a.vals = (int*)out3;
    a.vlens = (int*)out4;
    a.trunc = (int*)out5;
  }
  a.meters = (int*)meters;
  a.touched = (int*)touched;
  a.loads = (int*)loads;
  const size_t smem = block_smem_bytes(g, C);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  // raise each kernel's dynamic shared-memory limit once, to the most a
  // block may use
  static const cudaError_t raised[2] = {
      cudaFuncSetAttribute(fused_read_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM),
      cudaFuncSetAttribute(fused_read_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM)};
  if (raised[get_mode ? 1 : 0] != cudaSuccess)
    return (int)raised[get_mode ? 1 : 0];
  void (*kern)(const Args, const Geo) =
      get_mode ? fused_read_kernel<true> : fused_read_kernel<false>;
  kern<<<(B + WARPS - 1) / WARPS, 32 * WARPS, smem, (cudaStream_t)stream>>>(
      a, g);
  return (int)cudaGetLastError();
}

// The dynamic shared memory fused_read_launch asks for at this geometry
// and cache size, in bytes; -1 for a malformed geometry.
extern "C" int fused_read_smem_bytes(const int* geo, int n_geo, int C) {
  if (n_geo != GEO_INTS || C < 0) return -1;
  Geo g;
  std::memcpy(&g, geo, sizeof(Geo));
  return (int)block_smem_bytes(g, C);
}
