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
// Design.  One warp serves one request; a block holds WARPS requests and
// no block-wide barrier is used.  Per level of the descend the warp probes
// the C cache LIDs lane-parallel with a ballot; a hit that the load
// balancer does not route (request index % 16 >= routed_k) reads its row
// from the cache array, anything else takes the pagetable lookup and the
// bounded MVCC walk and reads the heap row.  The shortcut and segment
// floors are lane-parallel key compares reduced with shuffles.  A leaf is
// staged whole in the warp's shared memory (IW words); the warp derives the
// log entries' shift-register positions, the stable merge order of the
// sorted and log blocks (each used slot counts the used slots ranked
// before it), the runs of equal keys and each run's newest visible
// version, then emits with ballot prefix counts into result slots held in
// shared memory.
//
// The TPU kernel pinned the whole cache tier in VMEM.  256 rows x 5092 B is
// about 1.3 MB, far over the 227 KB of shared memory a block may use, so
// here cache rows stay in device memory and are served through L2; cache
// membership, not memory placement, decides the meters.
//
// Bound.  Each request is a chain of dependent row reads (root to leaf,
// then sibling leaves), so latency, not bandwidth, bounds this kernel: a
// request issues about max(height, 1) + scanned-leaves row reads in
// sequence.  The byte bound counts the distinct rows a batch reads; pass
// `touched` to have the kernel mark them and `loads` for the per-request
// count of dependent row reads.
//
// Out-of-range indices wrap once as Python indexing does and then clamp,
// so a corrupt image can never make the kernel read outside its inputs.

#include <cuda_runtime.h>
#include <cstring>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NULL_ID = -1;
constexpr int LEAF = 1;
constexpr int LOG_DELETE = 2;
constexpr int I32_MIN = -2147483647 - 1;
constexpr int I32_MAX = 2147483647;
constexpr int WARPS = 4;  // requests per block, one warp each

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
         + g.IW                       // staged leaf row
         + 4 * (g.N + g.L)            // rank/live, merged, vmask, flags
         + g.M * (g.KW + g.VW + 2)    // result slots
         + g.KW + g.VW;               // floor item
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

// Row r of the combined view: heap rows [0, S), cache rows [S, S + C).
__device__ __forceinline__ const int* row_ptr(const Args& a, const Geo& g,
                                              int r) {
  r = wrap(r, a.S + a.C);
  if (a.touched != nullptr && (threadIdx.x & 31) == 0) a.touched[r] = 1;
  return r < a.S ? a.image + (size_t)r * g.IW
                 : a.cimg + (size_t)(r - a.S) * g.IW;
}

// Old-version walk (paper Section 3.2): at most max_chain hops while the
// node is newer than the read version and has an older version.
__device__ int resolve_version(const Args& a, const Geo& g, int p,
                               int& loads) {
  for (int k = 0; k < g.max_chain; ++k) {
    const int* row = row_ptr(a, g, p);
    const int old = row[g.oldptr];
    if (!(row[g.version] > a.rv && old != NULL_ID)) break;
    p = old;
    ++loads;
  }
  return p;
}

__device__ __forceinline__ int heap_row(const Args& a, const Geo& g, int lid,
                                        int& loads) {
  ++loads;
  return resolve_version(a, g, a.pt[wrap(lid, a.n_lids)], loads);
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
      r = R[g.log_backptr + j] * (L + 1) + pos;
    }
    rank[t] = r;
  }
  __syncwarp();
  // stable argsort of the used slots: a slot's merged position is the
  // number of used slots ranked before it (ties broken by slot index)
  for (int t = lane; t < T; t += 32) {
    if (t < N ? t >= nit : t - N >= nlg) continue;
    const int r = rank[t];
    int pos = 0;
    for (int u = 0; u < nit; ++u) pos += rank[u] < r || (rank[u] == r && u < t);
    for (int u = N; u < N + nlg; ++u)
      pos += rank[u] < r || (rank[u] == r && u < t);
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
      start = key_cmp(item_key(g, R, t), item_klen(g, R, t),
                      item_key(g, R, tp), item_klen(g, R, tp), g.KW) != 0;
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
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= a.B) return;
  const int T = g.N + g.L, KW = g.KW, VW = g.VW, M = g.M;
  int* qlo = smem + (threadIdx.x >> 5) * warp_words(g);
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

  for (int w = lane; w < KW; w += 32) {
    qlo[w] = a.lo[(size_t)b * KW + w];
    qhi[w] = a.hi[(size_t)b * KW + w];
  }
  for (int w = lane; w < M * KW; w += 32) okeys[w] = 0;
  for (int w = lane; w < M * VW; w += 32) ovals[w] = 0;
  for (int w = lane; w < M; w += 32) oklens[w] = ovlens[w] = 0;
  const int lolen = a.lolen[b], hilen = a.hilen[b];
  __syncwarp();
  int loads = 0;

  // ---- descend: cache tier first, heap fall-through ----------------------
  const bool routed = (b % 16) < a.routed_k;
  int lid = a.root, leaf = 0, vh = 0, hg = 0, lr = 0;
  for (int level = 0; level < g.max_height; ++level) {
    int slot = -1;
    for (int base = 0; base < a.C; base += 32) {
      const int i = base + lane;
      const unsigned m = __ballot_sync(FULL, i < a.C && a.clids[i] == lid);
      if (m) {
        slot = base + __ffs(m) - 1;
        break;
      }
    }
    const bool hit = slot >= 0 && lid != NULL_ID;
    const bool use_cache = hit && !routed;
    if (use_cache) {
      leaf = a.S + slot;
      ++loads;
    } else {
      leaf = heap_row(a, g, lid, loads);
    }
    vh += use_cache;
    hg += !use_cache;
    lr += hit && routed;
    const int* row = row_ptr(a, g, leaf);
    if (row[g.ntype] == LEAF) break;
    lid = route_child(g, row, qlo, lolen, lane);
  }

  // ---- leaf staging ------------------------------------------------------
  int staged = I32_MIN, U = 0;
  auto stage = [&](int p) {
    if (p == staged) return;
    const int* src = row_ptr(a, g, p);
    __syncwarp();
    for (int w = lane; w < g.IW; w += 32) R[w] = src[w];
    __syncwarp();
    U = resolve_leaf(g, R, a.rv, live, merged, vmask, flags, lane);
    staged = p;
  };

  // ---- floor pre-pass: walk left until a visible key <= lo ---------------
  bool have = false;
  int fklen = 0, fvlen = 0;
  int p = leaf;
  for (int step = 0; step < g.max_scan_leaves; ++step) {
    stage(p);
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
    p = heap_row(a, g, max(nxt, 0), loads);
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
    stage(p);
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
    p = heap_row(a, g, max(nxt, 0), loads);
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
  const size_t smem = (size_t)WARPS * warp_words(g) * sizeof(int);
  void (*kern)(const Args, const Geo) =
      get_mode ? fused_read_kernel<true> : fused_read_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(B + WARPS - 1) / WARPS, 32 * WARPS, smem, (cudaStream_t)stream>>>(
      a, g);
  return (int)cudaGetLastError();
}
