// Row scatter for the delta sync: dst[rows[i], :] = upd[i, :], in place.
//
// Replaces the Pallas kernel repro/kernels/delta_scatter.py:
// snapshot_delta_scatter (the body of snapshot_image_scatter), whose grid
// walked the dirty rows in order with the row indices scalar-prefetched.
// Here blocks run in any order, which is safe because repeated rows carry
// identical data (the store pads a delta to a power of two by repeating
// its last row).
//
// The packed image is the one-field case of the flattened row copy in
// scatter_rows.cuh, which holds the design and the bound: one block a
// row, each thread issues all K loads of its chunk of the row before its
// stores, and a row equal to its predecessor is skipped.  At the default
// geometry (W = 1273 words) K = 8 and T = 160 cover a row in one chunk.

#include "scatter_rows.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(scatter::kMaxThreads)
row_scatter_kernel(const scatter::FlatTable t, int S,
                   const int* __restrict__ rows) {
  scatter::copy_row<K>(t, S, rows);
}

}  // namespace

extern "C" int row_scatter_launch(void* dst, int S, int W, const void* rows,
                                  const void* upd, int D, int threads, int k,
                                  void* stream) {
  if (D <= 0 || W <= 0) return 0;
  scatter::FlatTable t = {};
  t.dst[0] = (int*)dst;
  t.upd[0] = (const int*)upd;
  t.off[1] = W;
  t.nf = 1;
  return scatter::dispatch(threads, k, [&](auto K) {
    row_scatter_kernel<decltype(K)::value>
        <<<D, threads, 0, (cudaStream_t)stream>>>(t, S, (const int*)rows);
  });
}
