// Multi-field row scatter for the legacy layout's delta sync:
// dsts[f][rows[i], :] = upd[f][i, :] for every field f, in place, in ONE
// launch per delta.
//
// Replaces the Pallas kernel repro/kernels/delta_scatter.py:
// snapshot_multi_scatter, whose grid walked the dirty rows in order with
// the row indices scalar-prefetched and 24 aliased field outputs, one
// (1, W_f) block per field per step.  Here blocks run in any order, which
// is safe because repeated rows carry identical data (the store pads a
// delta to a power of two by repeating its last row).
//
// The legacy layout is the 24-field case of the flattened row copy in
// scatter_rows.cuh, which holds the design and the bound: a row is its
// fields concatenated in schema order (1273 words at the default
// geometry, as the packed image's row), the field pointers and the prefix
// offsets of the widths travel by value and are staged in shared memory,
// each word finds its field by a binary search of the offsets, and each
// thread issues all K loads of its chunk before its stores.  So the call
// moves the same words as the packed row scatter of the same rows, and a
// narrow field (eleven are one word wide) costs only its own words.

#include "scatter_rows.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(scatter::kMaxThreads)
multi_scatter_kernel(const scatter::FlatTable t, int S,
                     const int* __restrict__ rows) {
  scatter::copy_row<K>(t, S, rows);
}

}  // namespace

extern "C" int multi_scatter_launch(void* const* dsts, void* const* upds,
                                    const int* widths, int nf, int S,
                                    const void* rows, int D, int threads,
                                    int k, void* stream) {
  if (nf <= 0 || nf > scatter::kMaxFields) return (int)cudaErrorInvalidValue;
  scatter::FlatTable t = {};
  for (int f = 0; f < nf; ++f) {
    if (widths[f] < 0) return (int)cudaErrorInvalidValue;
    t.dst[f] = (int*)dsts[f];
    t.upd[f] = (const int*)upds[f];
    t.off[f + 1] = t.off[f] + widths[f];
  }
  t.nf = nf;
  if (D <= 0 || t.off[nf] == 0) return 0;
  return scatter::dispatch(threads, k, [&](auto K) {
    multi_scatter_kernel<decltype(K)::value>
        <<<D, threads, 0, (cudaStream_t)stream>>>(t, S, (const int*)rows);
  });
}
