// Multi-field row scatter for the legacy layout's delta sync:
// dsts[f][rows[i], :] = upd[f][i, :] for every field f, in place, in ONE
// launch per delta.
//
// Replaces the Pallas kernel repro/kernels/delta_scatter.py:
// snapshot_multi_scatter, whose grid walked the dirty rows in order with
// the row indices scalar-prefetched and 24 aliased field outputs, one
// (1, W_f) block per field per step.  Here the field table (24 x
// destination pointer, update pointer, width in 32-bit words) travels by
// value as a kernel parameter, about 500 B, well inside the 4 KB limit,
// so no table is copied to the device before the launch.  Every dirty row
// is one thread block that walks the fields in order; neighbouring threads
// move neighbouring words of a field, so each field's row copy stays
// coalesced.  Blocks run in any order, which is safe because repeated
// rows carry identical data (the store pads a delta to a power of two by
// repeating its last row).
//
// Bound: bytes.  The call must read each field's update row once and
// write it once: 2 * D * sum(W_f) * 4 bytes over the card's memory rate,
// the same as the packed layout's row scatter (both move 1273 words per
// dirty node at the default geometry).  Widths run from 1 to 512 words, so
// most threads of a block idle on the narrow fields; a later version can
// flatten the table or give each field its own copy engine.
//
// Any 4-byte element type scatters the same way; the wrapper passes raw
// pointers.  Negative rows wrap Python-style.  The wrapper raises on a row
// outside [-S, S) before it launches, as the plain version does; the
// kernel still skips such a row so that no launch writes outside a field.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxFields = 32;

struct FieldTable {
  int* dst[kMaxFields];
  const int* upd[kMaxFields];
  int width[kMaxFields];
  int n;
};

__global__ void multi_scatter_kernel(const FieldTable table, int S,
                                     const int* __restrict__ rows) {
  int r = rows[blockIdx.x];
  if (r < 0) r += S;
  if (r < 0 || r >= S) return;
  for (int f = 0; f < table.n; ++f) {
    const int W = table.width[f];
    int* d = table.dst[f] + (size_t)r * W;
    const int* u = table.upd[f] + (size_t)blockIdx.x * W;
    for (int w = threadIdx.x; w < W; w += blockDim.x) d[w] = u[w];
  }
}

}  // namespace

extern "C" int multi_scatter_launch(void* const* dsts, void* const* upds,
                                    const int* widths, int nf, int S,
                                    const void* rows, int D, void* stream) {
  if (D <= 0 || nf <= 0) return 0;
  if (nf > kMaxFields) return (int)cudaErrorInvalidValue;
  FieldTable table = {};
  for (int f = 0; f < nf; ++f) {
    table.dst[f] = (int*)dsts[f];
    table.upd[f] = (const int*)upds[f];
    table.width[f] = widths[f];
  }
  table.n = nf;
  multi_scatter_kernel<<<D, 128, 0, (cudaStream_t)stream>>>(
      table, S, (const int*)rows);
  return (int)cudaGetLastError();
}
