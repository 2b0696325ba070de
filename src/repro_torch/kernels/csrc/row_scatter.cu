// Row scatter for the delta sync: dst[rows[i], :] = upd[i, :], in place.
//
// Replaces the Pallas kernel repro/kernels/delta_scatter.py:
// snapshot_delta_scatter (the body of snapshot_image_scatter), whose grid
// walked the dirty rows in order with the row indices scalar-prefetched.
// Here every dirty row is one thread block; blocks run in any order, which
// is safe because repeated rows carry identical data (the store pads a
// delta to a power of two by repeating its last row).
//
// Bound: bytes.  The call must read D update rows and write them once:
// 2 * D * W * 4 bytes over the card's memory rate.  Rows are W 32-bit
// words (1273 at the default geometry, a 5092-byte stride that is not
// 16-byte aligned), so each thread moves single words; neighbouring
// threads touch neighbouring words and the copy stays coalesced.
//
// Any 4-byte element type scatters the same way; the wrapper passes raw
// pointers.  Negative rows wrap Python-style.  The wrapper raises on a row
// outside [-S, S) before it launches, as the plain version does;
// the kernel still skips such a row so that no launch writes outside the
// image.

#include <cuda_runtime.h>

namespace {

__global__ void row_scatter_kernel(int* __restrict__ dst, int S, int W,
                                   const int* __restrict__ rows,
                                   const int* __restrict__ upd) {
  int r = rows[blockIdx.x];
  if (r < 0) r += S;
  if (r < 0 || r >= S) return;
  int* d = dst + (size_t)r * W;
  const int* u = upd + (size_t)blockIdx.x * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) d[w] = u[w];
}

}  // namespace

extern "C" int row_scatter_launch(void* dst, int S, int W, const void* rows,
                                  const void* upd, int D, void* stream) {
  if (D <= 0) return 0;
  row_scatter_kernel<<<D, 256, 0, (cudaStream_t)stream>>>(
      (int*)dst, S, W, (const int*)rows, (const int*)upd);
  return (int)cudaGetLastError();
}
