// Dense <-> colour-split converters for padded 2D Lyapunov levels (sm_90a).
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/relax.py:_pallas_split_2d          (dense -> halves)
//   pde_multigrid_tpu/ops/pallas/relax.py:_pallas_merge_2d          (halves -> dense)
// and the XLA default split_colors_2d/merge_colors_2d they stand in for.
// The sweeps on the halves are csrc/color_slab2d_shard.cu's.
//
// Layout ("halves"): a dense (X, Y) float32 level is stored as two
// (X, Y2) arrays, Y2 = ceil(Y/2).  With q = x % 2, red lives at y = 2j + q
// and black at y = 2j + 1 - q.  An odd Y (every 2^k + 1 level: nothing is
// padded) leaves one inert slot per row, y = Y: split writes 0 there, merge
// never reads it, and no mask covers it.  The neighbours of a red point at
// (x, j) are the black halves at E = B[x+1, j] and S = B[x, j+q]; of a black
// point, R[x+1, j] and R[x, j+1-q].  The boundary column y = Y-1 holds the
// non-zero Dirichlet data and reaches the halves like any other column.
//
// What bounds them on the card: device-memory traffic, 8 B per dense
// point.  One thread per slot (split) or dense point (merge), launched as
// rows (threads along j, blockIdx.z = x), so a thread finds its point
// without integer division.

#include <cuda_runtime.h>

#include "stencil.cuh"     // row_grid, row_block, row_launch_ok

namespace {

__global__ void split2d_kernel(const float* __restrict__ v,
                               float* __restrict__ r, float* __restrict__ b,
                               int X, int Y, int Y2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= Y2) return;
  const int x = blockIdx.z;
  const int q = x & 1;
  const long long row = (long long)x * Y;
  const long long i = (long long)x * Y2 + j;
  const int yr = 2 * j + q;
  const int yb = 2 * j + 1 - q;
  r[i] = yr < Y ? v[row + yr] : 0.0f;
  b[i] = yb < Y ? v[row + yb] : 0.0f;
}

// one thread per dense point: coalesced writes
__global__ void merge2d_kernel(const float* __restrict__ r,
                               const float* __restrict__ b,
                               float* __restrict__ v, int X, int Y,
                               int Y2) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (y >= Y) return;
  const int x = blockIdx.z;
  const long long i = (long long)x * Y2 + (y >> 1);
  v[(long long)x * Y + y] = ((y & 1) == (x & 1)) ? r[i] : b[i];
}

}  // namespace

extern "C" {

int pdemg_split2d(const float* v, float* r, float* b, int X, int Y,
                  void* stream) {
  const int Y2 = (Y + 1) / 2;
  if (!row_launch_ok(X, 1)) return (int)cudaErrorInvalidConfiguration;
  split2d_kernel<<<row_grid(X, 1, Y2), row_block(Y2), 0,
                   (cudaStream_t)stream>>>(v, r, b, X, Y, Y2);
  return (int)cudaGetLastError();
}

int pdemg_merge2d(const float* r, const float* b, float* v, int X, int Y,
                  void* stream) {
  const int Y2 = (Y + 1) / 2;
  if (!row_launch_ok(X, 1)) return (int)cudaErrorInvalidConfiguration;
  merge2d_kernel<<<row_grid(X, 1, Y), row_block(Y), 0,
                   (cudaStream_t)stream>>>(r, b, v, X, Y, Y2);
  return (int)cudaGetLastError();
}

}  // extern "C"
