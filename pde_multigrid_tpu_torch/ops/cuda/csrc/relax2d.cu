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
// point (4 read, 4 written).
//
// split2d_kernel: one thread per slot pair, launched as rows (threads
// along j, blockIdx.z = x), so a thread finds its point without integer
// division; two loads in flight a thread (80 % of the byte bound at
// 4097^2 on an H100).
//
// merge2d_kernel (row 15), redesigned: its first form, a thread per dense
// point, had one 4-byte load in flight a thread and reached 48 % of the
// bound.  Now the dense level is one flat array of X Y floats, cut into
// quads aligned to 16 bytes (a scalar head of at most 3 points before the
// first, a tail of at most 3 after the last: with Y odd a dense row starts
// on a 16-byte boundary only every fourth row, so quads straddle rows).
// A thread takes Q quads, the lanes of a warp consecutive quads, issues all
// their 4 Q loads before its first store and writes each quad with one
// 16-byte store.  A quad finds its row by one 32-bit division.  A warp's
// loads from one half are two 256-byte spans at an 8-byte stride, which the
// L1 merges: each half is read from device memory once.  The grid is sized
// to the card (kMergeCtasPerSm CTAs an SM, a walk over the quads), not to
// X.  Q = kMergeDeep where the level's quads fill the card's resident
// threads that many times over (4097^2), else 1, so that a smaller level
// (2049^2 and down, which the L2 holds) spreads over every SM.  The inert
// slot y = Y of an odd row stays unread.

#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kMergeThreads = 256;
constexpr int kMergeCtasPerSm = 8;  // 2048 threads an SM
constexpr int kMergeDeep = 8;       // quads in flight a thread, large levels

// The dense point (x, y) from the halves: red where x + y is even.
__device__ __forceinline__ float merged_at(const float* __restrict__ r,
                                           const float* __restrict__ b,
                                           unsigned x, unsigned y,
                                           unsigned Y2) {
  const float* h = ((x ^ y) & 1u) ? b : r;
  return h[x * Y2 + (y >> 1)];
}

// n = X Y dense points, `head` of them before the first 16-byte-aligned
// quad of v, `nquads` quads after them, the rest the tail.
template <int Q>
__global__ void __launch_bounds__(kMergeThreads)
    merge2d_kernel(const float* __restrict__ r, const float* __restrict__ b,
                   float* __restrict__ v, unsigned Y, unsigned Y2,
                   unsigned n, unsigned head, unsigned nquads) {
  if (blockIdx.x == 0 && threadIdx.x < 8) {  // the head and the tail
    const unsigned t = threadIdx.x;
    const unsigned i = t < 4 ? t : head + 4 * nquads + t - 4;
    if (t < 4 ? i < head : i < n) {
      const unsigned x = i / Y;
      v[i] = merged_at(r, b, x, i - x * Y, Y2);
    }
  }
  constexpr unsigned kSpan = kMergeThreads * Q;
  for (unsigned q0 = blockIdx.x * kSpan + threadIdx.x; q0 < nquads;
       q0 += gridDim.x * kSpan) {
    float w[Q][4];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const unsigned q = q0 + k * kMergeThreads;
      if (q < nquads) {
        const unsigned i = head + 4 * q;
        unsigned x = i / Y;
        unsigned y = i - x * Y;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[k][e] = merged_at(r, b, x, y, Y2);
          if (++y == Y) {  // the quad runs on into the next row
            y = 0;
            ++x;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const unsigned q = q0 + k * kMergeThreads;
      if (q < nquads) {
        *reinterpret_cast<float4*>(v + head + 4 * q) =
            make_float4(w[k][0], w[k][1], w[k][2], w[k][3]);
      }
    }
  }
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
  if (X < 1 || Y < 1) return (int)cudaErrorInvalidValue;
  const unsigned long long n = (unsigned long long)X * Y;
  if (n > 0xffffffffull) return (int)cudaErrorInvalidValue;
  const unsigned skew = (unsigned)(reinterpret_cast<uintptr_t>(v) % 16);
  if (skew % 4) return (int)cudaErrorMisalignedAddress;
  unsigned head = (16 - skew) % 16 / 4;  // points before the first quad
  if (head > n) head = (unsigned)n;
  const unsigned nquads = (unsigned)((n - head) / 4);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const unsigned resident = (unsigned)sms * kMergeCtasPerSm * kMergeThreads;
  const bool deep = nquads >= resident * kMergeDeep;
  const unsigned span = kMergeThreads * (deep ? kMergeDeep : 1);
  unsigned ctas = (nquads + span - 1) / span;
  if (ctas > (unsigned)(sms * kMergeCtasPerSm)) ctas = sms * kMergeCtasPerSm;
  if (ctas < 1) ctas = 1;  // the head and tail alone
  const unsigned Y2 = (unsigned)((Y + 1) / 2);
  if (deep) {
    merge2d_kernel<kMergeDeep><<<ctas, kMergeThreads, 0,
                                 (cudaStream_t)stream>>>(
        r, b, v, (unsigned)Y, Y2, (unsigned)n, head, nquads);
  } else {
    merge2d_kernel<1><<<ctas, kMergeThreads, 0, (cudaStream_t)stream>>>(
        r, b, v, (unsigned)Y, Y2, (unsigned)n, head, nquads);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
