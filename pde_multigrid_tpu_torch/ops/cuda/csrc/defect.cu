// The float32 ends of the bf16 defect-correction relax leg for 3D
// wrap-storage levels (sm_90a).
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/defect.py:make_residual_split
//       (rr, rb) = split(bf16(m_int * (f - L v)))
//   pde_multigrid_tpu/ops/pallas/defect.py:make_merge_fold
//       v = v + merge(float(er), float(eb))
// Between them the error halves are smoothed in bf16 (relax.cu
// error_leg_kernel, or timeskew.cu's error mode on the levels whose
// halves the card's shared memory does not hold); ops/cuda/defect.py
// strings the three together.  Halves layout as in relax.cu: with q = (x + z) % 2, red
// (parity 0) sits at dense y = 2j + q and black at y = 2j + 1 - q.
//
// What bounds these kernels on the card: device-memory traffic.
// residual_split reads v and f once (8 B per dense point; the six
// neighbours of v come from the caches) and writes 2 B per dense point;
// merge_fold reads 2 B of error and reads and writes 4 B of v per dense
// point (10 B).  The simple design: one thread per halves point (x, j, z),
// handling the dense pair y = 2j, 2j + 1, launched as rows (threads along
// z, coalesced; blockIdx.y = j, blockIdx.z = x, no index division).  The
// TPU kernels'
// 0/1 pick-matrix products exist only because strided sublane slices
// are unsupported on the TPU; here a thread indexes its two rows.
//
// Numerics: built with --fmad=false.  The residual is the residual
// kernel's arithmetic (stencil.cuh), rounded once to bf16 by
// __float2bfloat16_rn (round to nearest even, as torch's .to(bfloat16));
// the fold widens bf16 exactly (__bfloat162float) and adds once in f32.
// Both agree with their plain PyTorch versions (ops/cuda/defect.py) bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stencil.cuh"  // at, residual_at, row_grid, row_block

namespace {

__global__ void residual_split_kernel(const float* __restrict__ v,
                                      const float* __restrict__ f,
                                      __nv_bfloat16* __restrict__ rr,
                                      __nv_bfloat16* __restrict__ rb, int X,
                                      int Y2, int Z, float w0, float w1,
                                      float w2) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;  // row launch
  if (z >= Z) return;
  const int j = blockIdx.y;
  const int x = blockIdx.z;
  const int q = (x + z) & 1;
  const long long i = ((long long)x * Y2 + j) * Z + z;
  const int Y = 2 * Y2;
  const float r0 = residual_at(v, f, x, 2 * j, z, X, Y, Z, w0, w1, w2);
  const float r1 = residual_at(v, f, x, 2 * j + 1, z, X, Y, Z, w0, w1, w2);
  rr[i] = __float2bfloat16_rn(q ? r1 : r0);
  rb[i] = __float2bfloat16_rn(q ? r0 : r1);
}

// in place: each thread reads and writes only its own two dense points
__global__ void merge_fold_kernel(const __nv_bfloat16* __restrict__ er,
                                  const __nv_bfloat16* __restrict__ eb,
                                  float* __restrict__ v, int X, int Y2,
                                  int Z) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;  // row launch
  if (z >= Z) return;
  const int j = blockIdx.y;
  const int x = blockIdx.z;
  const int q = (x + z) & 1;
  const long long i = ((long long)x * Y2 + j) * Z + z;
  const int Y = 2 * Y2;
  const long long red = at(x, 2 * j + q, z, Y, Z);
  const long long black = at(x, 2 * j + 1 - q, z, Y, Z);
  v[red] = v[red] + __bfloat162float(er[i]);
  v[black] = v[black] + __bfloat162float(eb[i]);
}

}  // namespace

extern "C" {

int pdemg_residual_split(const float* v, const float* f, __nv_bfloat16* rr,
                         __nv_bfloat16* rb, int X, int Y2, int Z, float w0,
                         float w1, float w2, void* stream) {
  if (!row_launch_ok(X, Y2)) return (int)cudaErrorInvalidConfiguration;
  residual_split_kernel<<<row_grid(X, Y2, Z), row_block(Z), 0,
                          (cudaStream_t)stream>>>(v, f, rr, rb, X, Y2, Z, w0,
                                                  w1, w2);
  return (int)cudaGetLastError();
}

int pdemg_merge_fold(const __nv_bfloat16* er, const __nv_bfloat16* eb,
                     float* v, int X, int Y2, int Z, void* stream) {
  if (!row_launch_ok(X, Y2)) return (int)cudaErrorInvalidConfiguration;
  merge_fold_kernel<<<row_grid(X, Y2, Z), row_block(Z), 0,
                      (cudaStream_t)stream>>>(er, eb, v, X, Y2, Z);
  return (int)cudaGetLastError();
}

}  // extern "C"
