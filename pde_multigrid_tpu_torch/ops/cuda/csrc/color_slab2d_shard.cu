// One chunk of t red-black sweeps on one shard's extended color-split
// halves of a padded 2D Lyapunov level (sm_90a): the per-shard engine of
// the sharded 2D solve (parallel/halo.py, engine "split2d").
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_color_slab_2d_shard
//
// Input: the red and black halves (layout of csrc/relax2d.cu, in the
// global colour convention: q = (g0 + x) % 2) and their RHS halves of an
// extended slab of XE >= x_loc + 2t rows, Y2 slots each: the shard's x_loc
// owned rows followed by the first rows of its right neighbour.  Lyapunov's
// stencil is one-sided (a red point at (x, j) reads B[x+1, j] and
// B[x, j+q]; a black one R[x+1, j] and R[x, j+1-q]), so the halo sits on
// the +x side alone.  g0 is the global row of ext row 0; the coefficients,
// the colour and the interior test come from the global row g = g0 + x,
// with the arithmetic of half_sweep2d_kernel (lyapunov2d.cuh).  Output: the
// exact owned x_loc rows of both halves, written to ro / bo, which must not
// overlap the inputs (tiles read rows that other tiles own).
//
// Design (slab2d.cu's, not the Pallas kernel's full-row slabs): the owned
// region is cut into kBX x kBJ tiles, one CTA each (4097^2 on one rank:
// 129 x 33 CTAs).  A CTA loads its tile and a halo of 2t rows and 2t slots
// on the +x and +j sides (the only directions the stencil reads) into
// shared memory, runs t red+black sweeps there on every loaded point whose
// reads stay inside the loaded region or its zero-filled edge, and writes
// its owned points.  A stale value spreads one row or slot per half-sweep
// toward -x / -j, so after t sweeps the owned points, 2t from the far
// edges, are exact: the trapezoid argument of the Pallas kernel
// (relax.py:2898-2903).  Rows past XE and slots past Y2 load as 0: no
// owned point depends on them (a point reading slot Y2 is the inert slot
// or the boundary column, never interior).  Global boundary and padding
// rows are never interior, so they block the ring-wrapped halo of the
// last shard, as in JAX.  t is a run-time loop bound: templates unrolled
// per t cost build time.
//
// What bounds it: per point and chunk it reads four halves and writes two
// (24 B), plus the tile halo ((32 + 2t)(64 + 2t) / (32 * 64) = 1.41 at
// t = 4); per point and sweep about 20 float operations (one IEEE
// division) recomputing the coefficients from coordinates, and the
// dependent shared-memory loads between the 2t block barriers.  Making it
// fast (coefficients kept in shared memory, wider tiles, TMA loads) is
// later work.
//
// Masked points are never written (the select form), so they stay bitwise;
// with --fmad=false the owned output equals the plain version
// (relax2d.color_slab2d_shard_plain) bit for bit.

#include <cuda_runtime.h>

#include "lyapunov2d.cuh"  // Lyap2D, lyap_coef, lyap_update, interior

namespace {

constexpr int kBX = 32;  // owned rows per tile
constexpr int kBJ = 64;  // owned half slots per tile
constexpr int kThreads = 256;

// floats of shared memory a tile needs at t sweeps: r and b with one zero
// row and one zero column past the loaded region, fr and fb
inline size_t smem_floats(int t) {
  const size_t RX = kBX + 2 * t;
  const size_t S = kBJ + 2 * t + 1;
  return (4 * RX + 2) * S;
}

__global__ void __launch_bounds__(kThreads)
    color_slab2d_shard_kernel(const float* __restrict__ r,
                              const float* __restrict__ b,
                              const float* __restrict__ fr,
                              const float* __restrict__ fb,
                              float* __restrict__ ro, float* __restrict__ bo,
                              int XE, int x_loc, int Y2, int g0, int t,
                              Lyap2D p) {
  extern __shared__ float smem[];
  const int RX = kBX + 2 * t;  // loaded rows
  const int RJ = kBJ + 2 * t;  // loaded slots per row
  const int S = RJ + 1;        // row stride
  float* sr = smem;
  float* sb = sr + (RX + 1) * S;
  float* sfr = sb + (RX + 1) * S;
  float* sfb = sfr + RX * S;
  const int x0 = blockIdx.y * kBX;
  const int j0 = blockIdx.x * kBJ;

  for (int i = threadIdx.x; i < (RX + 1) * S; i += blockDim.x) {
    const int lx = i / S;
    const int lj = i - lx * S;
    const int x = x0 + lx;
    const int j = j0 + lj;
    const bool in = lx < RX && lj < RJ && x < XE && j < Y2;
    const long long g = (long long)x * Y2 + j;
    sr[i] = in ? r[g] : 0.0f;
    sb[i] = in ? b[g] : 0.0f;
    if (lx < RX) {
      sfr[i] = in ? fr[g] : 0.0f;
      sfb[i] = in ? fb[g] : 0.0f;
    }
  }
  __syncthreads();

  for (int s = 0; s < t; ++s) {
    for (int color = 0; color < 2; ++color) {
      float* u = color == 0 ? sr : sb;        // the colour updated
      const float* w = color == 0 ? sb : sr;  // the other colour
      const float* fu = color == 0 ? sfr : sfb;
      for (int i = threadIdx.x; i < RX * RJ; i += blockDim.x) {
        const int lx = i / RJ;
        const int lj = i - lx * RJ;
        if (x0 + lx >= XE || j0 + lj >= Y2) continue;
        const int gx = g0 + x0 + lx;
        const int q = gx & 1;
        const int sft = color == 0 ? q : 1 - q;  // y = 2j + sft
        const int y = 2 * (j0 + lj) + sft;
        if (!interior(gx, y, p)) continue;
        const int k = lx * S + lj;
        const Coef c = lyap_coef(gx, y, p);
        // east (gx + 1, y) at slot j; south (gx, y + 1) at slot j + sft
        u[k] = lyap_update<true>(w[k + S], w[k + sft], fu[k], c);
      }
      __syncthreads();  // this colour done before the other reads it
    }
  }

  for (int i = threadIdx.x; i < kBX * kBJ; i += blockDim.x) {
    const int lx = i / kBJ;
    const int lj = i - lx * kBJ;
    const int x = x0 + lx;
    const int j = j0 + lj;
    if (x < x_loc && j < Y2) {
      const long long g = (long long)x * Y2 + j;
      ro[g] = sr[lx * S + lj];
      bo[g] = sb[lx * S + lj];
    }
  }
}

}  // namespace

extern "C" {

// One chunk: t sweeps on the (XE, Y2) ext halves r, b (RHS fr, fb), the
// owned x_loc rows out to ro, bo.
int pdemg_color_slab2d_shard(const float* r, const float* b, const float* fr,
                             const float* fb, float* ro, float* bo, int XE,
                             int x_loc, int Y2, int g0, int t,
                             const Lyap2D* p, void* stream) {
  if (t < 1 || x_loc < 1 || Y2 < 1 || XE < x_loc + 2 * t) {
    return (int)cudaErrorInvalidValue;
  }
  const int gy = (x_loc + kBX - 1) / kBX;
  if (gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_floats(t) * sizeof(float);
  if (smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory (t > 4); the
    // card refuses more than 227 KB (t > ~20) here
    const cudaError_t e = cudaFuncSetAttribute(
        color_slab2d_shard_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Y2 + kBJ - 1) / kBJ, gy, 1);
  color_slab2d_shard_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      r, b, fr, fb, ro, bo, XE, x_loc, Y2, g0, t, *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
