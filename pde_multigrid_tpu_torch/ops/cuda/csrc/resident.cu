// Dense red-black Gauss-Seidel over a whole small padded 2D level, all
// sweeps of a relax leg in one launch (sm_90a), for the HJB minimum-time
// equation (upwind scheme).
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_resident_relax
// on the HJB 513^2 path's levels 257^2 down to 3^2.  (Its 2D Lyapunov
// levels are the dense form of csrc/color_slab2d_shard.cu's leg.)  A
// half-sweep there is far shorter than a host launch: with one launch per
// half-sweep the legs would be launch-bound.  So, as the Pallas kernel keeps
// the level in VMEM for the whole leg, this kernel keeps it on chip for the
// whole leg.  Device memory is read once at the start of the leg and written
// once at its end.  What bounds it: barrier and instruction latency, not
// bytes.
//
// HJB (resident2d_hjb_kernel): the update reads both x neighbours, both y
// neighbours and four per-column coefficients (hjb2d.cuh).  Shared memory
// holds v, f and the update mask (the interior without the pinned target
// ball), 9 B per point, and the four coefficient columns; storing the
// coefficients per point would not fit at 257^2.  The CTA count is set at
// launch: one CTA (block barriers) where a color fits one pass of its
// threads (33^2 and below: 140 of the 176 legs of the 513^2 FMG step), a
// cluster of 8 above (65^2 to 257^2, 76 KB per CTA at 257^2), where a CTA
// reads the previous CTA's last row and the next CTA's first row through
// distributed shared memory.  Bytes per point per
// leg: 9 read (v, f, mask) + 4 written.
//
// Update form: the Pallas kernel's v + m * (kernel_update - v); red are the
// interior points with (x + y) even.  Points off the color or the mask are
// not written (the Pallas form adds m * (...) = 0 to them).  Built with
// --fmad=false, in the plain version's operation order: bitwise equal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hjb2d.cuh"       // HJB2D, hjb_update

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 8;  // the portable cluster size
constexpr int kThreads = 1024;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may hold

// Shared memory of the HJB kernel for `rows` rows of Y points: v, f, the
// four coefficient columns, the mask bytes.
inline size_t hjb_smem(int rows, int Y) {
  return (size_t)rows * Y * (2 * sizeof(float) + 1) + 4 * (size_t)Y * sizeof(float);
}

// the barrier between half-sweeps: the block's, or the cluster's
__device__ __forceinline__ void level_sync(int nctas) {
  if (nctas > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    resident2d_hjb_kernel(float* __restrict__ v, const float* __restrict__ f,
                          int X, int Y, int rows, int nctas, int nsweeps,
                          HJB2D p) {
  const int rank = nctas > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int x0 = rank * rows;
  const int nr = max(0, min(rows, X - x0));
  extern __shared__ float smem[];
  const int n = rows * Y;
  float* sv = smem;
  float* sf = sv + n;
  float* sc1 = sf + n;
  float* ss1 = sc1 + Y;
  float* sinv = ss1 + Y;
  float* sact = sinv + Y;
  uint8_t* sm = reinterpret_cast<uint8_t*>(sact + Y);

  for (int i = threadIdx.x; i < nr * Y; i += blockDim.x) {
    const long long g = (long long)x0 * Y + i;
    sv[i] = v[g];
    sf[i] = f[g];
    sm[i] = p.mask[g];
  }
  for (int y = threadIdx.x; y < Y; y += blockDim.x) {
    sc1[y] = p.c1[y];
    ss1[y] = p.s1[y];
    sinv[y] = p.inv_in[y];
    sact[y] = p.inv_act[y];
  }
  level_sync(nctas);  // every CTA loaded before any reads a neighbor's rows
  // a masked point never lies on the level's first or last row, so these
  // are read only where they exist
  const float* next = nullptr;
  const float* prev = nullptr;
  if (nctas > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (rank + 1 < nctas) next = cluster.map_shared_rank(sv, rank + 1);
    if (rank > 0) prev = cluster.map_shared_rank(sv, rank - 1) + (rows - 1) * Y;
  }

  // each thread walks slots (lx, k) of one color, y = 2k + ((x + c) & 1),
  // stepping blockDim slots at a time without division
  const int Yh = (Y + 1) / 2;
  const int dq = blockDim.x / Yh;
  const int dr = blockDim.x - dq * Yh;
  const int lx0 = threadIdx.x / Yh;
  const int k0 = threadIdx.x - lx0 * Yh;
  for (int s = 0; s < nsweeps; ++s) {
    for (int color = 0; color < 2; ++color) {
      int lx = lx0, k = k0;
      while (lx < nr) {
        const int y = 2 * k + ((x0 + lx + color) & 1);
        const int i = lx * Y + y;
        if (y < Y && sm[i]) {
          const float e = lx + 1 < nr ? sv[i + Y] : next[y];
          const float w = lx > 0 ? sv[i - Y] : prev[y];
          const float upd = hjb_update(e, w, sv[i + 1], sv[i - 1], sf[i],
                                       sc1[y], ss1[y], sinv[y], sact[y], p.c2);
          const float old = sv[i];
          sv[i] = old + (upd - old);  // m = 1: v + m * (upd - v)
        }
        lx += dq;
        k += dr;
        if (k >= Yh) {
          k -= Yh;
          ++lx;
        }
      }
      level_sync(nctas);  // this color done before the other reads it
    }
  }
  for (int i = threadIdx.x; i < nr * Y; i += blockDim.x) {
    v[(long long)x0 * Y + i] = sv[i];
  }
}

int launch_resident_hjb(float* v, const float* f, int X, int Y, int nctas,
                        int nsweeps, const HJB2D& p, cudaStream_t stream) {
  if (nctas != 1 && nctas != kCtas) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = (X + nctas - 1) / nctas;
  const size_t smem = hjb_smem(rows, Y);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;  // once per process, outside any capture
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        resident2d_hjb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  // enough warps for one slot of each color per thread, at most 1024: the
  // small levels' barriers then span few warps
  const int slots = rows * ((Y + 1) / 2);
  int threads = (slots + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kThreads ? kThreads : threads);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nctas > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, resident2d_hjb_kernel, v, f,
                                           X, Y, rows, nctas, nsweeps, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pdemg_resident2d_hjb(float* v, const float* f, int X, int Y, int nctas,
                         int nsweeps, const HJB2D* p, void* stream) {
  return launch_resident_hjb(v, f, X, Y, nctas, nsweeps, *p,
                             (cudaStream_t)stream);
}

}  // extern "C"
