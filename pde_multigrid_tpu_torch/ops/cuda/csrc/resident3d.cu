// Whole-leg red-black Gauss-Seidel on a small 3D wrap-storage Poisson
// level (sm_90a): every sweep of a relax leg in one launch, the level held
// in shared memory for the whole leg.
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/relax.py:make_merged_resident_relax
//       (relax.py:595; dense in and out: 64^3, 32^3 and 16^3, the 3D wrap
//       levels with Z < 128 and Y Z % 128 == 0)
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_merged_relax
//       (relax.py:684; the same leg on colour halves in and out)
//   pde_multigrid_tpu/ops/pallas/relax.py:make_resident_relax
//       (relax.py:143; its 3D Poisson wrap levels, dense: 8^3, 4^3, 2^3)
// on the 3D FAS path, where no fused subtree claims these levels.  The
// merged (X, Y Z / 128, 128) view of the first two is TPU tiling only
// (whole lanes for a sub-lane Z) and has no counterpart here: the three
// differ only in their I/O and in the levels JAX gives them.
//
// What it computes: `nsweeps` sweeps, each a red half-sweep (x + y + z
// even) then a black one, every interior point (x, y, z >= 1) of the
// colour becoming v + (upd - v) with upd = Poisson.split_update of its
// neighbour pair sums: the expression and operand order of relax.cu's
// half_sweep_kernel (halves3d.cuh `half_sweep`, shared with subtree.cu).
// Pallas' dense v + m (merged_update - v) forms the same pair sums, a + b
// in the other order where the y-pair is gathered from j - 1 (exact:
// float addition commutes).  Built with --fmad=false, the leg equals its
// plain versions (ops/cuda/resident3d.py) and the row-9 chain of
// half-sweep launches bit for bit.
//
// Design (halves3d.cuh).  The level's v lives in shared memory as its
// colour halves (relax.cu's layout, consecutive threads on consecutive z:
// no bank conflicts), and f beside it in the same layout.  Up to
// LOCAL_MAX_POINTS (ops/cuda/resident3d.py) the level lives on one CTA
// with block barriers; above, on the smallest cluster whose CTAs hold v
// and f (32^3 on the portable 8 CTAs, 64^3 on a non-portable 16), each
// CTA an x-slab, the x +- 1 planes at a slab edge read through
// distributed shared memory, one cluster barrier per half-sweep.  Two I/O
// modes: dense v and f (split into halves on load, v merged back on
// store: rows 4 and 1), and v and f as colour halves (r, b, fr, fb: row
// 5's interface).  v is updated in place.
//
// Bytes per point per leg: v read and written, f read, 12 B; 13 float32
// operations per interior point (x, y, z >= 1) and sweep (3 pair sums, 3
// products and 3 sums, the negation, the scale, the blend's difference
// and sum).  At 64^3 and 100 sweeps: 3.1 MB (0.001 ms at 3.35 TB/s)
// against 3.2e8 operations (0.005 ms at 67 TFLOP/s): operation-bound on
// paper.  What bounds it on the
// card is neither: at most 16 of the card's 132 SMs, and a barrier per
// half-sweep (its latency, and that of the distributed shared-memory
// reads before it), as in subtree.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "halves3d.cuh"  // SubLevel, View, relax, root_copy

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may hold

// ops/cuda/resident3d.py Resident3DParams
struct Resident3DParams {
  SubLevel lev;    // v_off 0, f_off the points one CTA holds
  int nsweeps;
  int halves;      // 1: v and f as colour halves in device memory
  int threads;     // threads per CTA
  int smem_bytes;  // dynamic shared memory per CTA
};

// This CTA's planes of a level: device halves (r, b at the CTA's first
// plane) <-> the shared halves.
__device__ __forceinline__ void halves_copy(const View& w, float* halves,
                                            float* r, float* b,
                                            bool to_smem) {
  for (int i = threadIdx.x; i < w.hs; i += blockDim.x) {
    if (to_smem) {
      halves[i] = r[i];
      halves[w.hs + i] = b[i];
    } else {
      r[i] = halves[i];
      b[i] = halves[w.hs + i];
    }
  }
}

// vr/vb: v (dense in vr, or its halves); fr/fb: f likewise.
__global__ void __launch_bounds__(kThreads)
    resident3d_kernel(float* vr, float* vb, const float* fr,
                      const float* fb,
                      const __grid_constant__ Resident3DParams p) {
  extern __shared__ float smem[];
  const SubLevel& L = p.lev;
  const int rank = L.nctas > 1 ? (int)cg::this_cluster().block_rank() : 0;
  View w = view_of(L, rank, smem, vr, fr);
  // this CTA's first plane: dense, and in a half array
  const long long at0 = (long long)w.x0 << w.lyz;
  const long long ah0 = at0 >> 1;
  float* fr_own = const_cast<float*>(fr);
  if (p.halves) {
    halves_copy(w, w.v, vr + ah0, vb + ah0, true);
    halves_copy(w, w.f, fr_own + ah0, const_cast<float*>(fb) + ah0, true);
  } else {
    root_copy(w, w.v, vr + at0, true);
    root_copy(w, w.f, fr_own + at0, true);
  }
  // every CTA loaded (and running) before any reads another's planes
  level_sync(L.nctas);
  // each half-sweep ends with the level's barrier: after the last one no
  // CTA reads another's shared memory, so each stores and leaves
  relax(w, L, p.nsweeps, rank);
  if (p.halves) {
    halves_copy(w, w.v, vr + ah0, vb + ah0, false);
  } else {
    root_copy(w, w.v, vr + at0, false);
  }
}

bool valid(const Resident3DParams& p, bool halves_ptrs) {
  const SubLevel& L = p.lev;
  if (L.nctas != 1 && L.nctas != 8 && L.nctas != 16) return false;
  if (L.lx < 1 || L.ly < 1 || L.lz < 1 || L.lx + L.ly + L.lz > 24) {
    return false;
  }
  const int lc = L.nctas == 16 ? 4 : (L.nctas == 8 ? 3 : 0);
  if (L.lx < lc) return false;  // at least one plane a CTA
  if (p.threads < 32 || p.threads > kThreads || p.threads % 32) return false;
  if (p.nsweeps < 0 || (p.halves != 0 && p.halves != 1)) return false;
  if (p.halves != (int)halves_ptrs) return false;
  const long long n = 1LL << (L.lx - lc + L.ly + L.lz);  // points a CTA
  if (L.v_off != 0 || L.f_off != n) return false;
  return p.smem_bytes >= 8 * n && p.smem_bytes <= kMaxSmem;
}

int launch_resident3d(float* vr, float* vb, const float* fr,
                      const float* fb, const Resident3DParams* p,
                      cudaStream_t stream) {
  if (!valid(*p, vb != nullptr && fb != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  static bool opted_in = false;  // once per process, outside any capture
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        resident3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(resident3d_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int nctas = p->lev.nctas;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nctas, 1, 1);
  cfg.blockDim = dim3(p->threads, 1, 1);
  cfg.dynamicSmemBytes = p->smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nctas > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, resident3d_kernel, vr, vb, fr, fb, *p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One relax leg on the level of v and f (device memory, the whole level),
// v updated in place.  Dense: v and f, with vb and fb null.  Halves: v and
// f as their colour halves (vr, vb; fr, fb).  Default visibility spelled
// out: the host compiler hides a function whose body launches a kernel
// taking a type of this file's unnamed namespace.
__attribute__((visibility("default"))) int pdemg_resident3d(
    float* vr, float* vb, const float* fr, const float* fb,
    const Resident3DParams* p, void* stream) {
  return launch_resident3d(vr, vb, fr, fb, p, (cudaStream_t)stream);
}

}  // extern "C"
