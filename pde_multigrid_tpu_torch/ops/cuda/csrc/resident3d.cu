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
// half_sweep_kernel.  Pallas' dense v + m (merged_update - v) forms the
// same pair sums, a + b in the other order where the y-pair is gathered
// from j - 1 (exact: float addition commutes).  Built with --fmad=false,
// the leg equals its plain versions (ops/cuda/resident3d.py) and the
// row-9 chain of half-sweep launches bit for bit.
//
// Design: the fused subtree's relax leg (halves3d.cuh `relax_level`, the
// very code subtree.cu runs on its levels).  The level's v and f live in
// shared memory as colour halves (relax.cu's layout).  A level of more
// than 8^3 points is cut into x-slabs over one non-portable cluster of 16
// CTAs (64^3: 4 planes a CTA, 32^3: 2, 16^3: 1), each CTA holding its v
// and f halves and 2 colours x 2 sides of halo planes (64 + 64 + 32 KB at
// 64^3); a half-sweep's thread walks a run of up to four z-pairs along x
// with the run's x-neighbours in registers, the slab ends read the halo
// planes that the x-neighbours bulk-copy in after each half-sweep
// (completing on this CTA's mbarrier), so a split level synchronises with
// its two neighbours only, and one cluster barrier ends the leg.  8^3 and
// below live on one CTA, runs of one plane with a block barrier a
// half-sweep; 2^3 keeps the port's first form, a point a thread
// (halves3d.cuh `relax`), which beat the runs there on the card.
// The layout (CTAs, threads, the halo planes' offset) is the caller's
// (ops/cuda/resident3d.py `layout`).  Two I/O modes: dense v and f (split
// into halves on load, v merged back on store: rows 4 and 1), and v and f
// as colour halves (r, b, fr, fb: row 5's interface).  v is updated in
// place.
//
// Bytes per point per leg: v read and written, f read, 12 B; 13 float32
// operations per interior point (x, y, z >= 1) and sweep (3 pair sums, 3
// products and 3 sums, the negation, the scale, the blend's difference
// and sum).  At 64^3 and 100 sweeps: 3.1 MB (0.001 ms at 3.35 TB/s)
// against 3.2e8 operations (0.005 ms at 67 TFLOP/s): operation-bound on
// paper.  What bounds it on the card is neither: at most 16 of the card's
// 132 SMs, and each half-sweep waiting for the one before it (its halo
// planes, or a block barrier), 2 nsweeps times a leg.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "halves3d.cuh"  // SubLevel, View, relax_level, Halo, root_copy

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may hold
// the halo exchange's two mbarriers (static shared memory); the dynamic
// shared memory gets the rest (ops/cuda/resident3d.py MAX_SMEM_BYTES)
constexpr int kSyncBytes = 16;
constexpr int kMaxDynSmem = kMaxSmem - kSyncBytes;
constexpr int kClusterCtas = 16;

// ops/cuda/resident3d.py Resident3DParams
struct Resident3DParams {
  SubLevel lev;    // v_off 0, f_off the points one CTA holds
  int nsweeps;
  int halves;      // 1: v and f as colour halves in device memory
  int threads;     // threads per CTA
  int smem_bytes;  // dynamic shared memory per CTA
  int halo_off;    // a split level: float offset of the halo planes, 2
  int halo_plane;  // colours x 2 sides of halo_plane floats each
  int run;         // the longest run of planes a thread walks: 1, 2 or 4;
                   // 0: a point a thread (halves3d.cuh `relax`, one CTA)
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
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar[2];  // Halo::bar
  const SubLevel& L = p.lev;
  const int n = L.nctas;
  const int rank = n > 1 ? (int)cg::this_cluster().block_rank() : 0;
  Halo halo = {smem + p.halo_off, p.halo_plane, bar, 0u,
               (rank + n - 1) % n, (rank + 1) % n};
  if (n > 1 && threadIdx.x == 0) halo_init(bar);
  const View w = view_of(L, rank, smem, vr, fr);
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
  // every CTA loaded (and running, its barriers initialised) before any
  // copies into another's halo planes
  level_sync(n);
  // the leg ends with the level's barrier (a cluster barrier on a split
  // level): no CTA touches another's shared memory after it, so each
  // stores its own planes and leaves
  if (p.run == 0) {
    relax(w, L, p.nsweeps, rank);
  } else {
    relax_level(smem, w, L, p.nsweeps, halo, p.run);
  }
  if (p.halves) {
    halves_copy(w, w.v, vr + ah0, vb + ah0, false);
  } else {
    root_copy(w, w.v, vr + at0, false);
  }
}

bool valid(const Resident3DParams& p, bool halves_ptrs) {
  const SubLevel& L = p.lev;
  if (L.nctas != 1 && L.nctas != kClusterCtas) return false;
  if (L.lx < 1 || L.ly < 1 || L.lz < 1 || L.lx + L.ly + L.lz > 24) {
    return false;
  }
  const bool split = L.nctas > 1;
  const int lc = split ? 4 : 0;
  if (L.lx < lc) return false;  // at least one plane a CTA
  if (p.threads < 32 || p.threads > kThreads || p.threads % 32) return false;
  if (p.nsweeps < 0 || (p.halves != 0 && p.halves != 1)) return false;
  if (p.run != 1 && p.run != 2 && p.run != kRun &&
      (p.run != 0 || L.nctas != 1)) {
    return false;
  }
  if (p.halves != (int)halves_ptrs) return false;
  const long long n = 1LL << (L.lx - lc + L.ly + L.lz);  // points a CTA
  if (L.v_off != 0 || L.f_off != n) return false;
  long long floats = 2 * n;
  if (split) {
    // the halo planes, a half's plane each, 16-byte aligned and sized for
    // the bulk copies
    const int hp = 1 << (L.ly + L.lz - 1);
    if (p.halo_off != floats || p.halo_plane != hp || hp % 4) return false;
    floats += 4LL * hp;
  } else if (p.halo_off != 0 || p.halo_plane != 0) {
    return false;
  }
  return p.smem_bytes == 4 * floats && p.smem_bytes <= kMaxDynSmem;
}

// The kernel's attributes: the shared memory it may take, and clusters
// past the portable 8 CTAs.  Once per process, outside any capture.
cudaError_t opt_in() {
  static const cudaError_t status = [] {
    cudaError_t e = cudaFuncSetAttribute(
        resident3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        resident3d_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
  }();
  return status;
}

struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(const Resident3DParams& p, cudaStream_t stream) {
    const int nctas = p.lev.nctas;
    cfg.gridDim = dim3(nctas, 1, 1);
    cfg.blockDim = dim3(p.threads, 1, 1);
    cfg.dynamicSmemBytes = p.smem_bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = nctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = nctas > 1 ? 1 : 0;
  }
};

int launch_resident3d(float* vr, float* vb, const float* fr,
                      const float* fb, const Resident3DParams* p,
                      cudaStream_t stream) {
  if (!valid(*p, vb != nullptr && fb != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  Launch l(*p, stream);
  e = cudaLaunchKernelEx(&l.cfg, resident3d_kernel, vr, vb, fr, fb, *p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int max_clusters(const Resident3DParams* p, int* clusters) {
  if (!valid(*p, p->halves != 0)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  Launch l(*p, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, resident3d_kernel,
                                             &l.cfg);
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

// How many clusters of the launch `p` the card can hold at once (0: it
// refuses the cluster), into *clusters; a CUDA error code.
__attribute__((visibility("default"))) int pdemg_resident3d_clusters(
    const Resident3DParams* p, int* clusters) {
  return max_clusters(p, clusters);
}

}  // extern "C"
