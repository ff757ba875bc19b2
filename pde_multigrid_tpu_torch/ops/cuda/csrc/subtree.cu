// The fused coarse-subtree V-cycle for 3D wrap-storage Poisson levels
// (sm_90a): a whole V-cycle rooted at a small level, every level below it
// held in shared memory, in one launch.
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/subtree.py:_build  (subtree.py:350)
// on the 3D presets' coarse levels: every V-cycle rooted at 64^3 or below
// (FMG(2, 3000, 3000) at 129^3 runs 14 of them per step).  It computes
// what the port's unfused chain computes, in the same order:
//
//   vcycle(k): relax nu1; if k is not the coarsest: r = m_int (f - L v),
//              f[k+1] = R r (full weighting, injection on the coarse
//              boundary planes), v[k+1] = 0, vcycle(k + 1) mu times,
//              v += m_int P v[k+1] (trilinear, periodic); relax nu2
//
// (mu = 1 a V-cycle, 2 a W-cycle, at run time like nu: a launch takes
// the V-cycle's two straight loops for mu = 1 and a walk of the levels
// with a visit counter a level above), or, with
// with_root_relax = 0, the coarse-grid correction of the root alone
// (subtree.py:_build(..., with_root_relax=False)).  A relax sweep is
// a red half-sweep (x + y + z even) then a black one, each point written
// old + (upd - old) with upd = Poisson.split_update of its neighbour pair
// sums, exactly the expression and operand order of relax.cu's
// half_sweep_kernel on the colour halves (red at y = 2j + q, q = (x + z)
// % 2, is the dense parity x + y + z even).  The residual, the restriction
// (x, then y, then z smoothing) and the prolongation (x, then y, then z
// interpolation, then the blend) keep the order of transfer.cu's kernels.
// Built with --fmad=false, the kernel equals the unfused chain of those
// kernels bit for bit, and so the plain version (ops/cuda/subtree.py).
// Red-black Gauss-Seidel lets any split of a half-sweep's points, in any
// order, give the same bits: a point of one colour reads only the other.
//
// Design.  One launch per V-cycle: one non-portable thread-block cluster
// of 16 CTAs when the root has more than 8^3 points (a 32^3 root runs
// faster on 16 than on 8: chip_smoke.py times both), else one CTA.  A
// level of more than 8^3 points is cut into x-slabs, one per CTA (64^3: 4
// planes a CTA, 32^3: 2, 16^3: 1); a level of at most 8^3 points lives
// whole on CTA 0, whose sweeps then take block barriers while the other
// CTAs wait at one cluster barrier for the whole small subtree.  Every
// level's v and f live in shared memory as colour halves (relax.cu's
// layout: a half-sweep reads the other half with consecutive threads on
// consecutive z, free of bank conflicts), the root's f loaded once beside
// its v: at a 64^3 root 64 KB of v and 64 KB of f a CTA, 8 + 8 KB of 32^3,
// 1 + 1 KB of 16^3, 32 KB of halo planes, and on CTA 0 the levels 8^3 ...
// 2^3, 4.6 KB more (182.6 KB of the 227).  The correction-only variant
// holds the root's v too and reads its f once, from device memory, in the
// residual.  The layout (which levels are split, each array's offset) is
// decided by the caller (ops/cuda/subtree.py `layout`) and passed in
// SubtreeParams.
//
// A half-sweep: each thread walks a run of up to four z-pairs along x
// (the CTA's slab, or a four-plane chunk of a level on CTA 0), keeping
// the run's x-neighbours of the other colour in registers: six 8-byte
// loads serve the x-pairs, the own-plane y-term and the inner z-term of
// eight points, then four 4-byte loads a pair (the other y-terms, the
// outer z-terms) and an 8-byte load of f and of the old values, and one
// 8-byte store; all from this CTA's shared memory, the level's constants
// in registers, no branch (a point off the updated ones keeps its old
// value).  A split level's slab ends read the neighbours' planes from
// halo planes that the neighbours copy in after each half-sweep (Halo: a
// bulk copy of one plane of one colour per neighbour, completing on the
// receiver's mbarrier), so the half-sweeps of a split level synchronise
// with the two x-neighbours only and read no distributed shared memory.
// Full cluster barriers remain where a phase reads more than the adjacent
// planes or changes level: after the load, after each split level's relax
// leg, after each transfer, and around CTA 0's small levels.  The level
// views, the relax leg (these half-sweeps and Halo), the transfers'
// addressing and the root's copies are halves3d.cuh's, shared with
// resident3d.cu's whole-leg kernel.
//
// Bytes and operations per V-cycle: the root's v read and written and its
// f read, 12 B per root point (3 MB at 64^3) from device memory; 13 float
// operations per updated point and sweep on every level (3 pair sums, 3
// products and 3 sums, the negation, the scale, the blend's difference and
// sum), (nu1 + nu2) sweeps (the coarsest level's too), about 8/7 of the
// root's count in all: 2.2e10 at a 64^3 root with nu = 3000 (0.33 ms at
// 67 TFLOP/s).  What bounds it on the card is neither: each half-sweep
// waits for the one before it, on 16 of the card's 132 SMs, then for its
// halos (or a block barrier on CTA 0), 12 000 times a level at nu = 3000.

// Wrap storage: indices wrap modulo the extent (all extents are powers of
// two, so a mask does it); plane 0 of each axis is the zero boundary that
// both ends share, and the masks (x, y, z >= 1) never update it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "halves3d.cuh"  // SubLevel, View, relax_level, Halo, root_copy

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may hold
// the halo exchange's two mbarriers (static shared memory); the dynamic
// shared memory gets the rest (ops/cuda/subtree.py MAX_SMEM_BYTES)
constexpr int kSyncBytes = 16;
constexpr int kMaxDynSmem = kMaxSmem - kSyncBytes;

// ops/cuda/subtree.py SubtreeParams
struct SubtreeParams {
  int nlev;
  int nu1, nu2;
  int mu;  // visits of each level below the root per correction
  int with_root_relax;
  int nctas;       // CTAs of the launch: one cluster of 8 or 16, or 1
  int threads;     // threads per CTA
  int smem_bytes;  // dynamic shared memory per CTA
  int halo_off;    // a split root: float offset of the halo planes, 2
  int halo_plane;  // colours x 2 sides of halo_plane floats each
  SubLevel lev[kMaxLevels];
};

// m_int * (f - L v) at (x, y, z) from its three v planes and its f plane,
// in stencil.cuh residual_at's order.
__device__ __forceinline__ float residual_pt(const float* vm, const float* v0,
                                             const float* vp, const float* f0,
                                             int x, int y, int z,
                                             const View& w,
                                             const SubLevel& L) {
  const int xm = (x - 1) & (w.X - 1), xp = (x + 1) & (w.X - 1);
  const int ym = (y - 1) & (w.Y - 1), yp = (y + 1) & (w.Y - 1);
  const int zm = (z - 1) & (w.Z - 1), zp = (z + 1) & (w.Z - 1);
  const float c = at_pt(v0, w.vdev, x, y, z, w);
  const float c2 = 2.0f * c;
  float t0 = at_pt(vm, w.vdev, xm, y, z, w) - c2;
  t0 = t0 + at_pt(vp, w.vdev, xp, y, z, w);
  float lv = t0 * L.w0;
  float t1 = at_pt(v0, w.vdev, x, ym, z, w) - c2;
  t1 = t1 + at_pt(v0, w.vdev, x, yp, z, w);
  lv = lv + t1 * L.w1;
  float t2 = at_pt(v0, w.vdev, x, y, zm, w) - c2;
  t2 = t2 + at_pt(v0, w.vdev, x, y, zp, w);
  lv = lv + t2 * L.w2;
  const float m = (x >= 1 && y >= 1 && z >= 1) ? 1.0f : 0.0f;
  return m * (at_pt(f0, w.fdev, x, y, z, w) - lv);
}

// Residual + full weighting of fine level F into the coarse level C's f on
// the coarse planes this CTA owns, and C's v set to zero there: the
// expression order of transfer.cu's residual_restrict_kernel.
__device__ __forceinline__ void restrict_residual(const View& F,
                                                  const SubLevel& LF,
                                                  const View& C, int rank) {
  if (C.nx == 0) return;
  const int n = C.nx << C.lyz;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int K = i & (C.Z - 1);
    const int J = (i >> C.lz) & (C.Y - 1);
    const int Il = i >> C.lyz;
    const int I = C.x0 + Il;
    const int x = 2 * I, y = 2 * J, z = 2 * K;
    const float* vp[5];
    const float* fp[3];
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      vp[d] = plane_of(F.v, F.vdev, (x + d - 2) & (F.X - 1), F, rank);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      fp[d] = plane_of(F.f, F.fdev, (x + d - 1) & (F.X - 1), F, rank);
    }
    // the residual at fine (x + dx, yy, zz), dx in {-1, 0, 1}
    auto src = [&](int dx, int yy, int zz) {
      return residual_pt(vp[dx + 1], vp[dx + 2], vp[dx + 3], fp[dx + 1],
                         (x + dx) & (F.X - 1), yy, zz, F, LF);
    };
    const float inj = src(0, y, z);
    float smoothed = inj;
    const bool interior = I >= 1 && J >= 1 && K >= 1;
    if (interior) {
      float sy[3];
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        float sx[3];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int yy = y + dy - 1, zz = z + dz - 1;
          const float am = src(-1, yy, zz);
          const float a0 = src(0, yy, zz);
          const float ap = src(1, yy, zz);
          float s = 0.25f * am + 0.5f * a0;
          sx[dy] = s + 0.25f * ap;
        }
        float s = 0.25f * sx[0] + 0.5f * sx[1];
        sy[dz] = s + 0.25f * sx[2];
      }
      float s = 0.25f * sy[0] + 0.5f * sy[1];
      smoothed = s + 0.25f * sy[2];
    }
    const float mc = interior ? 1.0f : 0.0f;
    const int idx = own_at(false, Il, J, K, C);
    C.f[idx] = inj + mc * (smoothed - inj);
    C.v[idx] = 0.0f;
  }
}

// odd fine index -> 0.5 * (a[i] + a[i+1 mod m]), even -> a[i]
__device__ __forceinline__ float lerp_pair(float a, float b, int odd) {
  return odd ? 0.5f * (a + b) : a;
}

// v += m_int * P(coarse v) on the fine planes this CTA owns: the order of
// transfer.cu's prolong_blend_kernel in 'add' mode.
__device__ __forceinline__ void prolong_add(const View& F, const View& C,
                                            int rank) {
  if (F.nx == 0) return;
  const int n = F.nx << F.lyz;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int z = i & (F.Z - 1);
    const int y = (i >> F.lz) & (F.Y - 1);
    const int lx = i >> F.lyz;
    const int x = F.x0 + lx;
    const int ci = x >> 1, cj = y >> 1, ck = z >> 1;
    const int px = x & 1, py = y & 1, pz = z & 1;
    const int ci1 = (ci + 1) & (C.X - 1);
    const int cj1 = (cj + 1) & (C.Y - 1), ck1 = (ck + 1) & (C.Z - 1);
    const float* c0 = plane_of(C.v, C.vdev, ci, C, rank);
    const float* c1 = plane_of(C.v, C.vdev, ci1, C, rank);
    float ay[2];
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const int kk = dz ? ck1 : ck;
      float ax[2];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int jj = dy ? cj1 : cj;
        ax[dy] = lerp_pair(at_pt(c0, C.vdev, ci, jj, kk, C),
                           at_pt(c1, C.vdev, ci1, jj, kk, C), px);
      }
      ay[dz] = lerp_pair(ax[0], ax[1], py);
    }
    const float up = lerp_pair(ay[0], ay[1], pz);
    const float m = (x >= 1 && y >= 1 && z >= 1) ? 1.0f : 0.0f;
    const int idx = own_at(false, lx, y, z, F);
    const float base = F.v[idx];
    F.v[idx] = base + m * up;
  }
}

// A V-cycle (mu = 1) as two straight loops: down, relax nu1 (the
// coarsest: nu1 + nu2) and restrict the residual; up, prolong the coarse
// error, add it and relax nu2.  From the first level CTA 0 holds alone,
// the other CTAs wait at the cluster barrier before the prolongation back
// into a split level.
__device__ __forceinline__ void vcycle_walk(float* smem, float* vg,
                                            const float* fg,
                                            const SubtreeParams& p, int rank,
                                            Halo& halo) {
  const int K = p.nlev;
  for (int k = 0; k < K; ++k) {
    const SubLevel& L = p.lev[k];
    if (L.nctas == 1 && rank != 0) break;  // CTA 0 alone from here down
    const View w = view_of(L, rank, smem, vg, fg);
    if (k > 0 || p.with_root_relax) {
      relax_level(smem, w, L, k + 1 == K ? p.nu1 + p.nu2 : p.nu1, halo);
    }
    if (k + 1 < K) {
      const SubLevel& LC = p.lev[k + 1];
      restrict_residual(w, L, view_of(LC, rank, smem, vg, fg), rank);
      level_sync(LC.nctas);  // the coarse f and v written
    }
  }
  for (int k = K - 2; k >= 0; --k) {
    const SubLevel& L = p.lev[k];
    if (L.nctas == 1 && rank != 0) continue;
    if (L.nctas > 1 && p.lev[k + 1].nctas == 1) cg::this_cluster().sync();
    const View w = view_of(L, rank, smem, vg, fg);
    prolong_add(w, view_of(p.lev[k + 1], rank, smem, vg, fg), rank);
    level_sync(L.nctas);
    if (k > 0 || p.with_root_relax) {
      relax_level(smem, w, L, p.nu2, halo);
    }
  }
}

// A W-cycle (mu > 1), walked by every CTA alike: a visit of level k
// relaxes nu1 sweeps (the coarsest: nu1 + nu2), restricts the residual
// into level k + 1 (its v zeroed) and visits it mu times, then prolongs
// its error, adds it and relaxes nu2; the root is visited once.
// visits[k] counts level k's visits of the current correction.  A CTA
// other than 0 does nothing on the levels CTA 0 holds alone: it walks
// them and waits at the cluster barrier before the prolongation back into
// a split level.  With mu = 1 the walk is vcycle_walk's order; it is kept
// apart because its loop state costs the V-cycle's relax legs registers
// (a separate instantiation, chosen per launch).
__device__ __forceinline__ void wcycle_walk(float* smem, float* vg,
                                            const float* fg,
                                            const SubtreeParams& p, int rank,
                                            Halo& halo) {
  const int K = p.nlev;
  int visits[kMaxLevels];
  int k = 0;
  bool down = true;  // a visit of level k starts
  for (;;) {
    const SubLevel& L = p.lev[k];
    const View w = view_of(L, rank, smem, vg, fg);
    if (down) {
      const bool mine = L.nctas > 1 || rank == 0;
      if (mine && (k > 0 || p.with_root_relax)) {
        relax_level(smem, w, L, k + 1 == K ? p.nu1 + p.nu2 : p.nu1, halo);
      }
      if (k + 1 < K) {
        const SubLevel& LC = p.lev[k + 1];
        if (mine) {
          restrict_residual(w, L, view_of(LC, rank, smem, vg, fg), rank);
          level_sync(LC.nctas);  // the coarse f and v written
        }
        visits[++k] = 0;
        continue;
      }
      down = false;  // the coarsest level's visit is over
    }
    // level k's visit is over: visit it again, or go back up to k - 1
    if (k == 0) break;
    if (++visits[k] < p.mu) {
      down = true;
      continue;
    }
    --k;
    const SubLevel& LF = p.lev[k];
    // the other CTAs wait here while CTA 0 runs the levels it holds alone
    if (LF.nctas > 1 && L.nctas == 1) cg::this_cluster().sync();
    if (LF.nctas == 1 && rank != 0) continue;
    const View wf = view_of(LF, rank, smem, vg, fg);
    prolong_add(wf, w, rank);
    level_sync(LF.nctas);
    if (k > 0 || p.with_root_relax) {
      relax_level(smem, wf, LF, p.nu2, halo);
    }
  }
}

template <bool W>
__global__ void __launch_bounds__(kThreads)
    subtree_kernel(float* vg, const float* fg,
                   const __grid_constant__ SubtreeParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bar[2];  // Halo::bar
  const int rank = p.nctas > 1 ? (int)cg::this_cluster().block_rank() : 0;
  Halo halo = {smem + p.halo_off, p.halo_plane, bar, 0u,
               (rank + p.nctas - 1) % p.nctas, (rank + 1) % p.nctas};
  if (p.nctas > 1 && threadIdx.x == 0) halo_init(bar);
  const View root = view_of(p.lev[0], rank, smem, vg, fg);
  const long long at0 = (long long)root.x0 << root.lyz;
  root_copy(root, root.v, vg + at0, true);
  if (!root.fdev) {
    root_copy(root, root.f, const_cast<float*>(fg) + at0, true);
  }
  // every CTA loaded (and running, its barriers initialised) before any
  // reads another's planes
  level_sync(p.nctas);
  if constexpr (W) {
    wcycle_walk(smem, vg, fg, p, rank, halo);
  } else {
    vcycle_walk(smem, vg, fg, p, rank, halo);
  }
  // each phase above ended with the level's barrier (a cluster barrier on
  // a split root): no CTA reads another's shared memory from here on, so
  // each stores its own planes and leaves
  root_copy(root, root.v, vg + at0, false);
}

bool valid(const SubtreeParams& p) {
  if (p.nlev < 1 || p.nlev > kMaxLevels) return false;
  if (p.nctas != 1 && p.nctas != 8 && p.nctas != 16) return false;
  if (p.threads < 32 || p.threads > kThreads || p.threads % 32) return false;
  if (p.smem_bytes < 0 || p.smem_bytes > kMaxDynSmem) return false;
  if (p.nu1 < 0 || p.nu2 < 0 || p.mu < 1) return false;
  if (p.with_root_relax != 0 && p.with_root_relax != 1) return false;
  if (p.lev[0].nctas != p.nctas) return false;  // a split root, or one CTA
  const int lc = p.nctas == 16 ? 4 : (p.nctas == 8 ? 3 : 0);
  const long long floats = p.smem_bytes / (long long)sizeof(float);
  // the halo planes, 16-byte aligned for the bulk copies
  if (p.nctas > 1 && (p.halo_off < 0 || p.halo_off % 4 ||
                      p.halo_plane < 4 || p.halo_plane % 4 ||
                      p.halo_off + 4LL * p.halo_plane > floats)) {
    return false;
  }
  for (int k = 0; k < p.nlev; ++k) {
    const SubLevel& L = p.lev[k];
    if (L.lx < 1 || L.ly < 1 || L.lz < 1 || L.lx + L.ly + L.lz > 24) {
      return false;
    }
    if (L.nctas != 1 && L.nctas != p.nctas) return false;
    // the split levels come first, each at least one plane a CTA
    if (L.nctas > 1 && (L.lx < lc || (k > 0 && p.lev[k - 1].nctas == 1))) {
      return false;
    }
    // a split level's planes are copied whole into the halos
    if (L.nctas > 1 && (L.v_off % 4 || L.ly + L.lz < 3 ||
                        (1 << (L.ly + L.lz - 1)) > p.halo_plane)) {
      return false;
    }
    // v in shared memory; f too, but the correction variant's root's;
    // 8-byte aligned for the sweeps' z-pairs
    if (L.v_off < 0 || L.v_off % 2 || (L.f_off >= 0 && L.f_off % 2)) {
      return false;
    }
    if (L.f_off < 0 && (k > 0 || p.with_root_relax)) return false;
    // this CTA's planes of v and f inside the dynamic shared memory
    const long long n = 1LL << (L.lx - (L.nctas > 1 ? lc : 0) + L.ly + L.lz);
    if (L.v_off + n > floats) return false;
    if (L.f_off >= 0 && L.f_off + n > floats) return false;
  }
  return true;
}

using Kernel = void (*)(float*, const float*, const SubtreeParams);

// The launch's instantiation: the V-cycle's straight loops, or the walk.
Kernel kernel_for(const SubtreeParams& p) {
  return p.mu > 1 ? subtree_kernel<true> : subtree_kernel<false>;
}

// The kernels' attributes: the shared memory they may take, and clusters
// past the portable 8 CTAs.  Once per process, outside any capture.
cudaError_t opt_in() {
  static const cudaError_t status = [] {
    const Kernel kernels[2] = {subtree_kernel<false>, subtree_kernel<true>};
    for (Kernel k : kernels) {
      cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
      if (e != cudaSuccess) return e;
      e = cudaFuncSetAttribute(
          k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
  return status;
}

struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(const SubtreeParams& p, cudaStream_t stream) {
    cfg.gridDim = dim3(p.nctas, 1, 1);
    cfg.blockDim = dim3(p.threads, 1, 1);
    cfg.dynamicSmemBytes = p.smem_bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.nctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = p.nctas > 1 ? 1 : 0;
  }
};

int launch_subtree(float* v, const float* f, const SubtreeParams* p,
                   cudaStream_t stream) {
  if (!valid(*p)) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  Launch l(*p, stream);
  e = cudaLaunchKernelEx(&l.cfg, kernel_for(*p), v, f, *p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int max_clusters(const SubtreeParams* p, int* clusters) {
  if (!valid(*p)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = opt_in();
  if (e != cudaSuccess) return (int)e;
  Launch l(*p, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel_for(*p),
                                             &l.cfg);
}

}  // namespace

extern "C" {

// One fused V-cycle (or coarse-grid correction) rooted at the level of v
// and f (device memory, the root's full arrays); v is updated in place.
// Default visibility spelled out: the host compiler hides a function whose
// body launches a kernel taking a type of this file's unnamed namespace.
__attribute__((visibility("default"))) int pdemg_subtree(
    float* v, const float* f, const SubtreeParams* p, void* stream) {
  return launch_subtree(v, f, p, (cudaStream_t)stream);
}

// How many clusters of the launch `p` the card can hold at once (0: it
// refuses the cluster), into *clusters; a CUDA error code.
__attribute__((visibility("default"))) int pdemg_subtree_clusters(
    const SubtreeParams* p, int* clusters) {
  return max_clusters(p, clusters);
}

}  // extern "C"
