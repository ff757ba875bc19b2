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
//              boundary planes), v[k+1] = 0, vcycle(k + 1),
//              v += m_int P v[k+1] (trilinear, periodic); relax nu2
//
// or, with with_root_relax = 0, the coarse-grid correction of the root
// alone (subtree.py:_build(..., with_root_relax=False)).  A relax sweep is
// a red half-sweep (x + y + z even) then a black one, each point written
// old + (upd - old) with upd = Poisson.split_update of its neighbour pair
// sums, exactly the expression and operand order of relax.cu's
// half_sweep_kernel on the colour halves (red at y = 2j + q, q = (x + z)
// % 2, is the dense parity x + y + z even).  The residual, the restriction
// (x, then y, then z smoothing) and the prolongation (x, then y, then z
// interpolation, then the blend) keep the order of transfer.cu's kernels.
// Built with --fmad=false, the kernel equals the unfused chain of those
// kernels bit for bit, and so the plain version (ops/cuda/subtree.py).
//
// Design.  One launch per V-cycle: one thread-block cluster of 8 CTAs
// (512 threads each) when the root has more than 16^3 points, else one
// CTA.  A level of more than 16^3 points is cut into x-slabs, one per CTA;
// a level of at most 16^3 points lives whole on CTA 0, whose sweeps then
// take block barriers while the other CTAs wait at one cluster barrier for
// the whole small subtree.  Every level's v lives in shared memory as its
// colour halves (relax.cu's layout: a half-sweep reads the other half
// with consecutive threads on consecutive z, free of bank conflicts), and
// every deeper level's f (written by the restriction).  The root's f is
// read from device memory, served by the L2 (at a 64^3 root it would not
// fit beside the v: 128 KB of v per CTA, the levels below 33 KB on each CTA
// and 37 KB more on CTA 0).  The correction-only variant keeps the root's v
// in device memory too: it reads it once (residual) and writes it once
// (prolongation).  The layout
// (which levels are split, each array's offset) is decided by the caller
// (ops/cuda/subtree.py `layout`) and passed in SubtreeParams.  A point's
// x +- 1 neighbour plane lies in the neighbouring CTA at a slab edge and
// is read through distributed shared memory (cluster.map_shared_rank).
// One barrier ends each half-sweep, each transfer and the load.  The root
// is split into halves as it is loaded and merged as it is stored.  The
// level views, the half-sweep and the root's copies are halves3d.cuh's,
// shared with the whole-leg resident kernel (resident3d.cu).
//
// Bytes and operations per V-cycle: the root's v read and written and its
// f read, 12 B per root point (3 MB at 64^3) from device memory; 13 float
// operations per point and sweep on every level (3 pair sums, 3 products
// and 3 sums, the negation, the scale, the blend's difference and sum),
// (nu1 + nu2) sweeps (the coarsest level's too), about 8/7 of the root's
// count in all: 2.3e10 at a 64^3 root with nu = 3000.  What bounds it on the card is not bytes: the
// barriers (two per sweep and level, cluster-wide on the split levels) and
// the instruction rate of 8 of the card's 132 SMs (shared-memory loads:
// seven per updated point).
//
// Wrap storage: indices wrap modulo the extent (all extents are powers of
// two, so a mask does it); plane 0 of each axis is the zero boundary that
// both ends share, and the masks (x, y, z >= 1) never update it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "halves3d.cuh"  // SubLevel, View, half_sweep, relax, root_copy

namespace {

constexpr int kMaxLevels = 8;
constexpr int kCtas = 8;  // the portable cluster size
constexpr int kThreads = 512;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may hold

// ops/cuda/subtree.py SubtreeParams
struct SubtreeParams {
  int nlev;
  int nu1, nu2;
  int with_root_relax;
  int nctas;       // CTAs of the launch: kCtas (one cluster) or 1
  int threads;     // threads per CTA
  int smem_bytes;  // dynamic shared memory per CTA
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
    const int idx = own_at(F.vdev, lx, y, z, F);
    const float base = F.v[idx];
    F.v[idx] = base + m * up;
  }
}

__global__ void __launch_bounds__(kThreads)
    subtree_kernel(float* vg, const float* fg,
                   const __grid_constant__ SubtreeParams p) {
  extern __shared__ float smem[];
  const int rank = p.nctas > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int K = p.nlev;
  const View root = view_of(p.lev[0], rank, smem, vg, fg);
  float* vg_own = vg + ((long long)root.x0 << root.lyz);
  if (!root.vdev) root_copy(root, root.v, vg_own, true);
  // every CTA loaded (and running) before any reads another's planes
  level_sync(p.nctas);

  // down: relax nu1 (the coarsest: nu1 + nu2), restrict the residual
  for (int k = 0; k < K; ++k) {
    const SubLevel& L = p.lev[k];
    if (L.nctas == 1 && rank != 0) break;  // CTA 0 alone from here down
    const View w = view_of(L, rank, smem, vg, fg);
    if (k > 0 || p.with_root_relax) {
      relax(w, L, k + 1 == K ? p.nu1 + p.nu2 : p.nu1, rank);
    }
    if (k + 1 < K) {
      const SubLevel& LC = p.lev[k + 1];
      restrict_residual(w, L, view_of(LC, rank, smem, vg, fg), rank);
      level_sync(LC.nctas);  // the coarse f and v written
    }
  }
  // up: prolong the coarse error and add it, relax nu2
  for (int k = K - 2; k >= 0; --k) {
    const SubLevel& L = p.lev[k];
    if (L.nctas == 1 && rank != 0) continue;
    // the other CTAs wait here while CTA 0 runs the levels it holds alone
    if (L.nctas > 1 && p.lev[k + 1].nctas == 1) cg::this_cluster().sync();
    const View w = view_of(L, rank, smem, vg, fg);
    prolong_add(w, view_of(p.lev[k + 1], rank, smem, vg, fg), rank);
    level_sync(L.nctas);
    if (k > 0 || p.with_root_relax) relax(w, L, p.nu2, rank);
  }
  if (!root.vdev) root_copy(root, root.v, vg_own, false);
  // no CTA leaves while another may still read its shared memory
  if (p.nctas > 1) cg::this_cluster().sync();
}

bool valid(const SubtreeParams& p) {
  if (p.nlev < 1 || p.nlev > kMaxLevels) return false;
  if (p.nctas != 1 && p.nctas != kCtas) return false;
  if (p.threads < 32 || p.threads > kThreads || p.threads % 32) return false;
  if (p.smem_bytes < 0 || p.smem_bytes > kMaxSmem) return false;
  if (p.nu1 < 0 || p.nu2 < 0) return false;
  const long long floats = p.smem_bytes / (long long)sizeof(float);
  for (int k = 0; k < p.nlev; ++k) {
    const SubLevel& L = p.lev[k];
    if (L.lx < 1 || L.ly < 1 || L.lz < 1 || L.lx + L.ly + L.lz > 24) {
      return false;
    }
    if (L.nctas != 1 && L.nctas != p.nctas) return false;
    if (L.nctas > 1 && L.lx < 3) return false;
    if ((L.v_off < 0 || L.f_off < 0) && k > 0) return false;
    if (k == 0 && L.f_off >= 0) return false;  // the root's f: device memory
    // this CTA's planes of v and f inside the dynamic shared memory
    const long long n = 1LL << (L.lx - (L.nctas > 1 ? 3 : 0) + L.ly + L.lz);
    if (L.v_off >= 0 && L.v_off + n > floats) return false;
    if (L.f_off >= 0 && L.f_off + n > floats) return false;
  }
  return true;
}

int launch_subtree(float* v, const float* f, const SubtreeParams* p,
                   cudaStream_t stream) {
  if (!valid(*p)) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;  // once per process, outside any capture
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        subtree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p->nctas, 1, 1);
  cfg.blockDim = dim3(p->threads, 1, 1);
  cfg.dynamicSmemBytes = p->smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p->nctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p->nctas > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, subtree_kernel, v, f, *p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
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

}  // extern "C"
