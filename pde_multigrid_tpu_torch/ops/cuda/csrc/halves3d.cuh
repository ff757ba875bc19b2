// 3D wrap-storage levels held in shared memory as colour halves (sm_90a):
// the level views, plane addressing and red-black half-sweep shared by the
// fused subtree V-cycle (subtree.cu) and the whole-leg resident kernel
// (resident3d.cu).
//
// A level of 2^lx x 2^ly x 2^lz points is held either whole on one CTA
// or cut into x-slabs of X / nctas planes, one per CTA of a cluster.  In
// shared memory it is stored as its colour halves (relax.cu's layout):
// red (x + y + z even) then black, each (planes, Y / 2, Z), the dense
// point (x, y, z) at (x, y >> 1, z) of half (x + y + z) & 1, so a
// half-sweep reads the other half with consecutive threads on
// consecutive z, free of bank conflicts.  A point's x +- 1 neighbour
// plane lies in the neighbouring CTA at a slab edge and is read through
// distributed shared memory (cluster.map_shared_rank).  In device memory
// (the subtree root's f) a level is dense.
//
// Wrap storage: indices wrap modulo the extent (all extents are powers of
// two, so a mask does it); plane 0 of each axis is the zero boundary that
// both ends share, and the masks (x, y, z >= 1) never update it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "stencil.cuh"  // split_update

namespace cg = cooperative_groups;

namespace {

// One level (ops/cuda/subtree.py SubLevelParams).
struct SubLevel {
  int lx, ly, lz;  // log2 of the stored extents X, Y, Z
  int nctas;       // > 1: x-slabs of X / nctas planes over the cluster;
                   // 1: whole on CTA 0
  int v_off;       // float offset of this CTA's v in shared memory; < 0:
  int f_off;       // device memory (dense); the same for f
  float w0, w1, w2;  // 1 / h^2 per axis, float32 (the residual's weights)
  float inv_den;     // 1 / (2 sum 1 / h^2), rounded once from double
};

// A level as one CTA sees it.
struct View {
  int X, Y, Z, lz, lyz;  // extents; log2 Z, log2 (Y Z)
  int lslab;             // log2 of the planes one owner holds
  int hs;                // points of one half on one owner
  int nctas;
  int x0, nx;            // this CTA's planes [x0, x0 + nx); nx = 0: none
  float* v;              // this CTA's planes: shared memory (red half; the
  float* f;              // black half hs later), or device memory at x0
  bool vdev, fdev;       // in device memory (dense)
};

__device__ __forceinline__ View view_of(const SubLevel& L, int rank,
                                        float* smem, float* vg,
                                        const float* fg) {
  View w;
  w.X = 1 << L.lx;
  w.Y = 1 << L.ly;
  w.Z = 1 << L.lz;
  w.lz = L.lz;
  w.lyz = L.ly + L.lz;
  w.nctas = L.nctas;
  w.lslab = L.nctas > 1 ? L.lx - (31 - __clz(L.nctas)) : L.lx;
  w.hs = 1 << (w.lslab + w.lyz - 1);
  w.x0 = L.nctas > 1 ? rank << w.lslab : 0;
  w.nx = (L.nctas > 1 || rank == 0) ? 1 << w.lslab : 0;
  w.vdev = L.v_off < 0;
  w.fdev = L.f_off < 0;
  const long long at0 = (long long)w.x0 << w.lyz;
  w.v = w.vdev ? vg + at0 : smem + L.v_off;
  w.f = w.fdev ? const_cast<float*>(fg) + at0 : smem + L.f_off;
  return w;
}

// Plane x (0 <= x < X) of a level array whose part on this CTA is `mine`:
// in shared memory the plane of the red half (the black one hs later; a
// half's plane is Y Z / 2 points) in this CTA or another (distributed
// shared memory), or the dense plane in device memory (`mine` at x0).
__device__ __forceinline__ float* plane_of(float* mine, bool dev, int x,
                                           const View& w, int rank) {
  if (dev) return mine + (long long)(x - w.x0) * (1LL << w.lyz);
  const int owner = w.nctas > 1 ? x >> w.lslab : 0;
  float* p = mine + ((x - (owner << w.lslab)) << (w.lyz - 1));
  if (owner == rank) return p;
  return cg::this_cluster().map_shared_rank(p, owner);
}

// The value at (x, y, z) of plane x (plane_of's pointer).
__device__ __forceinline__ float at_pt(const float* P, bool dev, int x,
                                       int y, int z, const View& w) {
  if (dev) return P[(y << w.lz) + z];
  return P[((x + y + z) & 1) * w.hs + ((y >> 1) << w.lz) + z];
}

// The offset of this CTA's own point (x0 + lx, y, z) from `v` / `f`.
__device__ __forceinline__ int own_at(bool dev, int lx, int y, int z,
                                      const View& w) {
  if (dev) return (lx << w.lyz) + (y << w.lz) + z;
  return ((w.x0 + lx + y + z) & 1) * w.hs + (lx << (w.lyz - 1)) +
         ((y >> 1) << w.lz) + z;
}

// The barrier after a phase on a level: the cluster's for a split level,
// the block's for a level on CTA 0.
__device__ __forceinline__ void level_sync(int nctas) {
  if (nctas > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// One half-sweep of colour c (0 red, 1 black) on this CTA's planes of a
// level in shared memory: relax.cu's half_sweep_kernel on the halves, every
// point of the colour off the boundary planes becoming old + (upd - old).
__device__ __forceinline__ void half_sweep(const View& w, const SubLevel& L,
                                           int c, int rank) {
  if (w.nx == 0) return;
  const int n = w.nx << (w.lyz - 1);  // this CTA's points of one half
  float* __restrict__ u = w.v + c * w.hs;
  const float* __restrict__ o = w.v + (1 - c) * w.hs;
  const float* __restrict__ fu = w.f + c * w.hs;  // f in shared memory
  const float* __restrict__ fd = w.f;             // f in device memory
  const int lp = w.lyz - 1;  // log2 of a half's plane
  const int hplane = 1 << lp;
  const int Y2 = w.Y >> 1;
  // the other colour's planes beside this CTA's first and last (wrapped)
  const float* oprev =
      plane_of(const_cast<float*>(o), false, (w.x0 - 1) & (w.X - 1), w, rank);
  const float* onext = plane_of(const_cast<float*>(o), false,
                                (w.x0 + w.nx) & (w.X - 1), w, rank);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int z = i & (w.Z - 1);
    const int j = (i >> w.lz) & (Y2 - 1);
    const int lx = i >> lp;
    const int x = w.x0 + lx;
    const int s = (x + z + c) & 1;  // the point's y is 2 j + s
    if (x == 0 || z == 0 || (j == 0 && s == 0)) continue;
    const int row = j << w.lz;
    const int pc = lx << lp;
    // neighbour pair sums in relax.cu's order
    const float p0 = (lx > 0 ? o[i - hplane] : oprev[row + z]) +
                     (lx + 1 < w.nx ? o[i + hplane] : onext[row + z]);
    const int jo = (s ? j + 1 : j - 1) & (Y2 - 1);
    const float p1 = o[i] + o[pc + (jo << w.lz) + z];
    const float p2 = o[pc + row + ((z - 1) & (w.Z - 1))] +
                     o[pc + row + ((z + 1) & (w.Z - 1))];
    const float fv =
        w.fdev ? fd[(lx << w.lyz) + ((2 * j + s) << w.lz) + z] : fu[i];
    const float upd =
        split_update(p0, p1, p2, fv, L.w0, L.w1, L.w2, L.inv_den);
    const float old = u[i];
    u[i] = old + (upd - old);  // m = 1: v + m * (upd - v)
  }
}

// `nsweeps` red-then-black sweeps, each half-sweep ended by the level's
// barrier.
__device__ __forceinline__ void relax(const View& w, const SubLevel& L,
                                      int nsweeps, int rank) {
  for (int s = 0; s < nsweeps; ++s) {
    for (int c = 0; c < 2; ++c) {
      half_sweep(w, L, c, rank);
      level_sync(L.nctas);
    }
  }
}

// This CTA's planes of a level: dense device memory <-> shared halves.
__device__ __forceinline__ void root_copy(const View& w, float* halves,
                                          float* dense, bool to_smem) {
  const int n = w.nx << w.lyz;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int z = i & (w.Z - 1);
    const int y = (i >> w.lz) & (w.Y - 1);
    const int idx = own_at(false, i >> w.lyz, y, z, w);
    if (to_smem) {
      halves[idx] = dense[i];
    } else {
      dense[i] = halves[idx];
    }
  }
}

}  // namespace
