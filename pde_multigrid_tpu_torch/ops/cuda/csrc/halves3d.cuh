// 3D wrap-storage levels held in shared memory as colour halves (sm_90a):
// the level views, plane addressing and the relax leg shared by the fused
// subtree V-cycle (subtree.cu) and the whole-leg resident kernel
// (resident3d.cu).
//
// A level of 2^lx x 2^ly x 2^lz points is held either whole on one CTA
// or cut into x-slabs of X / nctas planes, one per CTA of a cluster.  In
// shared memory it is stored as its colour halves (relax.cu's layout):
// red (x + y + z even) then black, each (planes, Y / 2, Z), the dense
// point (x, y, z) at (x, y >> 1, z) of half (x + y + z) & 1, so a
// half-sweep reads the other half with consecutive threads on
// consecutive z, free of bank conflicts.  In device memory (the subtree
// root's f) a level is dense.
//
// The relax leg (`relax_level`): each thread of a half-sweep walks a run
// of up to kRun z-pairs along x (`sweep_run`), the run's x-neighbours of
// the other colour in registers; a split level's slab ends read halo
// planes that the x-neighbours bulk-copy in after each half-sweep,
// completing on the receiver's mbarrier (`Halo`), so its half-sweeps
// synchronise with the two x-neighbours only and read no distributed
// shared memory; a level on one CTA ends each half-sweep with a block
// barrier.  The port's first form of the leg, a point a thread with the
// x neighbours at a slab edge read through distributed shared memory
// (`half_sweep`, `relax`), stays for the one-CTA levels where it is the
// faster (resident3d.cu's 2^3).  The subtree's transfers still read a
// neighbour's planes through distributed shared memory (`plane_of`).
//
// Wrap storage: indices wrap modulo the extent (all extents are powers of
// two, so a mask does it); plane 0 of each axis is the zero boundary that
// both ends share, and the masks (x, y, z >= 1) never update it.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"  // split_update

namespace cg = cooperative_groups;

namespace {

constexpr int kRun = 4;  // the longest run of z-pairs a thread walks along x

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

// The port's first form of the leg, a point a thread, kept for the levels
// on which it beats the runs below (resident3d.cu, 2^3: ops/cuda/
// resident3d.py POINT_MAX_POINTS).  One half-sweep of colour c (0 red, 1
// black) on this CTA's planes of a level in shared memory: relax.cu's
// half_sweep_kernel on the halves, every point of the colour off the
// boundary planes becoming old + (upd - old).
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

// A level's half-sweep constants on this CTA, hoisted out of the sweeps.
struct Sweep {
  float w0, w1, w2, inv_den;  // the level's split_update constants
  int lp, lz;                 // log2 of a half's plane, log2 Z
  int zmask, jmask;           // Z - 1, Y / 2 - 1
  int x0;                     // this CTA's first plane
  int runs, items;            // runs of NX planes; (run, z-pair) items
};

// One point's update from its pair sums and f: the new value, or the old
// one off the updated points (the boundary planes x, y, z = 0).
__device__ __forceinline__ float update(float p0, float p1, float p2,
                                        float f, float old, bool keep,
                                        const Sweep& q) {
  const float upd = split_update(p0, p1, p2, f, q.w0, q.w1, q.w2, q.inv_den);
  return keep ? old + (upd - old) : old;  // m = 1: v + m (upd - v)
}

// The run of NX x 2 points of colour c at the z-pair (z0, z0 + 1) of row
// j (col = j Z + z0 in a half's plane, Y / 2 x Z) of the planes [lx0, lx0
// + NX) from x0, in the halves u (this colour), o (the other) and fu (f of
// this colour) in shared memory; ep / en: the other colour at the pair of
// the planes before and after the run.  Every point off the boundary
// planes becomes old + (upd - old), relax.cu's half_sweep_kernel on the
// halves: its pair sums in its order.  The pair's loads and its store are
// 8 bytes wide; a point y = 2 j + s has its other y-neighbour in row j + 1
// (s = 1) or j - 1, and s alternates along z.
template <int NX>
__device__ __forceinline__ void sweep_run(float* __restrict__ u,
                                          const float* __restrict__ o,
                                          const float* __restrict__ fu,
                                          int lx0, int col, float2 ep,
                                          float2 en, int c, const Sweep& q) {
  const int z0 = col & q.zmask;
  const int j = col >> q.lz;
  const int row = j << q.lz;
  const int zm = row + ((z0 - 1) & q.zmask);  // z0 - 1, wrapped
  const int zp = row + ((z0 + 2) & q.zmask);  // z0 + 2, wrapped
  const int jm = (((j - 1) & q.jmask) << q.lz) + z0;
  const int jp = (((j + 1) & q.jmask) << q.lz) + z0;
  const int x = q.x0 + lx0;
  const int s0 = (x + z0 + c) & 1;  // the run's first point at z0: y = 2j + s0
  // the other colour at the pair of rows x from the run's first plane - 1
  // to its last + 1: the x-pairs, each point's own-plane y-term and its
  // z-neighbour inside the pair
  float2 a[NX + 2];
  a[0] = ep;
#pragma unroll
  for (int t = 0; t < NX; ++t) {
    a[t + 1] = *reinterpret_cast<const float2*>(o + ((lx0 + t) << q.lp) + col);
  }
  a[NX + 1] = en;
#pragma unroll
  for (int t = 0; t < NX; ++t) {
    const int s = s0 ^ (t & 1);  // at z0; 1 - s at z0 + 1
    const int pb = (lx0 + t) << q.lp;
    const float2 fv = *reinterpret_cast<const float2*>(fu + pb + col);
    const float2 old = *reinterpret_cast<const float2*>(u + pb + col);
    // neighbour pair sums in relax.cu's order: x, y, z (minus, plus)
    const float p0x = a[t].x + a[t + 2].x;
    const float p1x = a[t + 1].x + o[pb + (s ? jp : jm)];
    const float p2x = o[pb + zm] + a[t + 1].y;
    const float p0y = a[t].y + a[t + 2].y;
    const float p1y = a[t + 1].y + o[pb + 1 + (s ? jm : jp)];
    const float p2y = a[t + 1].x + o[pb + zp];
    const bool xin = x + t != 0;
    float2 out;
    out.x = update(p0x, p1x, p2x, fv.x, old.x,
                   xin && z0 != 0 && (j != 0 || s != 0), q);
    out.y = update(p0y, p1y, p2y, fv.y, old.y, xin && (j != 0 || s == 0), q);
    *reinterpret_cast<float2*>(u + pb + col) = out;
  }
}

// One half-sweep of colour c on this CTA's planes of a level in shared
// memory (halves at u, o, fu): runs of NX planes along x, a thread per
// (run, z-pair).  hprev / hnext: the other colour's planes beside this
// CTA's first and last: the halo planes of a split level, the level's own
// last and first plane (wrapped) on CTA 0.
template <int NX>
__device__ __forceinline__ void half_sweep_runs(float* __restrict__ u,
                                                const float* __restrict__ o,
                                                const float* __restrict__ fu,
                                                const float* hprev,
                                                const float* hnext, int c,
                                                const Sweep& q) {
  const int pmask = (1 << (q.lp - 1)) - 1;  // z-pairs of a half's plane
  for (int i = threadIdx.x; i < q.items; i += blockDim.x) {
    const int col = 2 * (i & pmask), r = i >> (q.lp - 1);
    const float* pe = r == 0 ? hprev : o + ((r * NX - 1) << q.lp);
    const float* pn = r + 1 == q.runs ? hnext : o + ((r * NX + NX) << q.lp);
    sweep_run<NX>(u, o, fu, r * NX, col,
                  *reinterpret_cast<const float2*>(pe + col),
                  *reinterpret_cast<const float2*>(pn + col), c, q);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of this CTA's shared `p` in CTA `cta` of the cluster.
__device__ __forceinline__ unsigned remote_addr(const void* p, int cta) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(cta));
  return a;
}

// This thread's writes to shared memory (the generic proxy) ordered
// before the bulk copies (the async proxy) that read them.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The halo exchange of a split level's half-sweeps (Hopper's bulk copies
// between the shared memories of a cluster, completion on an mbarrier).
// After a half-sweep of colour c each CTA copies its first plane of colour
// c into the x - 1 neighbour's `next` halo and its last into the x + 1
// neighbour's `prev` halo, each copy completing on the receiver's bar[c];
// before a half-sweep of colour c a CTA waits on bar[1 - c] for its two
// halo planes of colour 1 - c.  The copies are the only signal: a CTA
// copies after its half-sweep, which read its halos of the other colour,
// so a neighbour's next copy of that colour lands after the reads; and it
// overwrites a plane it copied only after a half-sweep that waited for
// its neighbours' copies, each issued once its copy had landed.
struct Halo {
  float* buf;        // [colour][prev, next][plane] floats
  int plane;         // floats per halo plane
  uint64_t* bar;     // bar[c]: the two halo planes of colour c landed
  unsigned parity;   // bit c: the parity of bar[c]'s phase to wait for
  int left, right;   // the CTAs holding x0 - 1 and x0 + nx

  __device__ __forceinline__ float* at(int c, int side) const {
    return buf + (2 * c + side) * plane;
  }

  // Thread 0, after every thread's fence_async and a block barrier: this
  // CTA's first and last planes of colour c (at `first`, `last`, hp floats
  // each) to the neighbours; expects theirs on bar[c].
  __device__ __forceinline__ void send(int c, const float* first,
                                       const float* last, int hp) const {
    const unsigned bytes = 4u * (unsigned)hp;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :
                 : "r"(smem_addr(bar + c)), "r"(2 * bytes)
                 : "memory");
    const float* src[2] = {first, last};
    const int cta[2] = {left, right};
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      // the first plane is the left CTA's `next`, the last the right's
      // `prev`
      asm volatile(
          "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
          "::bytes [%0], [%1], %2, [%3];"
          :
          : "r"(remote_addr(at(c, 1 - d), cta[d])), "r"(smem_addr(src[d])),
            "r"(bytes), "r"(remote_addr(bar + c, cta[d]))
          : "memory");
    }
  }

  // Every thread: wait until the halo planes of colour c have landed.
  __device__ __forceinline__ void wait(int c) {
    const unsigned ph = (parity >> c) & 1u;
    unsigned done = 0;
    while (!done) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(smem_addr(bar + c)), "r"(ph)
          : "memory");
    }
    parity ^= 1u << c;
  }
};

// Thread 0 of a CTA of a cluster: the halo exchange's two mbarriers (one
// arrival each: the sender's expect_tx) initialised and made visible to
// the cluster's bulk copies.  A cluster barrier follows before any copy.
__device__ __forceinline__ void halo_init(uint64_t* bar) {
  for (int c = 0; c < 2; ++c) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :
                 : "r"(smem_addr(bar + c))
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// `nsweeps` red-then-black sweeps of this CTA's planes of a level (v and
// f in shared memory).  A level on CTA 0 ends each half-sweep with a block
// barrier.  A split level sends its black edge planes first, then waits
// for its halos before each half-sweep and sends the new edge planes after
// each but the last (Halo); the leg ends with a cluster barrier, as every
// phase after it reads more than the adjacent planes.  A thread walks runs
// of min(run, planes) planes (run 1, 2 or 4).
__device__ __forceinline__ void relax_level(float* smem, const View& w,
                                            const SubLevel& L, int nsweeps,
                                            Halo& halo, int run = kRun) {
  if (w.nx == 0 || nsweeps == 0) return;
  const bool split = w.nctas > 1;
  const int nx = w.nx < run ? w.nx : run;
  Sweep q;
  q.w0 = L.w0;
  q.w1 = L.w1;
  q.w2 = L.w2;
  q.inv_den = L.inv_den;
  q.lp = w.lyz - 1;
  q.lz = w.lz;
  q.zmask = w.Z - 1;
  q.jmask = (w.Y >> 1) - 1;
  q.x0 = w.x0;
  q.runs = w.nx / nx;
  q.items = q.runs << (q.lp - 1);
  const int hp = 1 << q.lp;
  float* const v = smem + L.v_off;
  const float* const f = smem + L.f_off;
  const float* last = v + ((w.nx - 1) << q.lp);  // of the red half
  if (split) {
    fence_async();
    __syncthreads();
    if (threadIdx.x == 0) halo.send(1, v + w.hs, last + w.hs, hp);
  }
  for (int h = 0; h < 2 * nsweeps; ++h) {
    const int c = h & 1;
    float* u = v + c * w.hs;
    const float* o = v + (1 - c) * w.hs;
    const float* fu = f + c * w.hs;
    const float* hprev = o + ((w.nx - 1) << q.lp);
    const float* hnext = o;
    if (split) {
      halo.wait(1 - c);
      hprev = halo.at(1 - c, 0);
      hnext = halo.at(1 - c, 1);
    }
    if (nx == 4) {
      half_sweep_runs<4>(u, o, fu, hprev, hnext, c, q);
    } else if (nx == 2) {
      half_sweep_runs<2>(u, o, fu, hprev, hnext, c, q);
    } else {
      half_sweep_runs<1>(u, o, fu, hprev, hnext, c, q);
    }
    if (!split) {
      __syncthreads();
    } else if (h + 1 < 2 * nsweeps) {
      fence_async();
      __syncthreads();  // this CTA's half-sweep written
      if (threadIdx.x == 0) halo.send(c, u, last + c * w.hs, hp);
    } else {
      cg::this_cluster().sync();
    }
  }
}

}  // namespace
