// Dense red-black Gauss-Seidel over a whole small 2D level, all sweeps of a
// relax leg in one launch (sm_90a), for the HJB minimum-time equation
// (upwind scheme) and for 2D Poisson: one template on the stencil (`Op`:
// hjb2d.cuh's HJBOp, poisson2d.cuh's PoissonOp).
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_resident_relax
// on the HJB 513^2 path's levels 257^2 down to 3^2, and on the 2D Poisson
// 4097^2 paths' levels: 256^2 down to 2^2 in wrap storage, 257^2 down to
// 3^2 in padded storage.  (Its 2D Lyapunov levels are the dense form of
// csrc/color_slab2d_shard.cu's leg.)  A
// half-sweep there is far shorter than a host launch: with one launch per
// half-sweep the legs would be launch-bound.  So, as the Pallas kernel keeps
// the level in VMEM for the whole leg, this kernel keeps it on chip for the
// whole leg.  Device memory is read once at the start of the leg and written
// once at its end.
//
// The update reads both x neighbours, both y neighbours and f; HJB's also
// four coefficients of the point's column (hjb2d.cuh), Poisson's two
// constants (poisson2d.cuh).  Red are the points with x + y even; a
// colour's points read the other colour alone, so the points of a
// half-sweep are independent.
//
// Wrap storage (Poisson's default, zero boundary): the level is stored as
// X - 1 by Y - 1 points and row and column 0 are the boundary both ends
// share (the +1 neighbour of the last stored row is stored row 0, as
// torch.roll gives it).  The kernel works on the logical X x Y level whose
// row X - 1 and column Y - 1 are loaded from stored row and column 0: they
// are boundary points, never updated, so a leg reads the stored values
// once, at its start (the last band's +x neighbour row is CTA 0's row 0,
// which no CTA writes), and never writes them back.
//
// Design (the layout, resident.hjb_leg_layout, picks every number):
//   * Columns in registers.  A thread owns the column y of a segment of
//     rows (y = 1 .. Y - 2: columns 0 and Y - 1 are the boundary): its
//     values, f, and the update-mask bit of each of its rows, and its
//     column's four coefficients, for the whole leg.  So the x neighbours
//     (e, w) and the old value come from registers, and a point's update is
//     two shared loads (the y neighbours, owned by the lanes beside it) and
//     one shared store.  The thread's rows start on a parity chosen so that
//     red sits at even register rows: every index is a compile-time one, no
//     slot walk, no mask byte or coefficient reloaded.  A warp's lanes are
//     consecutive columns; their rows alternate in parity, and the band's
//     row stride is even, so each load and store of a warp hits 32 banks.
//   * A band in shared memory: the level's rows [xs, xe) dense (two zero
//     guard rows each side), the neighbours' source.  Block barriers (a
//     warp barrier on a one-warp CTA) between half-sweeps.  A band of many
//     rows is cut into G segments of L rows (the last may hold fewer), a
//     thread each column and segment; L is a template instance, so before
//     each half-sweep a thread reloads, at fixed register rows, the two
//     rows past its segment that the other segments wrote.
//   * Small levels (one CTA): the whole level, one warp where the interior
//     columns fit one (33^2 and below), a segment of rows each.
//   * Large levels (a cluster of up to 16 CTAs, non-portable): the level
//     in x bands of B owned rows, each band loaded with H = 2T halo rows on
//     both sides (the update reads both x neighbours).  A stale halo value
//     spreads one row per half-sweep, so after T sweeps the owned rows are
//     exact (the trapezoid argument), and the halos are refreshed: each CTA
//     pushes its first and last H owned rows into its neighbours' inboxes
//     through distributed shared memory, one cluster barrier, and each CTA
//     copies its inboxes into its halo rows and reloads its registers.
//     Inboxes come in two sets used in turns, so a refresh never writes an
//     inbox its owner has not emptied.  The cluster barrier after the load
//     is split: arrive after the load, wait before the first remote store
//     or the store of v, so no CTA writes v before every CTA has read it.
//
// What bounds it: per point and half-sweep of its colour, 15 float
// operations (HJB; Poisson 7 and the blend's 2) on a level that fits on
// chip; the legs are short (30 sweeps),
// so barrier latency and the issue of each half-sweep's dependent loads
// and products bound them, not bytes (read v, f, the mask byte once, write
// v once).  The cluster form recomputes the halo rows (2H per band) to
// trade a cluster barrier every half-sweep for one every T sweeps.
//
// Update form: the Pallas kernel's v + m * (kernel_update - v) with m = 1
// on the update mask (HJB: the interior without the pinned target ball;
// Poisson: the interior, from the global index).  Points off the colour or
// the mask are never written.  Built with --fmad=false,
// in the plain version's operation order: bitwise equal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hjb2d.cuh"      // HJB2D, HJBOp
#include "poisson2d.cuh"  // Poisson2D, PoissonOp

namespace cg = cooperative_groups;

// The layout of a leg (resident.HJBLegLayout fills it in).
struct HJBLeg {
  int X, Y;         // the level (logical: wrap storage holds X - 1 by Y - 1)
  int nctas;        // CTAs; a cluster when > 1
  int B;            // owned rows a CTA (the last may own fewer)
  int H;            // halo rows each side: 2T on a cluster, 0 on one CTA
  int T;            // sweeps between halo refreshes (a cluster)
  int G;            // row segments of a band
  int L;            // rows a segment (the last may hold fewer): a template
                    // instance
  int NC;           // threads a segment: Y - 2 rounded up to a warp
  int S;            // the band's row stride in floats (even, >= NC + 2)
  int rows;         // the band's rows in shared memory: G L + 4
  int threads;      // G NC
  int smem_bytes;   // the band and, on a cluster, two sets of inboxes
  int wrap;         // 1: wrap storage, row / column X - 1 / Y - 1 read from
                    // stored row / column 0 and never written
};

namespace {

constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;  // the band's loads in flight a thread
constexpr int kMaxCtas = 16;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may hold

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void block_sync(bool one_warp) {
  if (one_warp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// `rows` rows of Y floats, each dst[k S + y] = src[k S + y], by the CTA's
// threads along y.
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int rows, int Y, int S) {
  for (int k = 0; k < rows; ++k) {
    for (int y = threadIdx.x; y < Y; y += blockDim.x) {
      dst[k * S + y] = src[k * S + y];
    }
  }
}

// Shared row of global row x: two guard rows before the band's first.
__device__ __forceinline__ int srow(int x, int xs) { return x - xs + 2; }

template <int L, class Op>
__global__ void __launch_bounds__(kMaxThreads)
    resident2d_kernel(float* __restrict__ v, const float* __restrict__ f,
                      int nsweeps, HJBLeg g, typename Op::Params p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool one_warp = nt == 32;
  const bool cluster = g.nctas > 1;
  const int rank = cluster ? (int)cg::this_cluster().block_rank() : 0;
  const int X = g.X, Y = g.Y, S = g.S;
  const int Xs = X - g.wrap, Ys = Y - g.wrap;  // the stored extents
  const int xo = rank * g.B;                 // first owned row
  const int xo_end = min(xo + g.B, X);       // past the last owned row
  const int xs = max(0, xo - g.H);           // first loaded row
  const int xe = min(X, xo_end + g.H);       // past the last loaded row
  float* sv = smem;
  float* inbox = sv + g.rows * S;  // [2 sets][2 sides][H rows][S]

  // the band: zeros, then the loaded rows, kUnroll loads in flight (wrap:
  // row X - 1 and column Y - 1 from stored row and column 0)
  for (int i = tid; i < g.rows * S; i += nt) sv[i] = 0.0f;
  block_sync(one_warp);
  const int nband = (xe - xs) * Y;
  for (int i0 = tid; i0 < nband; i0 += kUnroll * nt) {
    float t[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int i = i0 + j * nt;
      const int k = i / Y;
      const int yy = i - k * Y;
      const int x = xs + k;
      at[j] = (k + 2) * S + yy;
      t[j] = v[i < nband ? (long long)(x < Xs ? x : 0) * Ys +
                               (yy < Ys ? yy : 0)
                         : 0];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (i0 + j * nt < nband) sv[at[j]] = t[j];
    }
  }

  // this thread's column and segment; its register rows r = 0 .. L + 2
  // are the rows xr0 + r, with xr0 + y even: red at even r
  const int seg = tid / g.NC;
  const int y = tid - seg * g.NC + 1;
  const bool col = y <= Y - 2;
  const int seg0 = xs + seg * L;
  const int seg1 = min(seg0 + L, xe);
  const int xr0 = seg0 - 1 - ((seg0 - 1 + y) & 1);
  float* b = sv + srow(xr0, xs) * S + y;
  Op op;
  op.column(p, col ? y : 1);  // the column's coefficients
  // bit r: the thread updates row xr0 + r (its segment, strictly inside
  // the loaded rows, on the mask: an updated point is never on row X - 1
  // or column Y - 1, so it is stored where the padded level has it, at
  // x Ys + y); every load issued before any is used.  No f (a Poisson
  // leg without RHS): f reads as 0, whose -0 term adds nothing.
  unsigned long long bits = 0;
  float fr[L + 3];
  uint8_t mk[L + 3];
#pragma unroll
  for (int r = 0; r < L + 3; ++r) {
    const int x = xr0 + r;
    const bool in = col && x >= seg0 && x < seg1 && x > xs && x < xe - 1;
    const long long gi = in ? (long long)x * Ys + y : 0;
    mk[r] = in ? op.keep(p, x, y, gi) : 0;
    fr[r] = f != nullptr ? f[gi] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < L + 3; ++r) {
    if (mk[r]) bits |= 1ull << r;
  }
  block_sync(one_warp);
  if (cluster) cluster_arrive();  // this CTA read its rows of v
  bool waited = !cluster;

  float vr[L + 3];
#pragma unroll
  for (int r = 0; r < L + 3; ++r) vr[r] = b[r * S];

  const int T = cluster ? g.T : max(nsweeps, 1);
  const int nchunks = (nsweeps + T - 1) / T;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int tc = min(T, nsweeps - ch * T);
    for (int s = 0; s < tc; ++s) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (g.G > 1) {
          // the rows past the segment of the other colour, which the
          // segments beside it wrote: a segment holds L rows, so they sit
          // at fixed register rows (the last segment's top one lies past
          // the band, never read by an update)
          vr[1 - c] = b[(1 - c) * S];
          vr[L + 1 + c] = b[(L + 1 + c) * S];
        }
        // the y neighbours of this colour's rows r = 2 i + 2 - c <= L + 1
        // (L / 2 red, L / 2 + 1 black), all loaded before any store: a
        // store may not pass a load the compiler cannot prove apart
        constexpr int NR = L / 2 + 1;
        const int nr = L / 2 + c;
        float nn[NR], ss[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (i >= nr) break;
          const int r = 2 * i + 2 - c;
          nn[i] = b[r * S + 1];
          ss[i] = b[r * S - 1];
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (i >= nr) break;
          const int r = 2 * i + 2 - c;
          const float upd =
              op.update(p, vr[r + 1], vr[r - 1], nn[i], ss[i], fr[r]);
          const float old = vr[r];
          // m = 1: v + m * (upd - v); off the mask the point stays
          vr[r] = (bits >> r) & 1ull ? old + (upd - old) : old;
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (i >= nr) break;
          const int r = 2 * i + 2 - c;
          if ((bits >> r) & 1ull) b[r * S] = vr[r];
        }
        block_sync(one_warp);  // this colour done before the other reads it
      }
    }
    if (ch + 1 < nchunks) {
      // the halo refresh, inboxes of set ch & 1 ([2 sides][H rows][S]): my
      // first and last H owned rows, exact after the chunk, into side 1 of
      // rank - 1's and side 0 of rank + 1's
      cg::cluster_group cl = cg::this_cluster();
      const int H = g.H;
      float* mine = inbox + (ch & 1) * 2 * H * S;
      if (!waited) {
        cluster_wait();  // every CTA started and read its rows of v
        waited = true;
      }
      if (rank > 0) {
        copy_rows(cl.map_shared_rank(mine, rank - 1) + H * S,
                  sv + srow(xo, xs) * S, min(H, X - xo), Y, S);
      }
      if (rank + 1 < g.nctas) {
        copy_rows(cl.map_shared_rank(mine, rank + 1),
                  sv + srow(xo_end - H, xs) * S, H, Y, S);
      }
      cluster_arrive();
      cluster_wait();
      if (rank > 0) copy_rows(sv + srow(xo - H, xs) * S, mine, H, Y, S);
      if (rank + 1 < g.nctas) {
        copy_rows(sv + srow(xo_end, xs) * S, mine + H * S,
                  min(H, X - xo_end), Y, S);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < L + 3; ++r) vr[r] = b[r * S];
    }
  }
  if (!waited) cluster_wait();  // no CTA writes v before all have read it
  // the owned stored rows (wrap: not row X - 1 or column Y - 1, which are
  // stored row and column 0, unchanged)
  for (int x = xo; x < min(xo_end, Xs); ++x) {
    const float* src = sv + srow(x, xs) * S;
    for (int yy = tid; yy < Ys; yy += nt) v[(long long)x * Ys + yy] = src[yy];
  }
}

bool valid(const HJBLeg& g) {
  if (g.X < 3 || g.Y < 3 || g.nctas < 1 || g.nctas > kMaxCtas ||
      (g.wrap != 0 && g.wrap != 1)) {
    return false;
  }
  if (g.B < 1 || (g.nctas - 1) * g.B >= g.X || g.nctas * g.B < g.X) {
    return false;
  }
  const bool cluster = g.nctas > 1;
  if (cluster ? (g.T < 1 || g.H != 2 * g.T || g.B < g.H)
              : (g.H != 0 || g.B != g.X)) {
    return false;
  }
  const int nload = min(g.B + 2 * g.H, g.X);
  if (g.G < 1 || g.G * g.L < nload || (g.G - 1) * g.L >= nload) {
    return false;
  }
  if (g.NC < g.Y - 2 || g.NC % 32 || g.S < g.NC + 2 || g.S < g.Y ||
      g.S % 2 || g.rows != g.G * g.L + 4 ||
      g.threads != g.G * g.NC ||
      g.threads > kMaxThreads) {
    return false;
  }
  const long long floats =
      (long long)g.rows * g.S + (cluster ? 4LL * g.H * g.S : 0);
  return g.smem_bytes == 4 * floats && g.smem_bytes <= kMaxSmem;
}

template <int L, class Op>
struct Kernel {
  static cudaError_t opt_in() {
    static const cudaError_t status = [] {
      const cudaError_t e = cudaFuncSetAttribute(
          resident2d_kernel<L, Op>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (e != cudaSuccess) return e;
      return cudaFuncSetAttribute(
          resident2d_kernel<L, Op>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }();
    return status;
  }
};

struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(const HJBLeg& g, cudaStream_t stream) {
    cfg.gridDim = dim3(g.nctas, 1, 1);
    cfg.blockDim = dim3(g.threads, 1, 1);
    cfg.dynamicSmemBytes = g.smem_bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = g.nctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = g.nctas > 1 ? 1 : 0;
  }
};

// the kernel's register rows: the template instances
template <int L, class Op>
int run(float* v, const float* f, int nsweeps, const HJBLeg& g,
        const typename Op::Params& p, cudaStream_t stream, int* clusters) {
  cudaError_t e = Kernel<L, Op>::opt_in();
  if (e != cudaSuccess) return (int)e;
  Launch l(g, stream);
  if (clusters != nullptr) {
    return (int)cudaOccupancyMaxActiveClusters(
        clusters, resident2d_kernel<L, Op>, &l.cfg);
  }
  e = cudaLaunchKernelEx(&l.cfg, resident2d_kernel<L, Op>, v, f, nsweeps, g,
                         p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class Op>
int dispatch(float* v, const float* f, int nsweeps, const HJBLeg& g,
             const typename Op::Params& p, cudaStream_t stream,
             int* clusters) {
  if (!valid(g) || nsweeps < 0) return (int)cudaErrorInvalidValue;
  switch (g.L) {
    case 4:
      return run<4, Op>(v, f, nsweeps, g, p, stream, clusters);
    case 6:
      return run<6, Op>(v, f, nsweeps, g, p, stream, clusters);
    case 8:
      return run<8, Op>(v, f, nsweeps, g, p, stream, clusters);
    case 10:
      return run<10, Op>(v, f, nsweeps, g, p, stream, clusters);
    case 12:
      return run<12, Op>(v, f, nsweeps, g, p, stream, clusters);
    case 14:
      return run<14, Op>(v, f, nsweeps, g, p, stream, clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One leg of nsweeps on the level v (in place) with RHS f, in the layout
// *g (resident.hjb_leg_layout), the fields *p.  Default visibility spelled
// out: the host compiler hides a function whose body launches a kernel
// taking a type of this file's unnamed namespace.
__attribute__((visibility("default"))) int pdemg_resident2d_hjb(
    float* v, const float* f, int nsweeps, const HJBLeg* g, const HJB2D* p,
    void* stream) {
  if (f == nullptr || g->wrap) return (int)cudaErrorInvalidValue;
  return dispatch<HJBOp>(v, f, nsweeps, *g, *p, (cudaStream_t)stream,
                         nullptr);
}

// How many clusters of the layout *g the card can hold at once (0: it
// refuses the cluster), into *clusters; a CUDA error code.
__attribute__((visibility("default"))) int pdemg_resident2d_hjb_clusters(
    const HJBLeg* g, int* clusters) {
  return dispatch<HJBOp>(nullptr, nullptr, 0, *g, HJB2D{}, nullptr,
                         clusters);
}

// The 2D Poisson leg: nsweeps on the level v (in place; wrap or padded
// storage, g->wrap) with RHS f, or none (f null), in the layout *g
// (resident.poisson_leg_layout) with the constants *p.
__attribute__((visibility("default"))) int pdemg_resident2d_poisson(
    float* v, const float* f, int nsweeps, const HJBLeg* g,
    const Poisson2D* p, void* stream) {
  return dispatch<PoissonOp>(v, f, nsweeps, *g, *p, (cudaStream_t)stream,
                             nullptr);
}

__attribute__((visibility("default"))) int pdemg_resident2d_poisson_clusters(
    const HJBLeg* g, int* clusters) {
  return dispatch<PoissonOp>(nullptr, nullptr, 0, *g, Poisson2D{}, nullptr,
                             clusters);
}

}  // extern "C"
