// Red-black Gauss-Seidel over a whole 1D level, all sweeps of a relax leg in
// one launch (sm_90a).
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_resident_relax_1d
//     (Ode1D in padded storage: the ode1d rows, 8193 and 4097 points), and
//   pde_multigrid_tpu/ops/pallas/relax.py:make_resident_relax, 1D branch
//     (Poisson(1) in wrap storage).
// A 1D sweep is far shorter than a host launch (8193 points), and the legs
// run 1000 sweeps, so, as the Pallas kernels keep the level in VMEM for the
// whole leg, this kernel keeps it in registers for the whole leg.
//
// The function.  Points 1 .. last are updated, red (even index) then black.
// Ode1D reads the east neighbour alone: red i reads black i + 1, black i the
// new red i + 1.  Poisson reads both.  The points the kernel holds are the
// stored ones and, in wrap storage (even N), point N = point 0 (the zero
// plane, the east neighbour of the last black): E = N + 1 in all.
//
// Design (the layout, relax1d.layout, picks every number).  A unit is one
// warp: lane l holds the 2K contiguous points st + 2Kl .. st + 2Kl + 2K - 1
// of its span (K of each colour) in registers with their coefficients (for
// Ode1D v, a_e and f a_f, folded at load as the plain version rounds it;
// for Poisson v and -f).  Within a unit a sweep is register updates and two
// shuffles (the next lane's first red; for Poisson also the previous lane's
// last black): no barrier.
//   * One unit (levels of at most 64 K points, E <= 64 K): the whole level,
//     one warp, no halo.
//   * Many units: unit u owns the B points [u B, u B + B) and holds a span
//     of 64 K = HW + B + HE points: HE = 2T halo points east of them and,
//     for Poisson (which reads both sides), HW = 2T west.  The span's edge
//     points read a neighbour that is not there; a stale value spreads one
//     point per half-sweep, so after T sweeps the owned points are exact
//     (the trapezoid argument), and the halos are refreshed: each unit
//     pushes its first 2T owned points into the inbox of the unit west of
//     it (and, for Poisson, its last 2T into the unit east of it), one
//     barrier, and each unit reads its inboxes into its halo lanes.  Units
//     are warps of a CTA (the barrier a block barrier) or, across CTAs, of
//     a cluster of up to 16 non-portable CTAs: the push goes through
//     distributed shared memory and the barrier is the cluster's.  Halo
//     points are multiples of 2K, so whole lanes push and pull.  Inboxes
//     come in two sets used in turns, so a refresh never writes an inbox
//     its owner has not emptied.  On a cluster the barrier after the load
//     is split: arrive after the load, wait before the first remote store
//     or the store of v, so no unit writes v before every unit has read it.
//
// What bounds it: per sweep and interior point 4 float operations for
// Ode1D (a product, a sum and the blend's two sums), 6 for Poisson, on a
// few hundred points a warp, so each sweep's dependent chain (red, a
// shuffle, black) and the refreshes' barriers bound it, not bytes (16 per
// point and leg for Ode1D, 8 for Poisson, read once, v written once).
// Spreading the level over warps on many SMs runs the chains side by
// side; larger T makes refreshes rarer and halos longer.
//
// Update form: the Pallas kernels' r + m * (upd - r) with m = 1 on the
// interior, upd = east * a_e + f * a_f (Ode1D) or (-f + (west + east) * w)
// * inv_den (Poisson); points off the interior are never written.  Built
// with --fmad=false, in the plain version's operation order: bitwise equal.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

struct Poisson1D {
  float w;        // 1 / h^2
  float inv_den;  // 1 / (2 / h^2)
};

// The layout of a leg (relax1d.Relax1DLayout fills it in).
struct Relax1DLayout {
  int N, last, E;  // stored points, the last interior index, points held
  int nctas;       // CTAs; a cluster when > 1
  int wpc;         // warps a CTA, a unit each
  int K;           // points of each colour a lane (a template instance)
  int T;           // sweeps between halo refreshes; 0: one unit, no halo
  int B;           // owned points a unit
  int HW, HE;      // halo points west and east of the owned ones
  int threads;     // 32 wpc
  int smem_bytes;  // the inboxes: wpc units x 2 sides x 2 sets x 2T
};

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCtas = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// point i of the level as the kernel holds it: v[i], v[0] at i = N in wrap
// storage, 0 elsewhere (never updated, never read by an updated point)
__device__ __forceinline__ float held(const float* a, int i, int N, int E) {
  const bool in = i >= 0 && i < N;
  const float x = a[in ? i : 0];  // a load from a valid address either way
  return in || (i == N && E > N) ? x : 0.0f;
}

// The inbox of unit w of its CTA: side 0 the east one (filled by the next
// unit), side 1 the west one (filled by the previous unit), set s.
__device__ __forceinline__ float* inbox_of(float* inbox, int w, int side,
                                           int s, int T) {
  return inbox + ((w * 2 + side) * 2 + s) * 2 * T;
}

// A lane's 2K points, in order, into slot `slot` of side `side` of unit
// `to`'s inbox set `set`: in this CTA's shared memory, or through
// distributed shared memory in another CTA of the cluster.
template <int K>
__device__ __forceinline__ void push(float* inbox, int to, int side, int set,
                                     const Relax1DLayout& g, int rank,
                                     int slot, const float (&vr)[K],
                                     const float (&vb)[K]) {
  float* dst = inbox_of(inbox, to % g.wpc, side, set, g.T);
  if (to / g.wpc != rank) {
    dst = cg::this_cluster().map_shared_rank(dst, to / g.wpc);
  }
  dst += slot * 2 * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dst[2 * k] = vr[k];
    dst[2 * k + 1] = vb[k];
  }
}

template <int K, bool POISSON>
__global__ void __launch_bounds__(kMaxThreads)
    relax1d_kernel(float* __restrict__ v, const float* __restrict__ f,
                   const float* __restrict__ ae, const float* __restrict__ af,
                   int nsweeps, Relax1DLayout g, Poisson1D p) {
  extern __shared__ float inbox[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool cluster = g.nctas > 1;
  const int rank = cluster ? (int)cg::this_cluster().block_rank() : 0;
  const int u = rank * g.wpc + warp;
  const int units = g.nctas * g.wpc;
  const int N = g.N, E = g.E;
  const int st = u * g.B - g.HW;  // the span's first point
  const int i0 = st + 2 * K * lane;  // this lane's first point (red)

  float vr[K], vb[K];
  float cr[K], cb[K];  // Ode1D: f * a_f; Poisson: -f
  float er[K], eb[K];  // Ode1D: a_e
  unsigned mr = 0, mb = 0;  // interior slots of each colour, as bits
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ir = i0 + 2 * k;
    const int ib = ir + 1;
    vr[k] = held(v, ir, N, E);
    vb[k] = held(v, ib, N, E);
    const float fr = held(f, ir, N, E);
    const float fb = held(f, ib, N, E);
    if (POISSON) {
      cr[k] = -fr;
      cb[k] = -fb;
      er[k] = eb[k] = 0.0f;
    } else {
      er[k] = held(ae, ir, N, E);
      eb[k] = held(ae, ib, N, E);
      cr[k] = fr * held(af, ir, N, E);
      cb[k] = fb * held(af, ib, N, E);
    }
    if (ir >= 1 && ir <= g.last) mr |= 1u << k;
    if (ib >= 1 && ib <= g.last) mb |= 1u << k;
  }
  if (cluster) {
    cluster_arrive();  // this CTA read its points of v
  } else if (g.wpc > 1) {
    __syncthreads();  // every unit read its points before any is stored
  }
  bool waited = !cluster;

  const int T = g.T > 0 ? g.T : max(nsweeps, 1);
  const int nchunks = (nsweeps + T - 1) / T;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int tc = min(T, nsweeps - ch * T);
    for (int s = 0; s < tc; ++s) {
      // Poisson: black j - 1 of this lane's first red (lane 0: its own,
      // the span's west edge)
      const float prv = POISSON ? __shfl_up_sync(kFull, vb[K - 1], 1) : 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float upd;
        if (POISSON) {
          const float west = k ? vb[k - 1] : prv;
          upd = (cr[k] + (west + vb[k]) * p.w) * p.inv_den;
        } else {
          upd = vb[k] * er[k] + cr[k];
        }
        if ((mr >> k) & 1u) vr[k] = vr[k] + (upd - vr[k]);
      }
      // the next lane's first red (lane 31: its own, the span's east edge)
      const float nxt = __shfl_down_sync(kFull, vr[0], 1);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float east = k + 1 < K ? vr[k + 1] : nxt;
        float upd;
        if (POISSON) {
          upd = (cb[k] + (vr[k] + east) * p.w) * p.inv_den;
        } else {
          upd = east * eb[k] + cb[k];
        }
        if ((mb >> k) & 1u) vb[k] = vb[k] + (upd - vb[k]);
      }
    }
    if (ch + 1 < nchunks) {
      // the halo refresh, inboxes of set ch & 1: the lanes of my first 2T
      // owned points push them west, for Poisson those of my last 2T east
      const int lanes = 2 * K;
      const int n = 2 * g.T;
      const int set = ch & 1;
      if (!waited) {
        cluster_wait();  // every CTA started and read its points of v
        waited = true;
      }
      const int l_west = g.HW / lanes;             // my first owned lane
      const int l_east = (g.HW + g.B - n) / lanes;  // my last 2T's first
      if (u > 0 && lane >= l_west && lane < l_west + n / lanes) {
        push<K>(inbox, u - 1, 0, set, g, rank, lane - l_west, vr, vb);
      }
      if (POISSON && u + 1 < units && lane >= l_east &&
          lane < l_east + n / lanes) {
        push<K>(inbox, u + 1, 1, set, g, rank, lane - l_east, vr, vb);
      }
      if (cluster) {
        cluster_arrive();
        cluster_wait();
      } else {
        __syncthreads();
      }
      // my halo lanes: east from side 0, for Poisson west from side 1
      const int l_halo = (g.HW + g.B) / lanes;
      const float* src = nullptr;
      if (u + 1 < units && lane >= l_halo) {
        src = inbox_of(inbox, warp, 0, set, g.T) + (lane - l_halo) * lanes;
      } else if (POISSON && u > 0 && lane < l_west) {
        src = inbox_of(inbox, warp, 1, set, g.T) + lane * lanes;
      }
      if (src != nullptr) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          vr[k] = src[2 * k];
          vb[k] = src[2 * k + 1];
        }
      }
    }
  }
  if (!waited) cluster_wait();  // no unit writes v before all have read it
  // the owned interior points
  const int o0 = max(u * g.B, 1);
  const int o1 = min(u * g.B + g.B, g.last + 1);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int ir = i0 + 2 * k;
    if (ir >= o0 && ir < o1) v[ir] = vr[k];
    if (ir + 1 >= o0 && ir + 1 < o1) v[ir + 1] = vb[k];
  }
}

bool valid(const Relax1DLayout& g) {
  if (g.N < 2 || g.last < 1 || g.last >= g.N || (g.E != g.N && g.E != g.N + 1)) {
    return false;
  }
  if (g.nctas < 1 || g.nctas > kMaxCtas || g.wpc < 1 ||
      g.threads != 32 * g.wpc || g.threads > kMaxThreads) {
    return false;
  }
  const int units = g.nctas * g.wpc;
  const int span = 64 * g.K;
  if (g.B < 1 || (long long)units * g.B < g.E || g.HW + g.B + g.HE != span) {
    return false;
  }
  if (g.T == 0) {
    return units == 1 && g.HW == 0 && g.HE == 0 && g.smem_bytes == 0;
  }
  const int lanes = 2 * g.K;
  const int n = 2 * g.T;
  return g.HE == n && (g.HW == 0 || g.HW == n) && n % lanes == 0 &&
         g.B % lanes == 0 && g.B >= n &&
         g.smem_bytes == 4 * g.wpc * 2 * 2 * n;
}

template <int K, bool POISSON>
int run(float* v, const float* f, const float* ae, const float* af,
        int nsweeps, const Relax1DLayout& g, const Poisson1D& p,
        cudaStream_t stream, int* clusters) {
  const auto kernel = relax1d_kernel<K, POISSON>;
  static const cudaError_t status = [kernel] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (status != cudaSuccess) return (int)status;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
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
  if (clusters != nullptr) {
    return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  }
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, v, f, ae, af, nsweeps, g, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <bool POISSON>
int dispatch(float* v, const float* f, const float* ae, const float* af,
             int nsweeps, const Relax1DLayout& g, const Poisson1D& p,
             cudaStream_t stream, int* clusters) {
  if (!valid(g) || nsweeps < 0) return (int)cudaErrorInvalidValue;
  switch (g.K) {
    case 1:
      return run<1, POISSON>(v, f, ae, af, nsweeps, g, p, stream, clusters);
    case 2:
      return run<2, POISSON>(v, f, ae, af, nsweeps, g, p, stream, clusters);
    case 8:
      return run<8, POISSON>(v, f, ae, af, nsweeps, g, p, stream, clusters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One leg of nsweeps on the level v (in place), RHS f, in the layout *g
// (relax1d.layout).  Default visibility spelled out: the host compiler
// hides a function whose body launches a kernel taking a type of this
// file's unnamed namespace.
__attribute__((visibility("default"))) int pdemg_relax1d_ode(
    float* v, const float* f, const float* ae, const float* af, int nsweeps,
    const Relax1DLayout* g, void* stream) {
  return dispatch<false>(v, f, ae, af, nsweeps, *g, Poisson1D{0.f, 0.f},
                         (cudaStream_t)stream, nullptr);
}

__attribute__((visibility("default"))) int pdemg_relax1d_poisson(
    float* v, const float* f, int nsweeps, const Relax1DLayout* g,
    const Poisson1D* p, void* stream) {
  return dispatch<true>(v, f, nullptr, nullptr, nsweeps, *g, *p,
                        (cudaStream_t)stream, nullptr);
}

// How many clusters of the layout *g the card can hold at once (0: it
// refuses the cluster), into *clusters; a CUDA error code.
__attribute__((visibility("default"))) int pdemg_relax1d_clusters(
    const Relax1DLayout* g, int poisson, int* clusters) {
  return poisson ? dispatch<true>(nullptr, nullptr, nullptr, nullptr, 0, *g,
                                  Poisson1D{0.f, 0.f}, nullptr, clusters)
                 : dispatch<false>(nullptr, nullptr, nullptr, nullptr, 0, *g,
                                   Poisson1D{0.f, 0.f}, nullptr, clusters);
}

}  // extern "C"
