// Whole-leg red-black Gauss-Seidel on a small 3D Poisson level in padded
// storage (sm_90a): every sweep of a relax leg in one launch, the level
// held in shared memory for the whole leg.
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_resident_relax
//       (relax.py:143) on 3D padded Poisson levels
// which runs `nsweeps` sweeps of `_sweeps` (relax.py:129-137) on the
// VMEM-resident level, the masks from `_coords_and_masks` (relax.py:92-127):
// per sweep and colour (red x + y + z even, then black)
//   v = v + m * (kernel_update(v, f) - v)
// at every point of the level, boundary points included (m = 0 there: the
// nonzero Dirichlet data is read and stays as it is).  JAX gives 33^3 and
// below this kernel and 65^3 its slab kernel; here every padded level this
// kernel's layout holds takes it (ops/cuda/padded3d.py `leg_layout`:
// 65^3 ... 3^3 on a cubic hierarchy).
//
// Function: each half-sweep computes every point of the level from the
// values before it (the masked-off points too, as c + m d with m = 0:
// skipping them would change the bits of -0 and let NaN through), the
// update and mask of poisson3d.cuh.  Neighbours wrap modulo the extents,
// as torch.roll in the plain version (ops/cuda/padded3d.py sweeps_plain).
//
// Bytes and operations: a leg reads v and f once and writes v once, 12 B
// a point (3.3 MB at 65^3: 0.001 ms at 3.35 TB/s), and does 13 float32
// operations an interior point and sweep (the pair sums, products and
// sums, the negation, the scale, the blend's difference and sum): 3.5e8
// at 65^3 and 100 sweeps, 0.005 ms at 67 TFLOP/s.  Operation-bound on
// paper; on the card what bounds it is that at most 16 SMs work and each
// half-sweep waits for the one before (a barrier), 2 nsweeps times a leg.
//
// Design: the level's x planes are cut over one cluster of `nctas` CTAs
// (at most 16, non-portable; one CTA on levels of at most a thousand
// points), CTA k owning planes [k X / nctas, (k + 1) X / nctas).  Shared
// memory holds two copies of the CTA's planes of v: a half-sweep reads one
// and writes the other, so the old values stay readable to the whole
// cluster until a single cluster barrier ends the half-sweep (65^3: 5
// planes, 2 x 84.5 KB).  The x neighbours beyond the slab are read straight
// from the neighbouring CTA's copy through distributed shared memory (the
// first CTA's lower neighbour is the last CTA's last plane: x wraps over
// the level); on one CTA they are its own planes.  Thread t owns the points
// t + j threads (j < slots) of every plane of its slab, with their f in
// registers for the leg (PM x JM of them: the kernel's template instances)
// and their (y, z) decoded once; a half-sweep walks each slot's column of
// planes.  The final values end in the first copy
// (an even number of half-sweeps) and go to v once.  The layout (CTAs,
// threads, planes, slots, the instance) is the caller's
// (ops/cuda/padded3d.py `leg_layout`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "poisson3d.cuh"

namespace cg = cooperative_groups;

// ops/cuda/padded3d.py Padded3DLayout: the leg's launch geometry.
struct Padded3DLayout {
  int nctas;       // CTAs of the cluster (1: no cluster)
  int threads;     // a CTA
  int planes;      // the most x planes a CTA owns: ceil(X / nctas)
  int slots;       // points of a plane a thread: ceil(Y Z / threads)
  int pm, jm;      // the template instance (planes <= pm, slots <= jm)
  int smem_bytes;  // 2 copies of `planes` planes of v
};

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCtas = 16;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may hold

__device__ __forceinline__ void leg_sync(int nctas) {
  if (nctas > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <int PM, int JM>
__global__ void __launch_bounds__(kMaxThreads, 1)
    padded3d_leg_kernel(float* __restrict__ v, const float* __restrict__ f,
                        int nsweeps, const Padded3DLayout L,
                        const Poisson3D P) {
  extern __shared__ __align__(16) float sm[];
  const int X = P.nx, Y = P.ny, Z = P.nz, YZ = Y * Z;
  const int C = L.nctas, k = blockIdx.x, tid = threadIdx.x;
  const int x0 = k * X / C, np = (k + 1) * X / C - x0;
  const int copy = L.planes * YZ;  // floats of one copy
  // the lower neighbour's last plane within its copy (the upper
  // neighbour's first plane is at offset 0)
  const int kl = (k + C - 1) % C;
  const int lo_off = ((kl + 1) * X / C - kl * X / C - 1) * YZ;

  int yz[JM];  // (y << 16) | z of the thread's slot j, -1 past the plane
  float fr[PM][JM];
#pragma unroll
  for (int j = 0; j < JM; ++j) {
    const int s = tid + j * L.threads;
    const int y = s / Z;
    yz[j] = s < YZ ? (y << 16) | (s - y * Z) : -1;
  }
#pragma unroll
  for (int p = 0; p < PM; ++p) {
#pragma unroll
    for (int j = 0; j < JM; ++j) {
      fr[p][j] = 0.0f;
      if (p < np && yz[j] >= 0) {
        const int s = (yz[j] >> 16) * Z + (yz[j] & 0xffff);
        const long long g = (long long)(x0 + p) * YZ + s;
        sm[p * YZ + s] = v[g];
        if (f) fr[p][j] = f[g];
      }
    }
  }
  leg_sync(C);

  for (int h = 0; h < 2 * nsweeps; ++h) {
    const int colour = h & 1;
    const float* const src = sm + (h & 1) * copy;
    float* const dst = sm + ((h + 1) & 1) * copy;
    const float* lo;
    const float* hi;
    if (C > 1) {
      cg::cluster_group cl = cg::this_cluster();
      lo = cl.map_shared_rank(src + lo_off, (unsigned)kl);
      hi = cl.map_shared_rank(src, (unsigned)((k + 1) % C));
    } else {
      lo = src + (np - 1) * YZ;  // x wraps within the one CTA
      hi = src;
    }
    // a slot's (y, z) offsets and mask terms once, then its column of
    // planes
#pragma unroll
    for (int j = 0; j < JM; ++j) {
      if (yz[j] >= 0) {
        const int y = yz[j] >> 16, z = yz[j] & 0xffff;
        const int s = y * Z + z;
        const int ozm = z == 0 ? Z - 1 : -1, ozp = z == Z - 1 ? 1 - Z : 1;
        const int oym = y == 0 ? YZ - Z : -Z, oyp = y == Y - 1 ? Z - YZ : Z;
        const bool in_yz = y >= 1 && y <= Y - 2 && z >= 1 && z <= Z - 2;
#pragma unroll
        for (int p = 0; p < PM; ++p) {
          if (p < np) {
            const float* const pc = src + p * YZ + s;
            const int x = x0 + p;
            const float m = in_yz && x >= 1 && x <= X - 2 &&
                                    ((x + y + z) & 1) == colour
                                ? 1.0f
                                : 0.0f;
            dst[p * YZ + s] = poisson3d_blend(
                pc[0], p > 0 ? pc[-YZ] : lo[s], p < np - 1 ? pc[YZ] : hi[s],
                pc[oym], pc[oyp], pc[ozm], pc[ozp], fr[p][j], m, P);
          }
        }
      }
    }
    // every read of src (here and in the neighbours) done, every write of
    // dst visible to the cluster
    leg_sync(C);
  }
#pragma unroll
  for (int p = 0; p < PM; ++p) {
#pragma unroll
    for (int j = 0; j < JM; ++j) {
      if (p < np && yz[j] >= 0) {
        const int s = (yz[j] >> 16) * Z + (yz[j] & 0xffff);
        v[(long long)(x0 + p) * YZ + s] = sm[p * YZ + s];
      }
    }
  }
}

bool valid(const Padded3DLayout& L, const Poisson3D& P) {
  const int X = P.nx, Y = P.ny, Z = P.nz;
  if (X < 3 || Y < 3 || Z < 3 || Y >= (1 << 15) || Z >= (1 << 16)) {
    return false;
  }
  const long long YZ = (long long)Y * Z;
  if (L.nctas < 1 || L.nctas > kMaxCtas || L.nctas > X) return false;
  if (L.threads < 32 || L.threads > kMaxThreads || L.threads % 32) {
    return false;
  }
  if (L.planes != (X + L.nctas - 1) / L.nctas || L.planes > L.pm) {
    return false;
  }
  if (L.slots != (YZ + L.threads - 1) / L.threads || L.slots > L.jm) {
    return false;
  }
  const long long smem = 8LL * L.planes * YZ;
  return L.smem_bytes == smem && smem <= kMaxSmem;
}

template <int PM, int JM>
cudaError_t opt_in() {
  static const cudaError_t status = [] {
    cudaError_t e = cudaFuncSetAttribute(
        padded3d_leg_kernel<PM, JM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        padded3d_leg_kernel<PM, JM>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return status;
}

struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(const Padded3DLayout& L, cudaStream_t stream) {
    cfg.gridDim = dim3(L.nctas, 1, 1);
    cfg.blockDim = dim3(L.threads, 1, 1);
    cfg.dynamicSmemBytes = L.smem_bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = L.nctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = L.nctas > 1 ? 1 : 0;
  }
};

template <int PM, int JM>
int run(float* v, const float* f, int nsweeps, const Padded3DLayout& L,
        const Poisson3D& P, cudaStream_t stream, int* clusters) {
  cudaError_t e = opt_in<PM, JM>();
  if (e != cudaSuccess) return (int)e;
  Launch l(L, stream);
  if (clusters) {
    return (int)cudaOccupancyMaxActiveClusters(
        clusters, padded3d_leg_kernel<PM, JM>, &l.cfg);
  }
  e = cudaLaunchKernelEx(&l.cfg, padded3d_leg_kernel<PM, JM>, v, f, nsweeps,
                         L, P);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The template instances (ops/cuda/padded3d.py LEG_INSTANCES): 17^3 on 16
// CTAs, 33^3 on 16, 65^3 on 16, 9^3 and below on one CTA.
int dispatch(float* v, const float* f, int nsweeps, const Padded3DLayout& L,
             const Poisson3D& P, cudaStream_t stream, int* clusters) {
  if (!valid(L, P)) return (int)cudaErrorInvalidValue;
  if (L.pm == 2 && L.jm == 1) {
    return run<2, 1>(v, f, nsweeps, L, P, stream, clusters);
  }
  if (L.pm == 3 && L.jm == 2) {
    return run<3, 2>(v, f, nsweeps, L, P, stream, clusters);
  }
  if (L.pm == 5 && L.jm == 5) {
    return run<5, 5>(v, f, nsweeps, L, P, stream, clusters);
  }
  if (L.pm == 9 && L.jm == 1) {
    return run<9, 1>(v, f, nsweeps, L, P, stream, clusters);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// `nsweeps` (>= 1) sweeps on the padded level v (device memory, updated in
// place) with f, or f-less where f is null, one launch on the layout
// `lay`.  Default visibility spelled out: the host compiler hides a
// function whose body launches a kernel taking a type of this file's
// unnamed namespace.
__attribute__((visibility("default"))) int pdemg_padded3d(
    float* v, const float* f, int nsweeps, const Padded3DLayout* lay,
    const Poisson3D* p, void* stream) {
  if (!lay || !p || nsweeps < 1) return (int)cudaErrorInvalidValue;
  return dispatch(v, f, nsweeps, *lay, *p, (cudaStream_t)stream, nullptr);
}

// How many clusters of the launch `lay` the card can hold at once (0: it
// refuses the cluster), into *clusters; a CUDA error code.
__attribute__((visibility("default"))) int pdemg_padded3d_clusters(
    const Padded3DLayout* lay, const Poisson3D* p, int* clusters) {
  if (!lay || !p || !clusters) return (int)cudaErrorInvalidValue;
  return dispatch(nullptr, nullptr, 1, *lay, *p, nullptr, clusters);
}

}  // extern "C"
