// Red-black Gauss-Seidel on a 3D Poisson level in padded storage, one
// colour half-sweep a launch (sm_90a): the levels no whole-leg kernel
// holds.
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_slab_relax
//       (relax.py:334) on 3D padded Poisson levels (align = 1)
// which runs T sweeps of `_sweeps` (relax.py:129-137) a call on x slabs
// streamed through VMEM with 2T-plane halos: per sweep and colour
//   v = v + m * (kernel_update(v, f) - v)
// at every point of the level.  JAX gives 129^3 and 65^3 this kernel and
// runs 257^3 and 513^3 in its jnp tier (no slab fits its VMEM budget);
// here every padded level that ops/cuda/padded3d.py's leg does not hold
// takes it (129^3, 257^3, 513^3 on a cubic hierarchy).
//
// Function: one colour of `_sweeps`, from v into out (not aliasing v):
// out = c + m d at every point of the level, the masked-off points too
// (m = 0; see padded3d.cu), the update and mask of poisson3d.cuh;
// neighbours wrap modulo the extents, as torch.roll in the plain version.
// A sweep is two launches, red from v into a scratch array and black from
// the scratch back into v (ops/cuda/slab3d.py slab3d_relax).
//
// Design: a thread a point, threads along a plane's flat (y, z) index,
// blockIdx.y the x plane.  The blocks of one plane are issued before the
// next plane's, so the planes either side of a block are read mostly from
// the L2.  Every value comes from the same inputs in the same order as the
// plain version's, so a launch is its half-sweep bit for bit.
//
// Bytes and operations: a sweep of the function reads v and f and writes
// v, 12 B a point: 0.484 ms at 513^3 at 3.35 TB/s, bound by bytes (13
// float32 operations an interior point: 0.026 ms).  This form moves 12 B
// a point a half-sweep, 24 a sweep; its times beside the bound are in
// PERF.md, and the second pass is ROADMAP.md queue 2 item 53.

#include <cuda_runtime.h>

#include "poisson3d.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    slab3d_half_sweep_kernel(const float* __restrict__ v,
                             const float* __restrict__ f,
                             float* __restrict__ out, int colour,
                             const Poisson3D P) {
  const int X = P.nx, Y = P.ny, Z = P.nz, YZ = Y * Z;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= YZ) return;
  const int x = blockIdx.y;
  const int y = s / Z, z = s - y * Z;
  const long long S = YZ;
  const float* const pl = v + x * S;
  const float xm = (x == 0 ? pl + (X - 1) * S : pl - S)[s];
  const float xp = (x == X - 1 ? v : pl + S)[s];
  const float ym = pl[y == 0 ? s + YZ - Z : s - Z];
  const float yp = pl[y == Y - 1 ? s - (YZ - Z) : s + Z];
  const float zm = pl[z == 0 ? s + Z - 1 : s - 1];
  const float zp = pl[z == Z - 1 ? s - (Z - 1) : s + 1];
  const float fv = f ? f[x * S + s] : 0.0f;  // f-less: -0 + a is a
  out[x * S + s] =
      poisson3d_blend(pl[s], xm, xp, ym, yp, zm, zp, fv,
                      poisson3d_mask(x, y, z, colour, P), P);
}

}  // namespace

extern "C" {

// One colour (0 red, 1 black) of the padded level v into out (device
// memory, not aliasing v), with f or f-less where f is null.  Default
// visibility spelled out: the host compiler hides a function whose body
// launches a kernel taking a type of this file's unnamed namespace.
__attribute__((visibility("default"))) int pdemg_slab3d(
    const float* v, const float* f, float* out, int colour,
    const Poisson3D* p, void* stream) {
  if (!p || p->nx < 3 || p->ny < 3 || p->nz < 3 || p->nx > 65535 ||
      (colour != 0 && colour != 1) ||
      (long long)p->ny * p->nz >= (1LL << 31) - kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int YZ = p->ny * p->nz;
  const dim3 grid((YZ + kThreads - 1) / kThreads, p->nx);
  slab3d_half_sweep_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      v, f, out, colour, *p);
  return (int)cudaGetLastError();
}

}  // extern "C"
