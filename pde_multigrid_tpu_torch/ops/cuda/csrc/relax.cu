// Color-split red-black Gauss-Seidel for 3D wrap-storage levels (sm_90a).
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/relax.py:_pallas_split          (dense -> halves)
//   pde_multigrid_tpu/ops/pallas/relax.py:_pallas_merge          (halves -> dense)
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_slab_relax  (the sweeps)
//
// Layout ("halves"): a dense (X, Y, Z) float32 level is stored as two
// (X, Y/2, Z) arrays.  With q = (x + z) % 2, red (parity 0) lives at
// y = 2j + q and black at y = 2j + 1 - q, so every neighbour of a red
// point is black and vice versa: a half-sweep computes exactly the points
// it updates.
//
// What bounds these kernels on the card: device-memory traffic.  A
// half-sweep reads the updated color (4 B), its RHS half (4 B) and the
// other color's seven neighbours, which the L1/L2 caches serve from one
// streamed read (4 B), and writes 4 B: about 16 B per updated point for
// one flop-light 7-point update.  split/merge move 8 B per dense point.
// The simple design: one thread per output point, consecutive threads on
// consecutive z (coalesced loads and stores), neighbours read straight
// from global memory and left to the caches, one launch per half-sweep.
// No tiling in shared memory and no sweeps fused per launch yet: the TPU
// kernel's trapezoidal multi-sweep slabs are the obvious next step.
//
// Wrap storage: stored plane 0 of each axis is the zero Dirichlet boundary
// for both ends, so neighbour indices wrap modulo the extent (the +1
// neighbour of x = X-1 is plane 0, which the masks never update).  The
// masks are those of relax.py:1117-1151: x >= 1 and z >= 1, red
// `j >= 1 || q == 1`, black `j >= 1 || q == 0`.
//
// Numerics: built with --fmad=false, so every product and sum rounds on
// its own exactly as the plain PyTorch version (ops/cuda/relax.py) does;
// the two agree bit for bit.
//
// The error-equation half-sweep (error_half_sweep_kernel) replaces
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_resident_sweeps
// the inner smoother of the bf16 defect correction (ops/cuda/defect.py):
// nu red-black sweeps of A e = r from e = 0 on bf16 halves, computed in
// float32 with Poisson.split_update_folded, each write `ok ? upd : 0`
// (masked-off error points are identically zero, so the old value is
// never read), and with the first red half-sweep reading no black half
// (v_zero).  It moves about 6 B per updated point (RHS 2, other color 2
// through the caches, write 2) against the f32 half-sweep's 16 B, but
// one point per thread issues the same 8 loads and 1 store per point as
// the f32 kernel, and an A/B on the card showed that instruction count,
// not the bytes, bounds both.  So each thread updates two consecutive z
// points (z0 even, z0 + 1: opposite parities) from bf16x2 loads: 8 loads
// and 1 store per two points.  It is launched as rows (threads along z,
// blockIdx.y = j, blockIdx.z = x): a thread finds its points without the
// 64-bit division and modulo the f32 kernels above pay.  The TPU kernel
// keeps all four halves in VMEM for the whole leg in one launch; here
// each half-sweep is its own launch (each color phase covers the whole
// level before the other color starts, the TPU kernel's global
// red->black order); a persistent launch per leg with the halves held in
// the 50 MB L2 is later work.  The wrap-neighbour reads with these masks
// equal the TPU kernel's zero padding rows plus its re-zeroed row 0:
// plane 0 of each half is always written 0.  bf16 conversions go only
// through __bfloat162float (exact) and __float2bfloat16_rn (round to
// nearest even, as torch's .to(bfloat16)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stencil.cuh"  // split_update, row_grid, row_block, row_launch_ok

namespace {

constexpr int kThreads = 256;

__global__ void split_kernel(const float* __restrict__ v,
                             float* __restrict__ r, float* __restrict__ b,
                             int X, int Y2, int Z) {
  const long long n = (long long)X * Y2 * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % Z);
  const long long xj = i / Z;
  const int j = (int)(xj % Y2);
  const int x = (int)(xj / Y2);
  const int q = (x + z) & 1;
  const long long row = ((long long)x * (2 * Y2) + 2 * j) * Z + z;
  if (r) r[i] = v[row + (long long)q * Z];  // null: the black half only
  b[i] = v[row + (long long)(1 - q) * Z];
}

__global__ void merge_kernel(const float* __restrict__ r,
                             const float* __restrict__ b,
                             float* __restrict__ v, int X, int Y2, int Z) {
  const long long n = (long long)X * Y2 * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % Z);
  const long long xj = i / Z;
  const int j = (int)(xj % Y2);
  const int x = (int)(xj / Y2);
  const int q = (x + z) & 1;
  const long long row = ((long long)x * (2 * Y2) + 2 * j) * Z + z;
  v[row + (long long)q * Z] = r[i];
  v[row + (long long)(1 - q) * Z] = b[i];
}

// One half-sweep: u (the color being updated) in place from w (the other
// color) and fu (u's RHS half).  color 0 = red, 1 = black.
__global__ void half_sweep_kernel(float* __restrict__ u,
                                  const float* __restrict__ w,
                                  const float* __restrict__ fu,
                                  int X, int Y2, int Z, int color,
                                  float w0, float w1, float w2,
                                  float inv_den) {
  const long long n = (long long)X * Y2 * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % Z);
  const long long xj = i / Z;
  const int j = (int)(xj % Y2);
  const int x = (int)(xj / Y2);
  const int q = (x + z) & 1;

  const long long plane = (long long)Y2 * Z;
  const int xm = (x == 0) ? X - 1 : x - 1;
  const int xp = (x == X - 1) ? 0 : x + 1;
  const int jm = (j == 0) ? Y2 - 1 : j - 1;
  const int jp = (j == Y2 - 1) ? 0 : j + 1;
  const int zm = (z == 0) ? Z - 1 : z - 1;
  const int zp = (z == Z - 1) ? 0 : z + 1;
  const long long base = (long long)x * plane + (long long)j * Z;

  // neighbour pair sums, in the TPU kernel's order (relax.py:1164-1176)
  const float p0 = w[(long long)xm * plane + (long long)j * Z + z] +
                   w[(long long)xp * plane + (long long)j * Z + z];
  // red: y-pair = w[j] + (q ? w[j+1] : w[j-1]); black: the mirror
  const int jo = (color == 0) ? (q ? jp : jm) : (q ? jm : jp);
  const float p1 = w[base + z] + w[(long long)x * plane + (long long)jo * Z + z];
  const float p2 = w[base + zm] + w[base + zp];

  const float upd = split_update(p0, p1, p2, fu[i], w0, w1, w2, inv_den);

  const bool jz_ok = (j >= 1) || (color == 0 ? q == 1 : q == 0);
  const float m = (x >= 1 && z >= 1 && jz_ok) ? 1.0f : 0.0f;
  const float old = u[i];
  u[i] = old + m * (upd - old);
}

// Poisson.split_update_folded in the plain version's order: iso
// (p0+p1+p2)*a0 - r*inv_den; otherwise -r*inv_den + p0*a0 + p1*a1 + p2*a2
// (a_ax = w_ax*inv_den).
__device__ __forceinline__ float folded_update(float p0, float p1, float p2,
                                               float r, int iso, float a0,
                                               float a1, float a2,
                                               float inv_den) {
  if (iso) {
    float s = p0 + p1;
    s = s + p2;
    return s * a0 - r * inv_den;
  }
  float u = (-r) * inv_den;
  u = u + p0 * a0;
  u = u + p1 * a1;
  u = u + p2 * a2;
  return u;
}

__device__ __forceinline__ __nv_bfloat162 ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const __nv_bfloat162*>(p);
}

// One half-sweep of the error equation at the points z0 = 2t, z0 + 1 of
// row (x, j): eu (bf16, the color being updated) written from ew (bf16,
// the other color; not read when v_zero) and ru (bf16, eu's residual
// half).  Z is even, and every row starts 4-byte aligned.
__global__ void error_half_sweep_kernel(__nv_bfloat16* __restrict__ eu,
                                        const __nv_bfloat16* __restrict__ ew,
                                        const __nv_bfloat16* __restrict__ ru,
                                        int X, int Y2, int Z, int color,
                                        int v_zero, int iso, float a0,
                                        float a1, float a2, float inv_den) {
  const int z0 = 2 * (blockIdx.x * blockDim.x + threadIdx.x);  // row launch
  if (z0 >= Z) return;
  const int j = blockIdx.y;
  const int x = blockIdx.z;
  const int q0 = (x + z0) & 1;  // z0 + 1 has parity 1 - q0
  // red with q = 1 or black with q = 0: the point's y-pair partner row is
  // j + 1, and it never lies on the y = 0 boundary
  const bool up0 = (color == 0) == (q0 == 1);
  const long long plane = (long long)Y2 * Z;
  const long long i = (long long)x * plane + (long long)j * Z + z0;

  // pair sums in the f32 half-sweep's order; zero from e = 0
  float p0[2] = {0.0f, 0.0f}, p1[2] = {0.0f, 0.0f}, p2[2] = {0.0f, 0.0f};
  if (!v_zero) {
    const int xm = (x == 0) ? X - 1 : x - 1;
    const int xp = (x == X - 1) ? 0 : x + 1;
    const int jm = (j == 0) ? Y2 - 1 : j - 1;
    const int jp = (j == Y2 - 1) ? 0 : j + 1;
    const int zm = (z0 == 0) ? Z - 1 : z0 - 1;     // below z0
    const int zp = (z0 + 2 == Z) ? 0 : z0 + 2;      // above z0 + 1
    const long long row = i - z0;  // (x, j, 0)
    const long long jz = (long long)j * Z + z0;
    const __nv_bfloat162 c = ld2(ew + i);
    const __nv_bfloat162 a = ld2(ew + xm * plane + jz);
    const __nv_bfloat162 b = ld2(ew + xp * plane + jz);
    const __nv_bfloat162 yp = ld2(ew + x * plane + (long long)jp * Z + z0);
    const __nv_bfloat162 ym = ld2(ew + x * plane + (long long)jm * Z + z0);
    const float wzm = __bfloat162float(ew[row + zm]);
    const float wzp = __bfloat162float(ew[row + zp]);
    p0[0] = __low2float(a) + __low2float(b);
    p0[1] = __high2float(a) + __high2float(b);
    p1[0] = __low2float(c) + (up0 ? __low2float(yp) : __low2float(ym));
    p1[1] = __high2float(c) + (up0 ? __high2float(ym) : __high2float(yp));
    p2[0] = wzm + __high2float(c);
    p2[1] = __low2float(c) + wzp;
  }
  const __nv_bfloat162 r = ld2(ru + i);
  const float u0 = folded_update(p0[0], p1[0], p2[0], __low2float(r), iso,
                                 a0, a1, a2, inv_den);
  const float u1 = folded_update(p0[1], p1[1], p2[1], __high2float(r), iso,
                                 a0, a1, a2, inv_den);
  // masks: x >= 1, z >= 1, and red `j >= 1 or q == 1`, black
  // `j >= 1 or q == 0` (z0 + 1 >= 1 always)
  const bool ok0 = x >= 1 && z0 >= 1 && (j >= 1 || up0);
  const bool ok1 = x >= 1 && (j >= 1 || !up0);
  __nv_bfloat162 out;
  out.x = __float2bfloat16_rn(ok0 ? u0 : 0.0f);
  out.y = __float2bfloat16_rn(ok1 ? u1 : 0.0f);
  *reinterpret_cast<__nv_bfloat162*>(eu + i) = out;
}

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int pdemg_split(const float* v, float* r, float* b, int X, int Y2, int Z,
                void* stream) {
  const long long n = (long long)X * Y2 * Z;
  split_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      v, r, b, X, Y2, Z);
  return (int)cudaGetLastError();
}

int pdemg_merge(const float* r, const float* b, float* v, int X, int Y2,
                int Z, void* stream) {
  const long long n = (long long)X * Y2 * Z;
  merge_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      r, b, v, X, Y2, Z);
  return (int)cudaGetLastError();
}

int pdemg_half_sweep(float* u, const float* w, const float* fu, int X,
                     int Y2, int Z, int color, float w0, float w1, float w2,
                     float inv_den, void* stream) {
  const long long n = (long long)X * Y2 * Z;
  half_sweep_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      u, w, fu, X, Y2, Z, color, w0, w1, w2, inv_den);
  return (int)cudaGetLastError();
}

int pdemg_error_half_sweep(__nv_bfloat16* eu, const __nv_bfloat16* ew,
                           const __nv_bfloat16* ru, int X, int Y2, int Z,
                           int color, int v_zero, int iso, float a0,
                           float a1, float a2, float inv_den, void* stream) {
  if (!row_launch_ok(X, Y2) || Z % 2) {
    return (int)cudaErrorInvalidConfiguration;
  }
  // one thread per two points of a row
  error_half_sweep_kernel<<<row_grid(X, Y2, Z / 2), row_block(Z / 2), 0,
                            (cudaStream_t)stream>>>(
      eu, ew, ru, X, Y2, Z, color, v_zero, iso, a0, a1, a2, inv_den);
  return (int)cudaGetLastError();
}

}  // extern "C"
