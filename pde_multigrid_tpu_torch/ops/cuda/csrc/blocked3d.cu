// Blocked color-split red-black Gauss-Seidel on 3D wrap levels (sm_90a):
// T red-then-black sweeps per launch, halves in, halves out.
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_slab_relax_2d
//
// Layout: the halves of csrc/relax.cu, (X, Y/2, Z) each; with
// q = (x + z) % 2, red at y = 2j + q, black at y = 2j + 1 - q.  Inputs r, b
// and the RHS halves fr, fb; outputs ro, bo, apart from the inputs (tiles
// read points that other tiles own).
//
// The function is exactly 2T half-sweeps of csrc/relax.cu's
// half_sweep_kernel (the TPU kernel's row 9, make_split_slab_relax), in its
// order: the neighbour pair sums (x, y, z), split_update, the blend
// u + m (upd - u) with the masks of relax.py:1117-1151 from global
// coordinates, and neighbour indices that wrap modulo the extents onto the
// stored zero plane (grid.py:74-80), where the TPU kernel appends an
// always-zero row per blocked axis (relax.py:3463-3467).  With
// --fmad=false a launch equals 2T half_sweep_kernel launches bit for bit.
//
// Design: the TPU kernel blocks x and j and keeps whole Z rows in VMEM; a
// Z row of 256 or 512 floats times four arrays does not fit a CTA here, so
// a CTA owns a BX x BJ x BZ tile and blocks z as well.  It loads r and b on
// the tile and a halo of 2T points on each side of each axis (indices
// taken modulo the extents, once per CTA into three small tables, so a
// small level's tile may hold a point twice) into shared memory, runs the 2T half-sweeps there, half-sweep s
// (from 0) on the points s + 1 or more from the loaded region's faces (a
// half-sweep reads one point further along each axis; a point's RHS comes
// from global memory), with a barrier after each, and writes the owned
// points, which after 2T half-sweeps are 2T from the faces.  The colour of
// a point and its masks come from its global coordinates, so tiles start
// anywhere.  T is a run-time loop bound, 1 to 4 (the TPU kernel's j halo
// covers at most 4 sweeps, relax.py:3480).
//
// What bounds it: per owned point and launch it reads r, b, fr, fb once
// and writes r and b (24 B), plus the halo ((BX + 4T)(BJ + 4T)(BZ + 4T) /
// (BX BJ BZ) = 1.76 at T = 1) through the L2; per point and half-sweep
// 13 float operations.  Making it fast (fewer halo points, TMA loads, the
// RHS in shared memory) is later work.

#include <cuda_runtime.h>

#include "stencil.cuh"  // split_update

namespace {

constexpr int kThreads = 512;
constexpr int kMaxT = 4;

// the owned tile of a launch of T sweeps: 16 x 16 x 32 up to T = 2, then
// 8 x 8 x 32 (r and b with the halo at T = 4: 24 x 24 x 48 floats, 216 KB)
struct Tile {
  int bx, bj, bz;
};

inline Tile tile_for(int T) {
  return T <= 2 ? Tile{16, 16, 32} : Tile{8, 8, 32};
}

// r and b on the loaded region, then its wrapped global x, j, z indices
inline size_t smem_bytes(int T) {
  const Tile t = tile_for(T);
  const size_t lx = t.bx + 4 * T, lj = t.bj + 4 * T, lz = t.bz + 4 * T;
  return 2 * sizeof(float) * lx * lj * lz + sizeof(int) * (lx + lj + lz);
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__global__ void __launch_bounds__(kThreads)
    blocked3d_kernel(const float* __restrict__ r, const float* __restrict__ b,
                     const float* __restrict__ fr,
                     const float* __restrict__ fb, float* __restrict__ ro,
                     float* __restrict__ bo, int X, int Y2, int Z, int T,
                     int BX, int BJ, int BZ, float w0, float w1, float w2,
                     float inv_den) {
  extern __shared__ float sm[];
  const int H = 2 * T;
  const int LX = BX + 2 * H, LJ = BJ + 2 * H, LZ = BZ + 2 * H;
  const int n = LX * LJ * LZ;
  const int SX = LJ * LZ;  // local stride of x
  float* sr = sm;
  float* sb = sm + n;
  // the global index of each local x, j and z (wrapped)
  int* gx = reinterpret_cast<int*>(sm + 2 * n);
  int* gj = gx + LX;
  int* gz = gj + LJ;
  // global coordinates of local point 0 (before the wrap)
  const int x0 = blockIdx.z * BX - H;
  const int j0 = blockIdx.y * BJ - H;
  const int z0 = blockIdx.x * BZ - H;
  const long long plane = (long long)Y2 * Z;
  for (int i = threadIdx.x; i < LX + LJ + LZ; i += blockDim.x) {
    if (i < LX) {
      gx[i] = wrap(x0 + i, X);
    } else if (i < LX + LJ) {
      gj[i - LX] = wrap(j0 + i - LX, Y2);
    } else {
      gz[i - LX - LJ] = wrap(z0 + i - LX - LJ, Z);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lx = i / SX;
    const int t = i - lx * SX;
    const int lj = t / LZ;
    const int lz = t - lj * LZ;
    const long long g = gx[lx] * plane + (long long)gj[lj] * Z + gz[lz];
    sr[i] = r[g];
    sb[i] = b[g];
  }
  __syncthreads();

  for (int s = 0; s < H; ++s) {  // 2T half-sweeps
    const int color = s & 1;  // red first
    float* u = color == 0 ? sr : sb;        // the colour updated
    const float* w = color == 0 ? sb : sr;  // the other colour
    const float* fu = color == 0 ? fr : fb;
    const int k = s + 1;  // the region's distance from the faces
    const int RX = LX - 2 * k, RJ = LJ - 2 * k, RZ = LZ - 2 * k;
    const int RP = RJ * RZ;
    for (int i = threadIdx.x; i < RX * RP; i += blockDim.x) {
      const int px = i / RP;
      const int t = i - px * RP;
      const int pj = t / RZ;
      const int lx = k + px;
      const int lj = k + pj;
      const int lz = k + t - pj * RZ;
      const int x = gx[lx];
      const int j = gj[lj];
      const int z = gz[lz];
      const int q = (x + z) & 1;
      const int c = (lx * LJ + lj) * LZ + lz;
      // neighbour pair sums in the TPU kernel's order (relax.py:1164-1176)
      const float p0 = w[c - SX] + w[c + SX];
      // red: y-pair = w[j] + (q ? w[j+1] : w[j-1]); black: the mirror
      const int jo = (color == 0) == (q == 1) ? LZ : -LZ;
      const float p1 = w[c] + w[c + jo];
      const float p2 = w[c - 1] + w[c + 1];
      const float upd = split_update(p0, p1, p2,
                                     fu[x * plane + (long long)j * Z + z],
                                     w0, w1, w2, inv_den);
      const bool jz_ok = (j >= 1) || (color == 0 ? q == 1 : q == 0);
      const float m = (x >= 1 && z >= 1 && jz_ok) ? 1.0f : 0.0f;
      const float old = u[c];
      u[c] = old + m * (upd - old);
    }
    __syncthreads();  // this colour done before the other reads it
  }

  for (int i = threadIdx.x; i < BX * BJ * BZ; i += blockDim.x) {
    const int ox = i / (BJ * BZ);
    const int t = i - ox * (BJ * BZ);
    const int oj = t / BZ;
    const int oz = t - oj * BZ;
    const int x = x0 + H + ox, j = j0 + H + oj, z = z0 + H + oz;
    if (x >= X || j >= Y2 || z >= Z) continue;
    const int c = ((ox + H) * LJ + oj + H) * LZ + oz + H;
    const long long g = x * plane + (long long)j * Z + z;
    ro[g] = sr[c];
    bo[g] = sb[c];
  }
}

}  // namespace

extern "C" {

// One launch of T sweeps on the (X, Y2, Z) halves r, b with RHS halves fr,
// fb -> ro, bo.
int pdemg_blocked3d(const float* r, const float* b, const float* fr,
                    const float* fb, float* ro, float* bo, int X, int Y2,
                    int Z, int T, float w0, float w1, float w2, float inv_den,
                    void* stream) {
  if (T < 1 || T > kMaxT || X < 1 || Y2 < 1 || Z < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Tile t = tile_for(T);
  const int gy = (Y2 + t.bj - 1) / t.bj, gz = (X + t.bx - 1) / t.bx;
  if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidConfiguration;
  static bool opted_in = false;  // once per process, outside any capture
  if (!opted_in) {
    size_t most = 0;
    for (int k = 1; k <= kMaxT; ++k) {
      most = smem_bytes(k) > most ? smem_bytes(k) : most;
    }
    const cudaError_t e = cudaFuncSetAttribute(
        blocked3d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)most);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((Z + t.bz - 1) / t.bz, gy, gz);
  blocked3d_kernel<<<grid, kThreads, smem_bytes(T), (cudaStream_t)stream>>>(
      r, b, fr, fb, ro, bo, X, Y2, Z, T, t.bx, t.bj, t.bz, w0, w1, w2,
      inv_den);
  return (int)cudaGetLastError();
}

}  // extern "C"
