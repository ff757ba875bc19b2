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
// Design: planes streamed along x.  A CTA owns a BJ x BZ tile of (j, z)
// and a band of B x planes, loads the tile with a 2T halo in j and z
// (indices wrapped modulo the extents, so a small level's tile may hold a
// point twice) one x plane a step, from 2T planes before the band to 2T
// after it (the lead-in, recomputed by the neighbouring bands), and runs
// the 2T half-sweeps as a pipeline one plane apart: half-sweep h updates
// its colour on plane k - 1 - h at step k, on the points h + 1 or more
// from the tile's faces (a half-sweep reads one point further along each
// axis), from the other colour as half-sweep h - 1 left it.  So each of
// r, b, fr, fb is read once a band per tile point, each owned point is
// written once, and the wrap is resolved at band and tile edges only.
// Two forms:
//  - T = 1, the path's (blocked3d_stream_kernel): 16 x 64 tiles, 256
//    threads, two CTAs an SM; a thread holds its points of the tile for
//    the whole band, and per point the x neighbours both half-sweeps read
//    in registers (black's old planes k - 2 .. k, red's new k - 3 .. k - 1)
//    with the next plane's loads in flight; only the j and z neighbours go
//    through shared memory, two double-buffered planes, one barrier a step;
//  - T = 2 .. 4 (blocked3d_kernel<T>): a ring of 2T + 3 planes of r, b,
//    fr, fb in shared memory, plane k + 1 issued by cp.async at step k,
//    the half-sweeps updating their colour in place, a barrier after each;
//    16 x 32 tiles at T = 2, 8 x 32 above.
// T is 1 to 4 (the TPU kernel's j halo covers at most 4 sweeps,
// relax.py:3480).
//
// What bounds it: per owned point and launch it reads r, b, fr, fb once
// and writes r and b (24 B: 0.060 ms at 256^3 at 3.35 TB/s); the tile's
// halo ((BJ + 4T)(BZ + 4T) / (BJ BZ) = 1.33 at T = 1) and the band's
// lead-in ((B + 4T) / B = 1.125 at 256^3) are read through the L2; per
// point and half-sweep 13 float operations, at T = 1 three shared-memory
// loads.

#include <cuda_runtime.h>

#include "stencil.cuh"  // split_update

// The launch: the level's halves (X, Y2, Z), T, the owned tile BJ x BZ
// and band of B planes, the tiles along j and z and the bands along x
// (ops/cuda/blocked3d.layout).
struct Blocked3DLayout {
  int X, Y2, Z;
  int T;
  int BJ, BZ, B;
  int tj, tz, bands;
  int threads, smem_bytes;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxT = 4;

template <int T>
struct TileOf;
template <>
struct TileOf<2> {
  static constexpr int BJ = 16, BZ = 32;
};
template <>
struct TileOf<3> {
  static constexpr int BJ = 8, BZ = 32;
};
template <>
struct TileOf<4> {
  static constexpr int BJ = 8, BZ = 32;
};

// the ring of r, b, fr, fb planes on the tile with its halo, then the
// wrapped global j and z of each local one
template <int T>
constexpr size_t smem_bytes() {
  constexpr int LJ = TileOf<T>::BJ + 4 * T, LZ = TileOf<T>::BZ + 4 * T;
  return sizeof(float) * 4 * (2 * T + 3) * LJ * LZ + sizeof(int) * (LJ + LZ);
}

__device__ __forceinline__ int wrap(int i, int n) {
  i %= n;
  return i < 0 ? i + n : i;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <int T>
__global__ void __launch_bounds__(kThreads, T <= 2 ? 2 : 1)
    blocked3d_kernel(const float* __restrict__ r, const float* __restrict__ b,
                     const float* __restrict__ fr,
                     const float* __restrict__ fb, float* __restrict__ ro,
                     float* __restrict__ bo, const Blocked3DLayout L,
                     float w0, float w1, float w2, float inv_den) {
  constexpr int H = 2 * T;  // the halo, and the half-sweeps
  constexpr int BJ = TileOf<T>::BJ, BZ = TileOf<T>::BZ;
  constexpr int LJ = BJ + 2 * H, LZ = BZ + 2 * H, NPL = LJ * LZ;
  constexpr int R = 2 * T + 3;  // ring slots
  extern __shared__ float sm[];
  int* gj = reinterpret_cast<int*>(sm + 4 * R * NPL);
  int* gz = gj + LJ;
  const int X = L.X, Y2 = L.Y2, Z = L.Z;
  const int j0 = blockIdx.y * BJ, z0 = blockIdx.x * BZ;
  const int x0 = blockIdx.z * L.B;
  const int nown = min(L.B, X - x0);
  const int NP = nown + 2 * H;  // planes a band streams
  const long long plane = (long long)Y2 * Z;
  const int tid = threadIdx.x;
  for (int i = tid; i < LJ + LZ; i += kThreads) {
    if (i < LJ) {
      gj[i] = wrap(j0 - H + i, Y2);
    } else {
      gz[i - LJ] = wrap(z0 - H + i - LJ, Z);
    }
  }
  __syncthreads();

  // array a (0 r, 1 b, 2 fr, 3 fb) on local plane i
  auto slot = [&](int a, int i) { return sm + (a * R + i % R) * NPL; };
  auto load = [&](int i) {
    const long long gx = wrap(x0 - H + i, X);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float* src = (a == 0 ? r : a == 1 ? b : a == 2 ? fr : fb) +
                         gx * plane;
      float* dst = slot(a, i);
      for (int e = tid; e < NPL; e += kThreads) {
        const int lj = e / LZ;
        cp_async4(dst + e, src + (long long)gj[lj] * Z + gz[e - lj * LZ]);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the owned points of a final plane of colour a into its output
  auto store = [&](int a, int i) {
    if (i < H || i >= H + nown) return;
    const float* s = slot(a, i);
    float* dst = (a == 0 ? ro : bo) + (long long)(x0 + i - H) * plane;
    for (int e = tid; e < BJ * BZ; e += kThreads) {
      const int oj = e / BZ;
      const int oz = e - oj * BZ;
      if (j0 + oj < Y2 && z0 + oz < Z) {
        dst[(long long)(j0 + oj) * Z + z0 + oz] =
            s[(oj + H) * LZ + oz + H];
      }
    }
  };

  load(0);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int k = 0; k < NP; ++k) {
    // red's last half-sweep (2T - 2) and black's (2T - 1) finished plane
    // k - 2T and k - 1 - 2T at step k - 1
    store(0, k - H);
    store(1, k - 1 - H);
    if (k + 1 < NP) {
      load(k + 1);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {  // the half-sweeps, red first
      const int pl = k - 1 - h;
      const int color = h & 1;
      if (pl >= h + 1 && pl <= NP - 2 - h) {
        float* u = slot(color, pl);          // the colour updated
        const float* w = slot(1 - color, pl);  // the other colour
        const float* wm = slot(1 - color, pl - 1);
        const float* wp = slot(1 - color, pl + 1);
        const float* fu = slot(2 + color, pl);
        const int x = wrap(x0 - H + pl, X);
        const int RJ = LJ - 2 * (h + 1), RZ = LZ - 2 * (h + 1);
        for (int e = tid; e < RJ * RZ; e += kThreads) {
          const int pj = e / RZ;
          const int lj = h + 1 + pj;
          const int lz = h + 1 + e - pj * RZ;
          const int c = lj * LZ + lz;
          const int j = gj[lj];
          const int z = gz[lz];
          const int q = (x + z) & 1;
          // neighbour pair sums in the TPU kernel's order
          // (relax.py:1164-1176)
          const float p0 = wm[c] + wp[c];
          // red: y-pair = w[j] + (q ? w[j+1] : w[j-1]); black: the mirror
          const int jo = (color == 0) == (q == 1) ? LZ : -LZ;
          const float p1 = w[c] + w[c + jo];
          const float p2 = w[c - 1] + w[c + 1];
          const float upd =
              split_update(p0, p1, p2, fu[c], w0, w1, w2, inv_den);
          const bool jz_ok = (j >= 1) || (color == 0 ? q == 1 : q == 0);
          const float m = (x >= 1 && z >= 1 && jz_ok) ? 1.0f : 0.0f;
          const float old = u[c];
          u[c] = old + m * (upd - old);
        }
      }
      if (h + 1 < H) __syncthreads();  // this colour done before the next
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  store(1, NP - 1 - H);
}

// T = 1, the path's form: registers streamed along x.  A thread holds
// kK points of the (kBJ + 4) x (kBZ + 4) tile with its halo for the whole
// band, and per point black's old planes k - 2 .. k, red's new k - 3 and
// k - 2, red's old k - 1, fr of k - 1 and fb of k - 2, and the next
// step's loads in flight.  At step k (plane k loaded) it updates
// red on plane k - 1 (x neighbours from its registers, j and z neighbours
// from black's plane k - 1 in shared memory) on the points 1 or more from
// the faces, then black on plane k - 2 (red's new planes k - 3 and k - 1 in
// registers, plane k - 2 in shared memory) on the owned points, writes
// plane k - 2's red and black out, and puts black's plane k and red's new
// plane k - 1 into the other halves of two double-buffered shared planes:
// one barrier a step.
constexpr int kBJ = 16, kBZ = 64;
constexpr int kLJ = kBJ + 4, kLZ = kBZ + 4, kNPL = kLJ * kLZ;
constexpr int kK = (kNPL + kThreads - 1) / kThreads;
constexpr size_t kStreamSmem = sizeof(float) * 4 * kNPL;

__global__ void __launch_bounds__(kThreads, 2)
    blocked3d_stream_kernel(const float* __restrict__ r,
                            const float* __restrict__ b,
                            const float* __restrict__ fr,
                            const float* __restrict__ fb,
                            float* __restrict__ ro, float* __restrict__ bo,
                            const Blocked3DLayout L, float w0, float w1,
                            float w2, float inv_den) {
  __shared__ float sb[2][kNPL];  // black's old plane k - 1 (and k)
  __shared__ float sr[2][kNPL];  // red's new plane k - 2 (and k - 1)
  const int X = L.X, Y2 = L.Y2, Z = L.Z;
  const int j0 = blockIdx.y * kBJ, z0 = blockIdx.x * kBZ;
  const int x0 = blockIdx.z * L.B;
  const int nown = min(L.B, X - x0);
  const int NP = nown + 4;  // planes a band streams: 2 of lead-in a side
  const long long plane = (long long)Y2 * Z;
  const int tid = threadIdx.x;
  // this thread's points: the in-plane offset, and bits: 1 red (1 or more
  // from the faces), 2 black (2 or more: owned), 4 written out (owned and
  // inside the level), 8 j >= 1, 16 z >= 1, 32 z odd
  int goff[kK];
  unsigned bits[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    const int e = tid + i * kThreads;
    const int lj = min(e, kNPL - 1) / kLZ;
    const int lz = min(e, kNPL - 1) - lj * kLZ;
    const int j = wrap(j0 - 2 + lj, Y2), z = wrap(z0 - 2 + lz, Z);
    goff[i] = j * Z + z;
    const int inset = min(min(lj, kLJ - 1 - lj), min(lz, kLZ - 1 - lz));
    const bool owned = inset >= 2 && j0 + lj - 2 < Y2 && z0 + lz - 2 < Z;
    bits[i] = e < kNPL
                  ? (inset >= 1 ? 1u : 0u) | (inset >= 2 ? 2u : 0u) |
                        (owned ? 4u : 0u) | (j >= 1 ? 8u : 0u) |
                        (z >= 1 ? 16u : 0u) | (z & 1 ? 32u : 0u)
                  : 0u;
  }
  auto gx = [&](int i) { return (long long)wrap(x0 - 2 + i, X) * plane; };
  float bq0[kK], bq1[kK], bq2[kK], rn3[kK], rn2[kK], r1[kK], f1[kK],
      g2[kK], bin[kK], rin[kK], fin[kK], gin[kK];
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    bq0[i] = bq1[i] = rn3[i] = rn2[i] = r1[i] = f1[i] = g2[i] = 0.0f;
    bq2[i] = bits[i] ? b[gx(0) + goff[i]] : 0.0f;
  }
  for (int k = 0; k < NP; ++k) {
    const long long pn = gx(k + 1), pk = gx(k), pm = gx(k - 1);
#pragma unroll
    for (int i = 0; i < kK; ++i) {  // the next step's planes
      const bool in = bits[i] != 0;
      bin[i] = in && k + 1 < NP ? b[pn + goff[i]] : 0.0f;
      rin[i] = in ? r[pk + goff[i]] : 0.0f;
      fin[i] = in ? fr[pk + goff[i]] : 0.0f;
      gin[i] = in && k >= 1 ? fb[pm + goff[i]] : 0.0f;
    }
    const float* SB = sb[(k - 1) & 1];
    const float* SR = sr[(k - 2) & 1];
    const bool red_ok = k - 1 >= 1 && k - 1 <= NP - 2;
    const bool black_ok = k - 2 >= 2 && k - 2 <= NP - 3;
    const int xr = wrap(x0 + k - 3, X), xb = wrap(x0 + k - 4, X);
    const long long po = (long long)(x0 + k - 4) * plane;
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const int c = min(tid + i * kThreads, kNPL - 1);
      const unsigned bt = bits[i];
      float rnew = r1[i];
      if (red_ok && (bt & 1u)) {  // red on plane k - 1
        const int q = (xr ^ (int)(bt >> 5)) & 1;
        const float p0 = bq0[i] + bq2[i];
        const float p1 = bq1[i] + SB[q ? c + kLZ : c - kLZ];
        const float p2 = SB[c - 1] + SB[c + 1];
        const float upd = split_update(p0, p1, p2, f1[i], w0, w1, w2,
                                       inv_den);
        const bool jz_ok = (bt & 8u) || q == 1;
        const float m = (xr >= 1 && (bt & 16u) && jz_ok) ? 1.0f : 0.0f;
        rnew = r1[i] + m * (upd - r1[i]);
      }
      if (black_ok && (bt & 2u)) {  // black on plane k - 2
        const int q = (xb ^ (int)(bt >> 5)) & 1;
        const float p0 = rn3[i] + rnew;
        const float p1 = rn2[i] + SR[q ? c - kLZ : c + kLZ];
        const float p2 = SR[c - 1] + SR[c + 1];
        const float upd = split_update(p0, p1, p2, g2[i], w0, w1, w2,
                                       inv_den);
        const bool jz_ok = (bt & 8u) || q == 0;
        const float m = (xb >= 1 && (bt & 16u) && jz_ok) ? 1.0f : 0.0f;
        const float bnew = bq0[i] + m * (upd - bq0[i]);
        if (bt & 4u) {
          bo[po + goff[i]] = bnew;
          ro[po + goff[i]] = rn2[i];
        }
      }
      if (tid + i * kThreads < kNPL) {
        sb[k & 1][c] = bq2[i];
        sr[(k - 1) & 1][c] = rnew;
      }
      bq0[i] = bq1[i];
      bq1[i] = bq2[i];
      bq2[i] = bin[i];
      rn3[i] = rn2[i];
      rn2[i] = rnew;
      r1[i] = rin[i];
      f1[i] = fin[i];
      g2[i] = gin[i];
    }
    __syncthreads();
  }
}

template <int T>
int launch(const float* r, const float* b, const float* fr, const float* fb,
           float* ro, float* bo, const Blocked3DLayout& L, float w0,
           float w1, float w2, float inv_den, cudaStream_t stream) {
  static bool opted_in = false;  // once per process, outside any capture
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        blocked3d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<T>());
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  blocked3d_kernel<T><<<dim3(L.tz, L.tj, L.bands), kThreads,
                        smem_bytes<T>(), stream>>>(r, b, fr, fb, ro, bo, L,
                                                   w0, w1, w2, inv_den);
  return (int)cudaGetLastError();
}

template <int T>
bool tile_ok(const Blocked3DLayout& L) {
  return L.BJ == TileOf<T>::BJ && L.BZ == TileOf<T>::BZ &&
         (size_t)L.smem_bytes == smem_bytes<T>();
}

}  // namespace

extern "C" {

// One launch of L->T sweeps on the (X, Y2, Z) halves r, b with RHS halves
// fr, fb -> ro, bo, in the layout *L (ops/cuda/blocked3d.layout).
int pdemg_blocked3d(const float* r, const float* b, const float* fr,
                    const float* fb, float* ro, float* bo,
                    const Blocked3DLayout* L, float w0, float w1, float w2,
                    float inv_den, void* stream) {
  const Blocked3DLayout& l = *L;
  const bool tile = (l.T == 1 && l.BJ == kBJ && l.BZ == kBZ &&
                     (size_t)l.smem_bytes == kStreamSmem) ||
                    (l.T == 2 && tile_ok<2>(l)) ||
                    (l.T == 3 && tile_ok<3>(l)) || (l.T == 4 && tile_ok<4>(l));
  if (!tile || l.X < 1 || l.Y2 < 1 || l.Z < 1 || l.B < 1 ||
      l.threads != kThreads || l.tj != (l.Y2 + l.BJ - 1) / l.BJ ||
      l.tz != (l.Z + l.BZ - 1) / l.BZ || (l.bands - 1) * l.B >= l.X ||
      l.bands * l.B < l.X) {
    return (int)cudaErrorInvalidValue;
  }
  if (l.tj > 65535 || l.bands > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (l.T) {
    case 1:
      blocked3d_stream_kernel<<<dim3(l.tz, l.tj, l.bands), kThreads, 0,
                                st>>>(r, b, fr, fb, ro, bo, l, w0, w1, w2,
                                      inv_den);
      return (int)cudaGetLastError();
    case 2: return launch<2>(r, b, fr, fb, ro, bo, l, w0, w1, w2, inv_den, st);
    case 3: return launch<3>(r, b, fr, fb, ro, bo, l, w0, w1, w2, inv_den, st);
    default:
      return launch<4>(r, b, fr, fb, ro, bo, l, w0, w1, w2, inv_den, st);
  }
}

}  // extern "C"
