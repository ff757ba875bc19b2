// Reduced-system (black-only) red-black Gauss-Seidel on padded 2D Lyapunov
// levels (sm_90a): one chunk of T red+black sweeps per launch, halves in,
// halves out.
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_reduced_slab_2d
//
// Layout: the halves of csrc/relax2d.cu, (X, Y2) each, Y2 = ceil(Y/2); with
// q = x % 2, red at y = 2j + q, black at y = 2j + 1 - q.  Lyapunov's stencil
// is one-sided (a red point reads B[x+1, j] and B[x, j+q], a black one
// R[x+1, j] and R[x, j+1-q]), so red-black Gauss-Seidel is bipartite: one
// whole red+black sweep is the black-only update
//
//   b <- Cxx B[x+2, j] + Cxy B[x+1, j+1-q] + Cyy B[x, j+1] + Cf
//
// with sweep-invariant fields built once per launch from the coefficients
// of lyapunov2d.cuh at the black point, its red east neighbour (x+1, y)
// and its red south neighbour (x, y+1), the red interior masks folded in,
// the masked (Dirichlet) red values and the RHS terms folded into Cf
// (relax.py:3296-3331).  Masked blacks are held by the mask fold
// m_b*upd + (1 - m_b)*b0.  Red is rebuilt once, at the end, from the black
// state one sweep before the last (b_prev): after T sweeps Gauss-Seidel
// leaves r_T = R(b_{T-1}) (relax.py:3341-3358).  Every product and sum is
// the Pallas kernel's, in its order; with --fmad=false the kernel equals
// its plain version (ops/cuda/reduced2d.reduced_slab2d_plain) bit for bit.
// Reads past row X or slot Y2 take 0, what JAX's zero padding holds there:
// only masked points and terms with a zero coefficient read them.
//
// Design: a CTA of TY warps (a warp a row phase, its lanes 32 slot
// phases) owns a BX x BJ tile of black points and loads it with its
// one-sided halo (2T rows on +x, T slots on +j: a sweep reads x+2, x+1 and
// j+1) as an LX x 64 region, LX = TY IX, so that each thread holds the
// same IX x 2 points of it for the whole chunk: their five fields (Cxx,
// Cxy, Cyy, Cf, (1 - m_b) b0) and m_b live in registers, and a sweep reads
// three black values from shared memory and writes one.  The inputs come
// in by cp.async (zero-filled past X and Y2) while the threads compute the
// red coefficients of the region (its rows and one more) into shared
// memory; each point's black coefficient is computed in registers, so a
// point costs two coefficient evaluations (one IEEE division each), with
// the terms a00 x, a10 x of its row and a01 y, a11 y of its column
// computed once a tile.  Sweep s (from 0) runs on the rows and slots the
// later sweeps read (rows < LX - 2(s+1), slots < 64 - (s+1): a warp's row
// is in or out as a whole), between two black buffers in turn, one
// barrier a sweep; the last runs on the owned points and rebuilds their
// red from b_prev.  The output halves are apart from the inputs: tiles
// read rows that other tiles own.  Forms (TY, IX), each the fastest on
// the 4097^2 plan's levels of its T on an H100 (reduced2d.form): (16, 3),
// 48 rows and two CTAs an SM, up to T = 4; (32, 3), 96 rows, up to T = 8;
// (32, 2), 64 rows, above.
//
// What bounds it: per point and chunk it reads r, b (and fr, fb) once and
// writes r and b: 16 B f-less, 24 B with f (0.040 ms f-less at 4097^2 at
// 3.35 TB/s), the halo ((LX x 64) / (BX x BJ) = 1.37 at T = 8) through the
// L2; per point and sweep 8 float operations from registers and 3
// shared-memory loads, over 1.16 times the owned points at T = 8 (the
// shrinking regions); per loaded point two coefficient evaluations and the
// fields: issue, not bytes, at 5x the byte bound.

#include <cuda_runtime.h>

#include "lyapunov2d.cuh"  // Lyap2D, Coef, axis_coord

// The launch: the level's halves (X, Y2), the chunk's T, a thread's rows
// of points IX (the region's rows LX = IX threads / 32), the owned tile
// BX x BJ (LX - 2T rows, 64 - T slots), the tiles along the slots and the
// rows, the threads (32 TY) and shared memory (ops/cuda/reduced2d.layout).
struct Reduced2DLayout {
  int X, Y2;
  int T;
  int IX, BX, BJ;
  int tj, tx;
  int threads, smem_bytes;
};

namespace {

constexpr int kMaxT = 16;
constexpr int kLJ = 64;       // the region's slots: two of a thread's
constexpr int kSJ = kLJ + 1;  // with the slot past it (r, fr, coefficients)

// floats of shared memory: r and fr on (LX + 1) x kSJ, fb and the two
// black buffers on LX x kLJ, the red coefficients (ae, as, af) on
// (LX + 1) x kSJ, the row terms a00 x, a10 x of LX + 1 rows and the column
// terms a01 y, a11 y of 2 kSJ + 2 columns
__host__ __device__ constexpr int smem_floats(int LX) {
  return 5 * (LX + 1) * kSJ + 3 * LX * kLJ + 2 * (LX + 1) +
         2 * (2 * kSJ + 2);
}

__device__ __forceinline__ float mask(bool ok) { return ok ? 1.0f : 0.0f; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  // 4 bytes global -> shared, zero-filled where `in` is false
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// lyap_coef (lyapunov2d.cuh) with its x terms a00 x, a10 x (ax0, ax1) and
// y terms a01 y, a11 y (ay0, ay1) given: the same operations, in order
__device__ __forceinline__ Coef coef_of(float ax0, float ax1, float ay0,
                                        float ay1, const Lyap2D& p) {
  const float k1 = ax0 + ay0;
  const float k2 = ax1 + ay1;
  float den = k1 * p.h1 + k2 * p.h0;
  den = den - p.ahh;
  const float inv = 1.0f / den;
  Coef c;
  c.ae = (p.h1 * k1) * inv;
  c.as = (p.h0 * k2) * inv;
  c.af = p.nhh * inv;
  return c;
}

// TY warps, a warp a row phase: thread (ty, tx) holds the points
// (ty + TY i, tx + 32 k), i < IX, k < 2, of the LX = TY IX rows
template <int TY, int IX, bool WITH_F>
__global__ void __launch_bounds__(32 * TY, TY == 16 && IX == 3 ? 2 : 1)
    reduced2d_kernel(const float* __restrict__ r, const float* __restrict__ b,
                     const float* __restrict__ fr,
                     const float* __restrict__ fb, float* __restrict__ ro,
                     float* __restrict__ bo, const Reduced2DLayout L,
                     const Lyap2D p) {
  constexpr int LX = TY * IX;
  constexpr int NR = (LX + 1) * kSJ;  // r, fr and each coefficient
  constexpr int NB = LX * kLJ;        // fb and each black buffer
  constexpr int NY = 2 * kSJ + 2;     // the columns y = 2 j0 ...
  extern __shared__ float sm[];
  float* const sr = sm;
  float* const sfr = sr + NR;
  float* const sfb = sfr + NR;
  float* const b0 = sfb + NB;
  float* const b1 = b0 + NB;
  float* const rc = b1 + NB;  // [ae, as, af][(LX + 1) x kSJ]
  float* const xt = rc + 3 * NR;  // [a00 x, a10 x][LX + 1]
  float* const yt = xt + 2 * (LX + 1);  // [a01 y, a11 y][NY]
  const int T = L.T, X = L.X, Y2 = L.Y2, BX = L.BX, BJ = L.BJ;
  const int x0 = blockIdx.y * BX;
  const int j0 = blockIdx.x * BJ;
  const int tid = threadIdx.x;
  const int ty = tid >> 5, tx = tid & 31;

  // the inputs on the region, zero past X and Y2: rows ty + TY i (row LX
  // at i = IX, ty = 0), slots tx + 32 k (slot 64 at k = 2, tx = 0)
#pragma unroll
  for (int i = 0; i <= IX; ++i) {
    const int lx = ty + TY * i;
    if (lx > LX) continue;
    const int x = x0 + lx;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int lj = tx + 32 * k;
      if (lj > kLJ) continue;
      const int j = j0 + lj;
      const bool in = x < X && j < Y2;
      const long long g = in ? (long long)x * Y2 + j : 0;
      const int e = lx * kSJ + lj;
      cp_async4(sr + e, r + g, in);
      if (WITH_F) cp_async4(sfr + e, fr + g, in);
      if (lx < LX && lj < kLJ) {
        const int c = lx * kLJ + lj;
        cp_async4(b0 + c, b + g, in);
        if (WITH_F) cp_async4(sfb + c, fb + g, in);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // the coordinate terms, then the region's red coefficients, while the
  // copies are in flight
  for (int i = tid; i < LX + 1 + NY; i += 32 * TY) {
    if (i <= LX) {
      const float xf = axis_coord(x0 + i, p.o0, p.h0, p.lo0, p.hi0);
      xt[i] = p.a00 * xf;
      xt[LX + 1 + i] = p.a10 * xf;
    } else {
      const int k = i - LX - 1;
      const float yf = axis_coord(2 * j0 + k, p.o1, p.h1, p.lo1, p.hi1);
      yt[k] = p.a01 * yf;
      yt[NY + k] = p.a11 * yf;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i <= IX; ++i) {
    const int lx = ty + TY * i;
    if (lx > LX) continue;
    const int q = (x0 + lx) & 1;
    const float ax0 = xt[lx], ax1 = xt[LX + 1 + lx];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int lj = tx + 32 * k;
      if (lj > kLJ) continue;
      const int ky = 2 * lj + q;  // red (x, 2j + q)
      const Coef c = coef_of(ax0, ax1, yt[ky], yt[NY + ky], p);
      const int e = lx * kSJ + lj;
      rc[e] = c.ae;
      rc[NR + e] = c.as;
      rc[2 * NR + e] = c.af;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // this thread's points: their fields (relax.py:3266-3331) in registers
  float cxx[IX][2], cxy[IX][2], cyy[IX][2], cf[IX][2], cbk[IX][2];
  unsigned mbits = 0;
#pragma unroll
  for (int i = 0; i < IX; ++i) {
    const int lx = ty + TY * i;
    const int x = x0 + lx;
    const int q = x & 1;
    const bool okx = x >= 1 && x <= p.nx - 2;
    const float ax0 = xt[lx], ax1 = xt[LX + 1 + lx];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int lj = tx + 32 * k;
      const int j = j0 + lj;
      cxx[i][k] = cxy[i][k] = cyy[i][k] = cf[i][k] = cbk[i][k] = 0.0f;
      if (x >= X || j >= Y2) continue;  // past the level: 0, stays 0
      const int yb = 2 * j + 1 - q;
      const bool oky_b = yb >= 1 && yb <= p.ny - 2;
      const float m_b = mask(okx && oky_b);
      const float m_rE = mask(x + 1 >= 1 && x + 1 <= p.nx - 2 && oky_b);
      const float m_rS = mask(okx && yb + 1 >= 1 && yb + 1 <= p.ny - 2);
      const int ky = 2 * lj + 1 - q;
      const Coef cb = coef_of(ax0, ax1, yt[ky], yt[NY + ky], p);
      const int e = (lx + 1) * kSJ + lj;       // red (x+1, y): slot j
      const int s = lx * kSJ + (q ? lj : lj + 1);  // red (x, y+1)
      const Coef cE = {rc[e], rc[NR + e], rc[2 * NR + e]};
      const Coef cS = {rc[s], rc[NR + s], rc[2 * NR + s]};
      const float aeE = cb.ae * m_rE;
      const float asS = cb.as * m_rS;
      cxx[i][k] = aeE * cE.ae;
      cxy[i][k] = aeE * cE.as + asS * cS.ae;
      cyy[i][k] = asS * cS.as;
      // the masked red neighbours' values: R[x+1, j] and R[x, j+1-q]
      float c = (cb.ae * (1.0f - m_rE)) * sr[e];
      c = c + (cb.as * (1.0f - m_rS)) * sr[s];
      if (WITH_F) {
        float w = (aeE * cE.af) * sfr[e];
        w = w + (asS * cS.af) * sfr[s];
        w = w + cb.af * sfb[lx * kLJ + lj];
        c = c + w;
      }
      cf[i][k] = c;
      mbits |= (m_b != 0.0f ? 1u : 0u) << (2 * i + k);
      cbk[i][k] = (1.0f - m_b) * b0[lx * kLJ + lj];
    }
  }

  // the sweeps before the last, each on the rows and slots later ones read
  float* cur = b0;
  float* nxt = b1;
  for (int s = 0; s + 1 < T; ++s) {
    const int RX = LX - 2 * (s + 1);
    const int RJ = kLJ - (s + 1);
#pragma unroll
    for (int i = 0; i < IX; ++i) {
      const int lx = ty + TY * i;
      if (lx >= RX) continue;  // the warp's row
      const int q = (x0 + lx) & 1;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int lj = tx + 32 * k;
        if (lj >= RJ) continue;
        const int c = lx * kLJ + lj;
        const float bxy = q ? cur[c + kLJ] : cur[c + kLJ + 1];
        float u = cxx[i][k] * cur[c + 2 * kLJ];
        u = u + cxy[i][k] * bxy;
        u = u + cyy[i][k] * cur[c + 1];
        u = u + cf[i][k];
        const float m_b = (mbits >> (2 * i + k)) & 1u ? 1.0f : 0.0f;
        nxt[c] = m_b * u + cbk[i][k];
      }
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
    __syncthreads();
  }

  // the last sweep on the owned points, from cur = b_prev, and their red
  // rebuilt from b_prev (relax.py:3341-3358)
#pragma unroll
  for (int i = 0; i < IX; ++i) {
    const int lx = ty + TY * i;
    const int x = x0 + lx;
    if (lx >= BX || x >= X) continue;
    const int q = x & 1;
    const bool okx = x >= 1 && x <= p.nx - 2;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int lj = tx + 32 * k;
      const int j = j0 + lj;
      if (lj >= BJ || j >= Y2) continue;
      const int c = lx * kLJ + lj;
      const float bxy = q ? cur[c + kLJ] : cur[c + kLJ + 1];
      float u = cxx[i][k] * cur[c + 2 * kLJ];
      u = u + cxy[i][k] * bxy;
      u = u + cyy[i][k] * cur[c + 1];
      u = u + cf[i][k];
      const float m_b = (mbits >> (2 * i + k)) & 1u ? 1.0f : 0.0f;
      const long long g = (long long)x * Y2 + j;
      bo[g] = m_b * u + cbk[i][k];
      const int yr = 2 * j + q;
      const float m_r = mask(okx && yr >= 1 && yr <= p.ny - 2);
      const int e = lx * kSJ + lj;  // red (x, 2j + q)
      // east (x+1, y): B[x+1, j]; south (x, y+1): B[x, j+q]
      float ru = rc[e] * cur[c + kLJ];
      ru = ru + rc[NR + e] * (q ? cur[c + 1] : cur[c]);
      if (WITH_F) ru = ru + rc[2 * NR + e] * sfr[e];
      ro[g] = m_r * ru + (1.0f - m_r) * sr[e];
    }
  }
}

template <int TY, int IX, bool WITH_F>
int launch(const float* r, const float* b, const float* fr, const float* fb,
           float* ro, float* bo, const Reduced2DLayout& L, const Lyap2D& p,
           cudaStream_t stream) {
  static bool opted_in = false;  // once per process, outside any capture
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        reduced2d_kernel<TY, IX, WITH_F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * smem_floats(TY * IX)));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  reduced2d_kernel<TY, IX, WITH_F>
      <<<dim3(L.tj, L.tx, 1), 32 * TY, L.smem_bytes, stream>>>(
          r, b, fr, fb, ro, bo, L, p);
  return (int)cudaGetLastError();
}

template <bool WITH_F>
int launch_form(const float* r, const float* b, const float* fr,
                const float* fb, float* ro, float* bo,
                const Reduced2DLayout& L, const Lyap2D& p, cudaStream_t st) {
  const int TY = L.threads / 32;
  if (TY == 16 && L.IX == 3) {
    return launch<16, 3, WITH_F>(r, b, fr, fb, ro, bo, L, p, st);
  }
  if (TY == 32 && L.IX == 2) {
    return launch<32, 2, WITH_F>(r, b, fr, fb, ro, bo, L, p, st);
  }
  return launch<32, 3, WITH_F>(r, b, fr, fb, ro, bo, L, p, st);
}

}  // namespace

extern "C" {

// One chunk of L->T sweeps: halves r, b (RHS halves fr, fb, or both null:
// the f-less kernel) of an (X, Y2) level -> ro, bo, apart from the inputs,
// in the layout *L (ops/cuda/reduced2d.layout).
int pdemg_reduced2d(const float* r, const float* b, const float* fr,
                    const float* fb, float* ro, float* bo,
                    const Reduced2DLayout* L, const Lyap2D* p, void* stream) {
  const Reduced2DLayout& l = *L;
  const int TY = l.threads / 32;
  const bool form = (TY == 16 && l.IX == 3) ||
                    (TY == 32 && (l.IX == 2 || l.IX == 3));
  const int LX = TY * l.IX;
  if (l.T < 1 || l.T > kMaxT || l.X < 1 || l.Y2 < 1 || !form ||
      l.threads != 32 * TY || l.BX != LX - 2 * l.T || l.BX < 1 ||
      l.BJ != kLJ - l.T || l.tj != (l.Y2 + l.BJ - 1) / l.BJ ||
      l.tx != (l.X + l.BX - 1) / l.BX ||
      (size_t)l.smem_bytes != sizeof(float) * smem_floats(LX) ||
      (fr == nullptr) != (fb == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (l.tx > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  return fr ? launch_form<true>(r, b, fr, fb, ro, bo, l, *p, st)
            : launch_form<false>(r, b, nullptr, nullptr, ro, bo, l, *p, st);
}

}  // extern "C"
