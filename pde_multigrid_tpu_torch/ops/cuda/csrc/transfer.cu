// Fused inter-grid transfers and the residual for 3D wrap-storage levels
// (sm_90a).
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/transfer.py:make_residual_restrict
//       cf = R(m_int * (f - L v)), or cf = R(a) with with_residual = 0
//   pde_multigrid_tpu/ops/pallas/transfer.py:make_prolong_blend
//       add:     out = vb + m_int * P(c)
//       replace: out = vb + m_int * (P(c) - vb)
//   pde_multigrid_tpu/ops/pallas/transfer.py:make_residual
//       r = m_int * (f - L v)
// where R is 27-point full weighting with injection on the coarse boundary
// planes and P is trilinear prolongation; fine (X, Y, Z) = 2 (Xc, Yc, Zc).
// On the sub-lane pairs (fine level of at most 32^3 on the 3D presets) the
// same kernels replace the TPU's small resident transfer kernels
//   pde_multigrid_tpu/ops/pallas/subtree.py:make_small_restrict
//       cf = R(a): the restrict-only mode (with_residual = 0)
//   pde_multigrid_tpu/ops/pallas/subtree.py:make_small_prolong_blend
//       both modes
// which compute the same functions: the TPU needed separate kernels for
// levels narrower than its 128-lane tile, Hopper has no such tile.  One
// thread per output point wraps every index modulo its extent, so the
// 2-point axes of the 4^3 -> 2^3 pair need nothing of their own.
//
// What bounds these kernels on the card: device-memory traffic.  The
// residual moves 12 B per point (v, f in; r out).  Residual + restrict
// reads v and f once from memory (8 B per fine point) and writes 4 B per
// coarse point; prolong + blend reads the fine base and writes it (8 B
// per fine point) plus a coarse read served by the caches.
// The simple design: one thread per output point, coalesced along z.  A
// restrict thread recomputes the residual at each of its 27 fine points
// (7 loads each, mostly cache hits) instead of staging a residual tile in
// shared memory; a prolong thread gathers its up-to-8 coarse values.
// Making these tiled and staged is later work.
//
// Wrap storage: indices wrap modulo the extent; plane 0 of each axis is
// the zero boundary that both ends share.  Built with --fmad=false; every
// expression keeps the operation order of the plain PyTorch version
// (ops/cuda/transfer.py), which is the JAX package's jnp tier, so the two
// agree bit for bit.

#include <cuda_runtime.h>

#include "stencil.cuh"  // wrap_dec, wrap_inc, at, residual_at

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

__global__ void residual_kernel(const float* __restrict__ v,
                                const float* __restrict__ f,
                                float* __restrict__ r, int X, int Y, int Z,
                                float w0, float w1, float w2) {
  const long long n = (long long)X * Y * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % Z);
  const long long xy = i / Z;
  const int y = (int)(xy % Y);
  const int x = (int)(xy / Y);
  r[i] = residual_at(v, f, x, y, z, X, Y, Z, w0, w1, w2);
}

// The restricted field's value at one fine point.
__device__ __forceinline__ float source_at(const float* __restrict__ v,
                                           const float* __restrict__ f,
                                           int with_residual, int x, int y,
                                           int z, int X, int Y, int Z,
                                           float w0, float w1, float w2) {
  if (with_residual) return residual_at(v, f, x, y, z, X, Y, Z, w0, w1, w2);
  return v[at(x, y, z, Y, Z)];
}

// One coarse point: injection on the boundary planes, otherwise the
// separable [1/4, 1/2, 1/4] smoothing along x, then y, then z — the jnp
// tier smooths whole arrays axis by axis in that order and then
// subsamples, and at an interior coarse point no smoothing stencil wraps.
__global__ void residual_restrict_kernel(const float* __restrict__ v,
                                         const float* __restrict__ f,
                                         float* __restrict__ out,
                                         int with_residual, int Xc, int Yc,
                                         int Zc, float w0, float w1,
                                         float w2) {
  const long long n = (long long)Xc * Yc * Zc;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int X = 2 * Xc, Y = 2 * Yc, Z = 2 * Zc;
  const int K = (int)(i % Zc);
  const long long IJ = i / Zc;
  const int J = (int)(IJ % Yc);
  const int I = (int)(IJ / Yc);
  const int x = 2 * I, y = 2 * J, z = 2 * K;
  const float inj =
      source_at(v, f, with_residual, x, y, z, X, Y, Z, w0, w1, w2);
  float smoothed = inj;
  const bool interior = I >= 1 && J >= 1 && K >= 1;
  if (interior) {
    float sy[3];
    for (int dz = 0; dz < 3; ++dz) {
      float sx[3];
      for (int dy = 0; dy < 3; ++dy) {
        const int yy = y + dy - 1, zz = z + dz - 1;
        const float am =
            source_at(v, f, with_residual, x - 1, yy, zz, X, Y, Z, w0, w1, w2);
        const float a0 =
            source_at(v, f, with_residual, x, yy, zz, X, Y, Z, w0, w1, w2);
        const float ap =
            source_at(v, f, with_residual, x + 1, yy, zz, X, Y, Z, w0, w1, w2);
        float s = 0.25f * am + 0.5f * a0;
        sx[dy] = s + 0.25f * ap;
      }
      float s = 0.25f * sx[0] + 0.5f * sx[1];
      sy[dz] = s + 0.25f * sx[2];
    }
    float s = 0.25f * sy[0] + 0.5f * sy[1];
    smoothed = s + 0.25f * sy[2];
  }
  // out = inj + m_c * (smoothed - inj), m_c = 1 on the coarse interior
  const float mc = interior ? 1.0f : 0.0f;
  out[i] = inj + mc * (smoothed - inj);
}

// Linear upsample along one axis of the separable prolongation:
// odd fine index -> 0.5 * (a[i] + a[i+1 mod m]), even -> a[i].
__device__ __forceinline__ float lerp_pair(float a, float b, int odd) {
  return odd ? 0.5f * (a + b) : a;
}

__global__ void prolong_blend_kernel(const float* __restrict__ c,
                                     const float* vb, float* out, int X,
                                     int Y, int Z, int replace) {
  const long long n = (long long)X * Y * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int Xc = X / 2, Yc = Y / 2, Zc = Z / 2;
  const int z = (int)(i % Z);
  const long long xy = i / Z;
  const int y = (int)(xy % Y);
  const int x = (int)(xy / Y);
  const int ci = x >> 1, cj = y >> 1, ck = z >> 1;
  const int px = x & 1, py = y & 1, pz = z & 1;
  const int ci1 = wrap_inc(ci, Xc), cj1 = wrap_inc(cj, Yc),
            ck1 = wrap_inc(ck, Zc);
  // x first, then y, then z (the jnp tier's axis order)
  float ay[2];
  for (int dz = 0; dz < 2; ++dz) {
    const int kk = dz ? ck1 : ck;
    float ax[2];
    for (int dy = 0; dy < 2; ++dy) {
      const int jj = dy ? cj1 : cj;
      ax[dy] = lerp_pair(c[at(ci, jj, kk, Yc, Zc)], c[at(ci1, jj, kk, Yc, Zc)],
                         px);
    }
    ay[dz] = lerp_pair(ax[0], ax[1], py);
  }
  const float up = lerp_pair(ay[0], ay[1], pz);
  const float m = (x >= 1 && y >= 1 && z >= 1) ? 1.0f : 0.0f;
  const float base = vb[i];
  out[i] = replace ? base + m * (up - base) : base + m * up;
}

}  // namespace

extern "C" {

int pdemg_residual(const float* v, const float* f, float* r, int X, int Y,
                   int Z, float w0, float w1, float w2, void* stream) {
  const long long n = (long long)X * Y * Z;
  residual_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      v, f, r, X, Y, Z, w0, w1, w2);
  return (int)cudaGetLastError();
}

int pdemg_residual_restrict(const float* v, const float* f, float* out,
                            int with_residual, int Xc, int Yc, int Zc,
                            float w0, float w1, float w2, void* stream) {
  const long long n = (long long)Xc * Yc * Zc;
  residual_restrict_kernel<<<blocks_for(n), kThreads, 0,
                             (cudaStream_t)stream>>>(
      v, f, out, with_residual, Xc, Yc, Zc, w0, w1, w2);
  return (int)cudaGetLastError();
}

int pdemg_prolong_blend(const float* c, const float* vb, float* out, int X,
                        int Y, int Z, int replace, void* stream) {
  const long long n = (long long)X * Y * Z;
  prolong_blend_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      c, vb, out, X, Y, Z, replace);
  return (int)cudaGetLastError();
}

}  // extern "C"
