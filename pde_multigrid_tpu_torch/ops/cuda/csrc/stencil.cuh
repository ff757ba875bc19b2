// Helpers shared by the 3D wrap-storage kernels (sm_90a): wrapped
// neighbour indices, dense offsets, the color-split update and the
// residual at one point, and the row launch shape.
//
// Wrap storage: indices wrap modulo the extent; plane 0 of each axis is
// the zero boundary that both ends share.  Built with --fmad=false; the
// residual keeps the operation order of Poisson.kernel_operator, so it
// agrees bit for bit with the plain PyTorch versions.

#pragma once

#include <cuda_runtime.h>

namespace {

// Row launch over an (X, R, Z) array: threads along z (coalesced),
// blockIdx.y = the row r, blockIdx.z = x, so a thread finds its point
// without integer division (64-bit division and modulo by runtime
// extents cost more issue slots than the loads of a 7-point update).
constexpr int kRowThreads = 128;

inline dim3 row_block(int Z) {
  return dim3(Z >= kRowThreads ? kRowThreads : ((Z + 31) / 32) * 32);
}
inline dim3 row_grid(int X, int R, int Z) {
  return dim3((Z + kRowThreads - 1) / kRowThreads, R, X);
}
// gridDim.y and gridDim.z are at most 65535
inline bool row_launch_ok(int X, int R) { return X <= 65535 && R <= 65535; }

__device__ __forceinline__ int wrap_dec(int i, int n) {
  return i == 0 ? n - 1 : i - 1;
}
__device__ __forceinline__ int wrap_inc(int i, int n) {
  return i == n - 1 ? 0 : i + 1;
}
__device__ __forceinline__ long long at(int x, int y, int z, int Y, int Z) {
  return ((long long)x * Y + y) * Z + z;
}

// Poisson.split_update on the neighbour pair sums (x, y, z) of a point
// and its RHS f, in the plain version's order: num = -f; num += pair_ax *
// w_ax; upd = num * inv_den.
__device__ __forceinline__ float split_update(float p0, float p1, float p2,
                                              float f, float w0, float w1,
                                              float w2, float inv_den) {
  float num = -f;
  num = num + p0 * w0;
  num = num + p1 * w1;
  num = num + p2 * w2;
  return num * inv_den;
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

// m_int * (f - L v) at one dense point; L v in Poisson.kernel_operator's
// order: sum over axes of ((v[-1] - 2 v) + v[+1]) * w_ax, x first.
// WITH_F false: m_int * (0 - L v), f not read.
template <bool WITH_F = true>
__device__ __forceinline__ float residual_at(const float* __restrict__ v,
                                             const float* __restrict__ f,
                                             int x, int y, int z, int X,
                                             int Y, int Z, float w0,
                                             float w1, float w2) {
  const float c = v[at(x, y, z, Y, Z)];
  const float c2 = 2.0f * c;
  float t0 = v[at(wrap_dec(x, X), y, z, Y, Z)] - c2;
  t0 = t0 + v[at(wrap_inc(x, X), y, z, Y, Z)];
  float lv = t0 * w0;
  float t1 = v[at(x, wrap_dec(y, Y), z, Y, Z)] - c2;
  t1 = t1 + v[at(x, wrap_inc(y, Y), z, Y, Z)];
  lv = lv + t1 * w1;
  float t2 = v[at(x, y, wrap_dec(z, Z), Y, Z)] - c2;
  t2 = t2 + v[at(x, y, wrap_inc(z, Z), Y, Z)];
  lv = lv + t2 * w2;
  const float m = (x >= 1 && y >= 1 && z >= 1) ? 1.0f : 0.0f;
  return m * ((WITH_F ? f[at(x, y, z, Y, Z)] : 0.0f) - lv);
}

}  // namespace
