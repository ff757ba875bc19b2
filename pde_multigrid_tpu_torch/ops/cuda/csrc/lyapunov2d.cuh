// The 2D Lyapunov local solve, shared by the 2D relax kernels (sm_90a):
// the coefficient fields of Lyapunov2D.kernel_precompute computed from a
// point's own coordinates, and the interior test.  The kernels evaluate
// the update of Lyapunov2D.kernel_update / split_update2d in its order:
// east a_e + south a_s, then + f a_f (f a_f rounded once).
//
// Built with --fmad=false: every product and sum rounds on its own, in the
// order of the plain PyTorch versions (models/lyapunov2d.py), so the kernels
// agree with them bit for bit.  No coefficient array is stored or read.

#pragma once

#include <cuda_runtime.h>

// Host-side constants, each rounded once from double to float32 as the
// JAX package's float32 constants round (the wrapper fills them in).
struct Lyap2D {
  float o0, h0, lo0, hi0;  // axis 0: origin, spacing, domain clamp
  float o1, h1, lo1, hi1;  // axis 1
  float a00, a01, a10, a11;  // the system matrix A, cast to float32
  float ahh;  // float32(alpha * hx * hy)
  float nhh;  // float32(-hx * hy)
  int nx, ny;  // logical extents: the interior is 1 .. n - 2
};

struct Coef {
  float ae, as, af;  // east, south and rhs coefficients
};

namespace {

// origin + i * h, clamped to the domain (LevelGeometry.coords1d)
__device__ __forceinline__ float axis_coord(int i, float o, float h,
                                            float lo, float hi) {
  const float x = o + (float)i * h;
  return fminf(fmaxf(x, lo), hi);
}

// Lyapunov2D.kernel_precompute at one point, in its operation order
__device__ __forceinline__ Coef lyap_coef(int x, int y, const Lyap2D& p) {
  const float xf = axis_coord(x, p.o0, p.h0, p.lo0, p.hi0);
  const float yf = axis_coord(y, p.o1, p.h1, p.lo1, p.hi1);
  const float k1 = p.a00 * xf + p.a01 * yf;
  const float k2 = p.a10 * xf + p.a11 * yf;
  float den = k1 * p.h1 + k2 * p.h0;  // k1 hy + k2 hx
  den = den - p.ahh;
  const float inv = 1.0f / den;
  Coef c;
  c.ae = (p.h1 * k1) * inv;
  c.as = (p.h0 * k2) * inv;
  c.af = p.nhh * inv;
  return c;
}

__device__ __forceinline__ bool interior(int x, int y, const Lyap2D& p) {
  return x >= 1 && x <= p.nx - 2 && y >= 1 && y <= p.ny - 2;
}

}  // namespace
