// The 3D Poisson masked update on padded levels, shared by the padded 3D
// relax kernels (sm_90a): the whole leg (padded3d.cu) and the half-sweep
// (slab3d.cu).
//
// The Pallas kernels' `_sweeps` (relax.py:129-137) at one point: upd =
// Poisson.kernel_update (models/poisson.py) in its order, num = -f, then
// num + (v[x - 1] + v[x + 1]) * w0, the same for y and z, then num *
// inv_den; then the blend c + m * (upd - c), m the colour's mask.  The
// neighbours wrap modulo the level's extents on every axis, as torch.roll
// does in the plain version (only boundary points read a wrapped value,
// and their m is 0).  The constants are float32, each rounded once on the
// host from the doubles of `split_constants`, as the JAX package's float32
// constants round.  The mask comes from the point's global index (the
// interior 1 .. n - 2 on every axis, red where x + y + z is even): no mask
// array is stored or read.  Built with --fmad=false: every product and sum
// rounds on its own, so the kernels agree with the plain PyTorch version
// bit for bit.

#pragma once

#include <cuda_runtime.h>

// Host-side constants (the wrappers fill them in).
struct Poisson3D {
  float w0, w1, w2;  // float32(1 / h_ax^2)
  float inv_den;     // float32(1 / (2 sum_ax 1 / h_ax^2))
  int nx, ny, nz;    // the level's extents: the interior is 1 .. n - 2
};

namespace {

// c + m (upd - c) from the point's value c, its six neighbours and its f.
// A leg without f passes f = 0: -0 + a is a for every a, so the result is
// the f-less form's (kernel_update(v, None)), bit for bit.
__device__ __forceinline__ float poisson3d_blend(float c, float xm, float xp,
                                                 float ym, float yp,
                                                 float zm, float zp, float f,
                                                 float m,
                                                 const Poisson3D& p) {
  float num = -f;
  num = num + (xm + xp) * p.w0;
  num = num + (ym + yp) * p.w1;
  num = num + (zm + zp) * p.w2;
  const float upd = num * p.inv_den;
  const float d = upd - c;
  return c + m * d;
}

// The mask of colour `colour` (0 red, 1 black) at (x, y, z): 1 on the
// interior points of that parity, else 0.
__device__ __forceinline__ float poisson3d_mask(int x, int y, int z,
                                                int colour,
                                                const Poisson3D& p) {
  const bool in = x >= 1 && x <= p.nx - 2 && y >= 1 && y <= p.ny - 2 &&
                  z >= 1 && z <= p.nz - 2;
  return in && ((x + y + z) & 1) == colour ? 1.0f : 0.0f;
}

}  // namespace
