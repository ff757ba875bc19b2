// The 2D Poisson local solve, shared by the 2D Poisson relax kernels
// (sm_90a): the dense leg (resident.cu), the tiled slab (slab2d.cu) and the
// colour slab's chunk (color_slab2d_shard.cu).
//
// Poisson.kernel_update / split_update2d (models/poisson.py) at one point,
// in their order: num = -f, then num + (v[x - 1] + v[x + 1]) * w0, then
// num + (v[y - 1] + v[y + 1]) * w1, then num * inv_den.  The constants are
// float32, each rounded once on the host from the doubles of
// `split_constants`, as the JAX package's float32 constants round.  The
// interior test comes from the point's global index: no mask and no
// coefficient array is stored or read.  Built with --fmad=false: every
// product and sum rounds on its own, so the kernels agree with the plain
// PyTorch versions bit for bit.

#pragma once

#include <cuda_runtime.h>

// Host-side constants (the wrappers fill them in).
struct Poisson2D {
  float w0, w1;    // float32(1 / hx^2), float32(1 / hy^2)
  float inv_den;   // float32(1 / (2 (1 / hx^2 + 1 / hy^2)))
  int nx, ny;      // logical extents: the interior is 1 .. n - 2
};

namespace {

// The update from the point's neighbours w = v[x - 1], e = v[x + 1],
// s = v[y - 1], n = v[y + 1] and its RHS f, in kernel_update's order.
// A leg without f passes f = 0: -0 + a is a for every a, so the result is
// the f-less form's, bit for bit.
__device__ __forceinline__ float poisson_update(float w, float e, float s,
                                                float n, float f,
                                                const Poisson2D& p) {
  float num = -f;
  num = num + (w + e) * p.w0;
  num = num + (s + n) * p.w1;
  return num * p.inv_den;
}

__device__ __forceinline__ bool poisson_interior(int x, int y,
                                                 const Poisson2D& p) {
  return x >= 1 && x <= p.nx - 2 && y >= 1 && y <= p.ny - 2;
}

// The stencil of the dense kernels (resident.cu's leg, slab2d.cu's tiles;
// hjb2d.cuh's HJBOp is the other): no column coefficients, the interior
// test from the global index, the update.
struct PoissonOp {
  using Params = Poisson2D;
  __device__ __forceinline__ void column(const Poisson2D&, int) {}
  __device__ __forceinline__ bool keep(const Poisson2D& p, int x, int y,
                                       long long) const {
    return poisson_interior(x, y, p);
  }
  __device__ __forceinline__ float update(const Poisson2D& p, float e,
                                          float w, float n, float s,
                                          float f) const {
    return poisson_update(w, e, s, n, f, p);
  }
};

}  // namespace
