// The HJB upwind local solve, shared by the 2D HJB relax kernels (sm_90a):
// HJBMinTime.kernel_update (models/hjb.py, scheme "upwind") at one point,
// and `HJBOp`, the stencil the dense kernels (resident.cu, slab2d.cu) are
// templated on.
//
// The coefficient fields of HJBMinTime.kernel_precompute depend on x2, the
// column coordinate, alone, so the kernels read them as four vectors of Y
// floats, cut from the very tensors the plain PyTorch version reads.  The
// points a sweep may write (the interior without the pinned target ball,
// kernel_keep_mask) come as one byte per point, from the plain version's
// masks.  Built with --fmad=false: every product and sum rounds on its own,
// in the plain version's order, so the kernels agree with it bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// What the HJB kernels read besides v and f (the wrapper fills it in).
struct HJB2D {
  const uint8_t* mask;  // (X, Y): 1 where a sweep updates the point
  const float* c1;      // (Y,) |x2| / h1
  const float* s1;      // (Y,) 1 where x2 > 0 (upwind side east), else 0
  const float* inv_in;  // (Y,) 1 / (1 + c1)
  const float* inv_act;  // (Y,) 1 / (1 + c1 + c2)
  float c2;             // float32(1 / h2), rounded once from double
};

namespace {

// The upwind update from the point's neighbours: e = v[x + 1], w = v[x - 1],
// n = v[y + 1], s = v[y - 1]; in kernel_update's operation order.
__device__ __forceinline__ float hjb_update(float e, float w, float n, float s,
                                            float f, float c1, float s1,
                                            float inv_in, float inv_act,
                                            float c2) {
  const float nb1 = s1 * e + (1.0f - s1) * w;
  const float m2 = fminf(n, s);
  const float base = f + c1 * nb1;
  const float w_in = base * inv_in;
  const float w_act = (base + c2 * m2) * inv_act;
  return w_in <= m2 ? w_in : w_act;
}

// The stencil of the dense HJB kernels (resident.cu's leg, slab2d.cu's
// tiles): a thread's column coefficients, the update mask byte of a point,
// and the update.
struct HJBOp {
  using Params = HJB2D;
  float c1, s1, inv_in, inv_act;
  // load the coefficients of column y
  __device__ __forceinline__ void column(const HJB2D& p, int y) {
    c1 = p.c1[y];
    s1 = p.s1[y];
    inv_in = p.inv_in[y];
    inv_act = p.inv_act[y];
  }
  // whether a sweep updates point (x, y), at offset gi of the level
  __device__ __forceinline__ bool keep(const HJB2D& p, int x, int y,
                                       long long gi) const {
    return p.mask[gi] != 0;
  }
  __device__ __forceinline__ float update(const HJB2D& p, float e, float w,
                                          float n, float s, float f) const {
    return hjb_update(e, w, n, s, f, c1, s1, inv_in, inv_act, p.c2);
  }
};

}  // namespace
