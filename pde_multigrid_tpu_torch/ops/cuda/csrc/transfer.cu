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
//       r = m_int * (f - L v); and, f-less, r = m_int * (0 - L v), which
//       the FAS cycle's coarse right side takes as residual(v, 0)
// where R is 27-point full weighting with injection on the coarse boundary
// planes and P is trilinear prolongation; fine (X, Y, Z) = 2 (Xc, Yc, Zc).
// On the sub-lane pairs (fine level of at most 32^3 on the 3D presets and
// in FAS) the same kernels replace the TPU's small resident transfer
// kernels
//   pde_multigrid_tpu/ops/pallas/subtree.py:make_small_restrict
//       cf = R(a): the restrict-only mode (with_residual = 0)
//   pde_multigrid_tpu/ops/pallas/subtree.py:make_small_prolong_blend
//       both modes
// which compute the same functions: the TPU needed separate kernels for
// levels narrower than its 128-lane tile, Hopper has no such tile.
//
// What bounds them on the card: device-memory traffic.  Residual +
// restrict must read v and f once (8 B a fine point) and write 4 B a
// coarse point (restrict alone: 4 B a fine point in); prolong + blend
// reads the fine base and writes it (8 B a fine point) plus 0.5 B of
// coarse; the residual 12 B a point (f-less 8 B).
//
// The residual (residual_walk_kernel<WITH_F>, the form of every level
// with power-of-two extents, z of at least 4 and more than
// ops/cuda/transfer.RESIDUAL_POINT_MAX points; layout by
// ops/cuda/transfer.residual_layout): the walk below without the
// smoothing.  A CTA owns TJ fine rows (all of z) of a band of NX planes
// and walks the band along x.  Each v plane (the tile's rows with one
// halo row each side) comes into the same four-slot ring once, by
// 16-byte cp.async two planes ahead (stage_rows); a thread owns one row's
// z quad, keeps v's x - 1, x and x + 1 quads in registers and computes
// them with residual_quad, the walk's own code; it reads f one plane
// ahead and writes r as one 16-byte access a quad, r by a streaming
// store.  So v is read from device memory (TJ + 2) / TJ times (the halo
// rows mostly from the L2), f and r once.  The f-less mode is the same
// walk at compile time with no f read: 0 - L v in the same order, bit
// for bit residual(v, 0).  Elsewhere (an extent that is not a power of
// two, z under 4, and the small levels, where a launch is its latency)
// residual_point_kernel, a point a thread on a grid of (z, y, x), no
// integer division.
//
// Residual + restrict (restrict_walk_kernel<RES>, the form of every level
// with power-of-two extents and a tile that fits, layout by
// ops/cuda/transfer.restrict_layout): a CTA owns TJ coarse rows (all of
// z) of a band of NI coarse planes and walks the band along x.  Each fine
// plane of v (the tile's 2 TJ + 1 rows with one more row each side) and
// of f comes into a ring of four shared-memory slots once, by 16-byte
// cp.async with wrapped row and plane indices, two planes ahead of the
// plane being computed.  A thread owns one fine row's z quad: it keeps
// v's x - 1 and x planes in registers, reads x + 1 and the y neighbours as
// 16-byte shared loads and the z neighbours from its lanes (shared memory
// at a row's or a warp's edge), and computes the residual of its 4 points
// once, as residual_at does.  Its last three residuals stay in registers;
// at each odd x = 2I + 1 it writes the x-smoothed plane 2I and the
// injected values, and the CTA then smooths along y and z at the even
// points, one coarse point a thread, in the plain order (x, then y, then
// z; each step (0.25 a- + 0.5 a0) + 0.25 a+), and writes
// inj + m_c (smoothed - inj).  Restrict alone is the same walk at compile
// time with a = v and no f.  Indices are 32-bit shifts and masks.  So v
// and f are read from device memory once a band (its two extra planes and
// the tile's two halo rows through the L2), and each fine residual is
// computed once.  The earlier one-thread-a-coarse-point form
// (residual_restrict_kernel: 216 loads a thread, each fine residual
// computed 3.4 times over) stays for the levels the walk does not take:
// an extent that is not a power of two, or a row too wide for one CTA.
// Tiles of 2, 4 and 8 coarse rows at 512^3, 256^3 and 128^3 (640, 576
// and 544 threads), bands so the tiles make 128 CTAs, about one an SM:
// on an H100 one wave of long walks beat more, shorter ones, which read
// a band's two extra planes again (scripts/probe_transfer.py).  On the
// sub-lane pairs (32^3 ... 4^3) and 64^3 the walk too, tiles of up to 4
// rows and a band a coarse plane: there a launch is mostly its latency,
// and the walk still took 1.3-2.6 times less than the point form.
//
// Prolong + blend (prolong_cell_kernel): a thread owns one coarse cell
// (i, j, k) and writes its 2 x 2 x 2 fine points.  It loads the cell's 8
// wrapped corners once and its 8 base values (as 4 float2, lanes along k,
// so a warp's row is 256 contiguous bytes) before any store, which keeps
// out == vb safe, and shares the x-interpolated corners between its
// points (the same operation on the same inputs, so exact).  Up to 128
// lanes along k a CTA, the rest of 256 threads along j, a CTA row a
// coarse plane; the same form on every level, the sub-lane pairs
// included, where a launch is its latency (about 1.5 us) in either form.
//
// Wrap storage: indices wrap modulo the extent; plane 0 of each axis is
// the zero boundary that both ends share.  Built with --fmad=false; every
// expression keeps the operation order of the plain PyTorch version
// (ops/cuda/transfer.py), which is the JAX package's jnp tier, so the two
// agree bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

#include "stencil.cuh"  // wrap_dec, wrap_inc, at, residual_at

// ops/cuda/transfer.py RestrictLayout
struct RestrictLayout {
  int Xc, Yc, Zc;     // the coarse level (the fine level is twice it)
  int with_residual;  // 1: R(m_int (f - L v)); 0: R(v)
  int form;           // 1: the plane walk; 0: a coarse point a thread
  int TJ;             // the walk: coarse rows a tile (all of z)
  int NI;             // the walk: coarse planes a band
  int RR;             // the walk: fine rows a residual plane, 2 TJ + 1
  int RV;             // the walk: fine rows a staged v plane (RR + 2, or RR)
  int threads;        // threads a CTA
  int grid_x;         // the walk: row tiles; the point form: CTAs
  int grid_y;         // the walk: bands; the point form: 1
  int smem_bytes;     // dynamic shared memory a CTA
};

// ops/cuda/transfer.py ProlongLayout
struct ProlongLayout {
  int Xc, Yc, Zc;  // the coarse level
  int bx, by;      // threads a CTA along k and along j
  int gx, gy, gz;  // CTAs along k, j and i
};

// ops/cuda/transfer.py ResidualLayout
struct ResidualLayout {
  int X, Y, Z;     // the level
  int with_f;      // 1: m (f - L v); 0: m (0 - L v), no f read
  int form;        // 1: the plane walk; 0: a point a thread
  int TJ;          // the walk: rows a tile (all of z)
  int NX;          // the walk: planes a band
  int RV;          // the walk: rows a staged v plane, TJ + 2
  int bx, by;      // threads a CTA (the point form: along z and along y)
  int gx, gy, gz;  // CTAs (the walk: row tiles, bands, 1; the point form:
                   // along z, y and x)
  int smem_bytes;  // dynamic shared memory a CTA
};

namespace {

constexpr int kThreads = 256;  // the cell form's CTA
constexpr int kStages = 4;     // the walks' ring of staged planes
constexpr int kMaxWalkThreads = 1024;

// The point form: a point a thread, threads along z and y, a CTA row of
// planes along x (blockIdx.z), so no integer division.
template <bool WITH_F>
__global__ void residual_point_kernel(const float* __restrict__ v,
                                      const float* __restrict__ f,
                                      float* __restrict__ r,
                                      const ResidualLayout L, float w0,
                                      float w1, float w2) {
  const int z = blockIdx.x * L.bx + threadIdx.x;
  const int y = blockIdx.y * L.by + threadIdx.y;
  const int x = blockIdx.z;
  const int X = L.X, Y = L.Y, Z = L.Z;
  if (z >= Z || y >= Y) return;
  r[at(x, y, z, Y, Z)] =
      residual_at<WITH_F>(v, f, x, y, z, X, Y, Z, w0, w1, w2);
}

// (0.25 a + 0.5 b) + 0.25 c: one axis of the full-weighting smoothing
__device__ __forceinline__ float smooth3(float a, float b, float c) {
  const float s = 0.25f * a + 0.5f * b;
  return s + 0.25f * c;
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

// The point form: one coarse point a thread, injection on the boundary
// planes, otherwise the separable smoothing along x, then y, then z of the
// 27 fine values around it (at an interior coarse point no smoothing
// stencil wraps).
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
        sx[dy] = smooth3(
            source_at(v, f, with_residual, x - 1, yy, zz, X, Y, Z, w0, w1,
                      w2),
            source_at(v, f, with_residual, x, yy, zz, X, Y, Z, w0, w1, w2),
            source_at(v, f, with_residual, x + 1, yy, zz, X, Y, Z, w0, w1,
                      w2));
      }
      sy[dz] = smooth3(sx[0], sx[1], sx[2]);
    }
    smoothed = smooth3(sy[0], sy[1], sy[2]);
  }
  // out = inj + m_c * (smoothed - inj), m_c = 1 on the coarse interior
  const float mc = interior ? 1.0f : 0.0f;
  out[i] = inj + mc * (smoothed - inj);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// m * (f - L v) at one point from v's value c and its neighbour pairs, in
// residual_at's order
__device__ __forceinline__ float res_pt(float c, float xm, float xp,
                                        float ym, float yp, float zm,
                                        float zp, float f, float m, float w0,
                                        float w1, float w2) {
  const float c2 = 2.0f * c;
  float t0 = xm - c2;
  t0 = t0 + xp;
  float lv = t0 * w0;
  float t1 = ym - c2;
  t1 = t1 + yp;
  lv = lv + t1 * w1;
  float t2 = zm - c2;
  t2 = t2 + zp;
  lv = lv + t2 * w2;
  return m * (f - lv);
}

// Copies nv rows of the plane at vsrc (rows vy0 ... vy0 + nv - 1, wrapped
// by the power-of-two Y) to vdst and nf rows of the plane at fsrc (from
// row fy0) to fdst, all of Z = 4 << lg a row, by 16-byte cp.async, the
// copies of both spread over the CTA's nt threads together.
__device__ __forceinline__ void stage_rows(float* vdst, const float* vsrc,
                                           int vy0, int nv, float* fdst,
                                           const float* fsrc, int fy0,
                                           int nf, int Y, int Z, int lg,
                                           int tid, int nt) {
  const int nch = Z >> 2;
  const int cv = nv << lg, n = cv + (nf << lg);
  for (int i = tid; i < n; i += nt) {
    const bool isf = i >= cv;
    const int e = isf ? i - cv : i;
    const int row = e >> lg, zq = (e & (nch - 1)) << 2;
    const int gy = ((isf ? fy0 : vy0) + row) & (Y - 1);
    cp_async16((isf ? fdst : vdst) + row * Z + zq,
               (isf ? fsrc : vsrc) + (size_t)gy * Z + zq);
  }
}

// m * (f - L v) on a thread's z quad (z = 4 q, one of a row's nch) of a
// plane x: vm, vc, vp the quad on planes x - 1, x and x + 1; pc the staged
// plane x, whose row `row` holds the quad and rows row - 1, row + 1 its y
// neighbours; the quad's f read from fs after the y neighbours (a staged
// f plane), or, fs null, fq (zeros: the f-less mode, 0 - L v in the same
// order); mxy whether x >= 1 and y >= 1.  The z neighbours come from the
// lanes beside it on the same row, else (at a row's or a warp's edge)
// from pc.  Every lane of the warp calls it.  (The restrict walk passing
// its f as fq, loaded before the call, ran 3-6 % slower on an H100:
// scripts/ab_rows.py transfers.)
__device__ __forceinline__ float4 residual_quad(
    const float* pc, int row, int z, int q, int nch, int lane, int Z,
    float4 vm, float4 vc, float4 vp, const float* fs, float4 fq, bool mxy,
    float w0, float w1, float w2) {
  const float4 ym = ld4(pc + (row - 1) * Z + z);
  const float4 yp = ld4(pc + (row + 1) * Z + z);
  if (fs != nullptr) fq = ld4(fs);
  float zl = __shfl_sync(0xffffffffu, vc.w, (lane + 31) & 31);
  float zr = __shfl_sync(0xffffffffu, vc.x, (lane + 1) & 31);
  if (q == 0 || lane == 0) zl = pc[row * Z + ((z - 1) & (Z - 1))];
  if (q == nch - 1 || lane == 31) zr = pc[row * Z + ((z + 4) & (Z - 1))];
  const float m = mxy ? 1.0f : 0.0f;
  float4 a;
  a.x = res_pt(vc.x, vm.x, vp.x, ym.x, yp.x, zl, vc.y, fq.x,
               (mxy && z >= 1) ? 1.0f : 0.0f, w0, w1, w2);
  a.y = res_pt(vc.y, vm.y, vp.y, ym.y, yp.y, vc.x, vc.z, fq.y, m, w0, w1,
               w2);
  a.z = res_pt(vc.z, vm.z, vp.z, ym.z, yp.z, vc.y, vc.w, fq.z, m, w0, w1,
               w2);
  a.w = res_pt(vc.w, vm.w, vp.w, ym.w, yp.w, vc.z, zr, fq.w, m, w0, w1, w2);
  return a;
}

// The residual walk (the header note).  Shared memory: kStages slots,
// each a staged v plane (RV = TJ + 2 rows of Z, from row y0 - 1).  Stage k
// holds v plane x0 - 1 + k; step s computes plane x = x0 + s from stages
// s (in registers), s + 1 and s + 2.  Extents are powers of two, Z >= 4.
template <bool WITH_F>
__global__ void __launch_bounds__(kMaxWalkThreads, 1)
    residual_walk_kernel(const float* __restrict__ v,
                         const float* __restrict__ f,
                         float* __restrict__ r, const ResidualLayout L,
                         float w0, float w1, float w2) {
  extern __shared__ __align__(16) float sm[];
  const int X = L.X, Y = L.Y, Z = L.Z, TJ = L.TJ, NX = L.NX, RV = L.RV;
  const int lg = __ffs(Z) - 3;  // log2 of the quads a row, Z / 4
  const int nch = Z >> 2;
  const int slot = RV * Z;
  const int y0 = blockIdx.x * TJ, x0 = blockIdx.y * NX;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  // this thread's row of the tile and z quad; the padding threads past
  // the last row compute on row TJ - 1 and store nothing
  const bool active = (tid >> lg) < TJ;
  const int rr = active ? tid >> lg : TJ - 1;
  const int q = tid & (nch - 1);
  const int z = 4 * q;
  const int y = y0 + rr;
  const size_t plane = (size_t)Y * Z;
  const size_t quad = (size_t)y * Z + z;  // the quad in a plane
  const int vrow = (rr + 1) * Z + z;      // ... in a staged v plane
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // stage k into slot k % kStages: the tile's rows of v plane x0 - 1 + k;
  // one commit group a stage, empty past the walk
  auto issue = [&](int k) {
    if (k < NX + 2) {
      stage_rows(sm + (k & (kStages - 1)) * slot,
                 v + (size_t)((x0 - 1 + k) & (X - 1)) * plane, y0 - 1, RV,
                 nullptr, nullptr, 0, 0, Y, Z, lg, tid, nt);
    }
    cp_commit();
  };
  auto load_f = [&](int x) {
    return WITH_F && active
               ? __ldg(reinterpret_cast<const float4*>(f + x * plane + quad))
               : zero;
  };

  for (int k = 0; k < kStages; ++k) issue(k);
  float4 fc = load_f(x0);
  cp_wait<kStages - 2>();  // stages 0 and 1
  __syncthreads();
  float4 vm = ld4(sm + vrow);
  float4 vc = ld4(sm + slot + vrow);
  for (int s = 0; s < NX; ++s) {
    const int x = x0 + s;
    const float4 fn = s + 1 < NX ? load_f(x + 1) : zero;
    cp_wait<kStages - 3>();  // stage s + 2
    __syncthreads();  // ... everyone's; and slot s % kStages is free
    issue(s + kStages);
    const float* pc = sm + ((s + 1) & (kStages - 1)) * slot;  // plane x
    const float* pn = sm + ((s + 2) & (kStages - 1)) * slot;  // x + 1
    const float4 vp = ld4(pn + vrow);
    const float4 a = residual_quad(pc, rr + 1, z, q, nch, lane, Z, vm, vc,
                                   vp, nullptr, fc, x >= 1 && y >= 1, w0,
                                   w1, w2);
    if (active) __stcs(reinterpret_cast<float4*>(r + x * plane + quad), a);
    vm = vc;
    vc = vp;
    fc = fn;
  }
}

// The plane walk (the header note).  Shared memory: kStages slots, each a
// staged v plane (RV rows of Z) and, with the residual, an f plane (RR
// rows); then the x-smoothed plane (RR rows) and the injected values (TJ
// rows of Zc).  Stage k holds v plane x0 - 1 + k and f plane x0 + k - 2;
// step s computes the residual on plane x = x0 + s from stages s + 1 and
// s + 2.  Extents are powers of two, Z >= 4.
template <bool RES>
__global__ void __launch_bounds__(kMaxWalkThreads, 1)
    restrict_walk_kernel(const float* __restrict__ v,
                         const float* __restrict__ f,
                         float* __restrict__ out, const RestrictLayout L,
                         float w0, float w1, float w2) {
  extern __shared__ __align__(16) float sm[];
  const int Yc = L.Yc, Zc = L.Zc;
  const int X = 2 * L.Xc, Y = 2 * Yc, Z = 2 * Zc;
  const int RR = L.RR, RV = L.RV, TJ = L.TJ;
  const int lg = __ffs(Z) - 3;  // log2 of the quads a row, Z / 4
  const int nch = Z >> 2;
  const int slot = (RV + (RES ? RR : 0)) * Z;
  float* sx = sm + kStages * slot;
  float* inj = sx + RR * Z;
  const int J0 = blockIdx.x * TJ, I0 = blockIdx.y * L.NI;
  const int NS = 2 * L.NI + 1;  // residual planes x0 ... x0 + NS - 1
  const int x0 = 2 * I0 - 1;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  // this thread's fine row of the tile (rr: y = 2 J0 - 1 + rr) and z quad;
  // the padding threads past the last row compute on row RR - 1 and store
  // nothing
  const bool active = (tid >> lg) < RR;
  const int rr = active ? tid >> lg : RR - 1;
  const int q = tid & (nch - 1);
  const int z = 4 * q;
  const int y = (2 * J0 - 1 + rr) & (Y - 1);
  const size_t plane = (size_t)Y * Z;
  const int vrow = (rr + (RES ? 1 : 0)) * Z + z;  // in a staged v plane

  // stage k into slot k % kStages: the tile's rows of v plane x0 - 1 + k
  // (from fine row 2 J0 - 2, or 2 J0 - 1 without the residual) and of f
  // plane x0 + k - 2 (from 2 J0 - 1); one commit group a stage, empty past
  // the walk
  auto issue = [&](int k) {
    if (k < NS + 2) {
      float* dst = sm + (k & (kStages - 1)) * slot;
      stage_rows(dst, v + (size_t)((x0 - 1 + k) & (X - 1)) * plane,
                 2 * J0 - (RES ? 2 : 1), RV, dst + RV * Z,
                 f + (size_t)((x0 + k - 2) & (X - 1)) * plane, 2 * J0 - 1,
                 RES && k >= 2 ? RR : 0, Y, Z, lg, tid, nt);
    }
    cp_commit();
  };

  // coarse plane I of the tile from the x-smoothed plane 2I and the
  // injected values: y then z smoothing, one coarse point a thread
  auto coarse = [&](int I) {
    const int lgz = lg + 1;  // log2(Zc)
    for (int t = tid; t < TJ * Zc; t += nt) {
      const int j = t >> lgz, K = t & (Zc - 1);
      const int J = J0 + j;
      const float iv = inj[t];
      float sv = iv;
      const bool interior = I >= 1 && J >= 1 && K >= 1;
      if (interior) {
        const float* s0 = sx + 2 * j * Z + 2 * K - 1;
        float sy[3];
        for (int dz = 0; dz < 3; ++dz) {
          sy[dz] = smooth3(s0[dz], s0[Z + dz], s0[2 * Z + dz]);
        }
        sv = smooth3(sy[0], sy[1], sy[2]);
      }
      const float mc = interior ? 1.0f : 0.0f;
      out[((size_t)I * Yc + J) * Zc + K] = iv + mc * (sv - iv);
    }
  };

  for (int k = 0; k < kStages; ++k) issue(k);
  cp_wait<kStages - 2>();  // stages 0 and 1
  __syncthreads();
  float4 vm = ld4(sm + vrow);
  float4 vc = ld4(sm + slot + vrow);
  float4 ra = make_float4(0.f, 0.f, 0.f, 0.f), rb = ra;
  for (int s = 0; s < NS; ++s) {
    cp_wait<kStages - 3>();  // stage s + 2
    __syncthreads();  // ... everyone's; and slot s % kStages is free
    issue(s + kStages);
    if (s >= 3 && (s & 1)) coarse(I0 + (s - 3) / 2);
    const float* pc = sm + ((s + 1) & (kStages - 1)) * slot;  // v plane x
    const float* pn = sm + ((s + 2) & (kStages - 1)) * slot;  // x + 1, f
    const float4 vp = ld4(pn + vrow);
    float4 a;
    if (RES) {
      const int x = (x0 + s) & (X - 1);
      a = residual_quad(pc, rr + 1, z, q, nch, lane, Z, vm, vc, vp,
                        pn + (RV + rr) * Z + z, vc, x >= 1 && y >= 1, w0,
                        w1, w2);
    } else {
      a = vc;
    }
    // a is the source at x = x0 + s; at x = 2I + 1 the x-smoothed plane 2I
    // (ra, rb, a: planes 2I - 1, 2I, 2I + 1) and its injected values
    if (s >= 2 && !(s & 1) && active) {
      float4 o;
      o.x = smooth3(ra.x, rb.x, a.x);
      o.y = smooth3(ra.y, rb.y, a.y);
      o.z = smooth3(ra.z, rb.z, a.z);
      o.w = smooth3(ra.w, rb.w, a.w);
      *reinterpret_cast<float4*>(sx + rr * Z + z) = o;
      if (rr & 1) {  // y = 2J: K = z / 2 and z / 2 + 1
        *reinterpret_cast<float2*>(inj + (rr >> 1) * Zc + (z >> 1)) =
            make_float2(rb.x, rb.z);
      }
    }
    ra = rb;
    rb = a;
    vm = vc;
    vc = vp;
  }
  __syncthreads();
  coarse(I0 + L.NI - 1);
}

// Linear upsample along one axis of the separable prolongation:
// odd fine index -> 0.5 * (a[i] + a[i+1 mod m]), even -> a[i].
__device__ __forceinline__ float lerp_pair(float a, float b, int odd) {
  return odd ? 0.5f * (a + b) : a;
}

// A coarse cell a thread: corners c[i or i1][j or j1][k or k1] (1: the
// wrapped next index), the fine points (2i + px, 2j + py, 2k + pz).
// vb and out may be one tensor.
__global__ void __launch_bounds__(kThreads)
    prolong_cell_kernel(const float* __restrict__ c, const float* vb,
                        float* out, const ProlongLayout L, int replace) {
  const int k = blockIdx.x * L.bx + threadIdx.x;
  const int j = blockIdx.y * L.by + threadIdx.y;
  const int i = blockIdx.z;
  const int Xc = L.Xc, Yc = L.Yc, Zc = L.Zc;
  if (k >= Zc || j >= Yc) return;
  const int Y = 2 * Yc, Z = 2 * Zc;
  const size_t cplane = (size_t)Yc * Zc;
  const size_t ci[2] = {(size_t)i * cplane,
                        (size_t)wrap_inc(i, Xc) * cplane};
  const int cj[2] = {j * Zc, wrap_inc(j, Yc) * Zc};
  const int ck[2] = {k, wrap_inc(k, Zc)};
  float cc[2][2][2];  // [dx][dy][dz]
  for (int dx = 0; dx < 2; ++dx)
    for (int dy = 0; dy < 2; ++dy)
      for (int dz = 0; dz < 2; ++dz)
        cc[dx][dy][dz] = c[ci[dx] + cj[dy] + ck[dz]];
  // fine row (2i + px, 2j + py), z = 2k and 2k + 1
  const size_t r00 = ((size_t)(2 * i) * Y + 2 * j) * Z + 2 * k;
  const size_t rx = (size_t)Y * Z;
  float2 base[2][2];
  for (int px = 0; px < 2; ++px)
    for (int py = 0; py < 2; ++py)
      base[px][py] = *reinterpret_cast<const float2*>(vb + r00 + px * rx +
                                                      py * Z);
  for (int px = 0; px < 2; ++px) {
    // x first (the jnp tier's axis order), shared by the cell's points
    float ax[2][2];  // [dy][dz]
    for (int dy = 0; dy < 2; ++dy)
      for (int dz = 0; dz < 2; ++dz)
        ax[dy][dz] = lerp_pair(cc[0][dy][dz], cc[1][dy][dz], px);
    for (int py = 0; py < 2; ++py) {
      const float ay[2] = {lerp_pair(ax[0][0], ax[1][0], py),
                           lerp_pair(ax[0][1], ax[1][1], py)};
      const bool mxy = 2 * i + px >= 1 && 2 * j + py >= 1;
      const float2 b = base[px][py];
      float o[2];
      for (int pz = 0; pz < 2; ++pz) {
        const float up = lerp_pair(ay[0], ay[1], pz);
        const float m = (mxy && 2 * k + pz >= 1) ? 1.0f : 0.0f;
        const float bz = pz ? b.y : b.x;
        o[pz] = replace ? bz + m * (up - bz) : bz + m * up;
      }
      *reinterpret_cast<float2*>(out + r00 + px * rx + py * Z) =
          make_float2(o[0], o[1]);
    }
  }
}

}  // namespace

extern "C" {

int pdemg_residual(const float* v, const float* f, float* r,
                   const ResidualLayout* lay, float w0, float w1, float w2,
                   void* stream) {
  const ResidualLayout L = *lay;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(L.gx, L.gy, L.gz), block(L.bx, L.by);
  if (L.form == 0) {
    if (L.with_f) {
      residual_point_kernel<true><<<grid, block, 0, s>>>(v, f, r, L, w0, w1,
                                                         w2);
    } else {
      residual_point_kernel<false><<<grid, block, 0, s>>>(v, f, r, L, w0,
                                                          w1, w2);
    }
    return (int)cudaGetLastError();
  }
  void (*kern)(const float*, const float*, float*, const ResidualLayout,
               float, float, float) =
      L.with_f ? residual_walk_kernel<true> : residual_walk_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, block, L.smem_bytes, s>>>(v, f, r, L, w0, w1, w2);
  return (int)cudaGetLastError();
}

int pdemg_residual_restrict(const float* v, const float* f, float* out,
                            const RestrictLayout* lay, float w0, float w1,
                            float w2, void* stream) {
  const RestrictLayout L = *lay;
  const cudaStream_t s = (cudaStream_t)stream;
  if (L.form == 0) {
    residual_restrict_kernel<<<L.grid_x, L.threads, 0, s>>>(
        v, f, out, L.with_residual, L.Xc, L.Yc, L.Zc, w0, w1, w2);
    return (int)cudaGetLastError();
  }
  void (*kern)(const float*, const float*, float*, const RestrictLayout,
               float, float, float) =
      L.with_residual ? restrict_walk_kernel<true>
                      : restrict_walk_kernel<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(L.grid_x, L.grid_y), L.threads, L.smem_bytes, s>>>(
      v, f, out, L, w0, w1, w2);
  return (int)cudaGetLastError();
}

int pdemg_prolong_blend(const float* c, const float* vb, float* out,
                        const ProlongLayout* lay, int replace,
                        void* stream) {
  const ProlongLayout L = *lay;
  prolong_cell_kernel<<<dim3(L.gx, L.gy, L.gz), dim3(L.bx, L.by), 0,
                        (cudaStream_t)stream>>>(c, vb, out, L, replace);
  return (int)cudaGetLastError();
}

}  // extern "C"
