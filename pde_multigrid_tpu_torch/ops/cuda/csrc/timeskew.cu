// Time-skewed red-black Gauss-Seidel on 3D wrap-storage halves, T sweeps
// per launch (sm_90a), on a thread-block cluster that shares its halos.
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_timeskew_relax       (whole half-planes)
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_timeskew_relax_jb    (j-blocked)
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_timeskew_relax_shard (one shard's chunk)
// and, in its error mode (pdemg_timeskew_error), on the defect levels
// whose halves the card's shared memory does not hold (256^3, 512^3),
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_resident_sweeps
// (see below; relax.cu's whole-leg kernel serves the smaller levels).
// All three compute one function: from the black half b and the RHS
// halves fr, fb of a level in the halves layout (X, Y/2, Z) (q = (x + z) %
// 2, red at y = 2j + q, black at y = 2j + 1 - q), the (r, b) halves after
// T red->black sweeps, every update written as `ok ? upd : 0` (the masks
// of relax.py:1117-1151).  So the red input is never read, plane 0 of both
// outputs is zero, plane 0 of b and the plane past X - 1 read as zero, and
// the j and z wrap reads land on zero or masked points.  The TPU's split
// into two kernels is a VMEM budget; one kernel serves both here, with T
// a template parameter (1 ... 4: the wrapper's T and the remainders).
//
// What bounds it.  Per launch it reads b, fr and fb once and writes b (and
// r on the last launch of a leg): 16 B per halves point for T sweeps, so a
// 100-sweep leg at T = 4 moves 3.4 GB at 256^3 (1.0 ms at 3.35 TB/s) and
// 27 GB at 512^3 (8.1 ms).  Its float32 operations (13 an update, 2.18e10
// a 256^3 leg) take 0.65 ms at one add or multiply a lane a clock, the
// rate --fmad=false leaves.  So the design raises T (the bytes) while
// keeping the instructions per update low.  On the card (PERF.md) a T = 4
// leg runs at about a third of the HBM rate: each level-step is bound by
// instruction issue and shared-memory bandwidth (16 wavefronts a warp a
// level), 7 resident clusters of 16 CTAs use 112 of the 132 SMs, and the
// 512-thread CTA (121 of its 128 registers at T = 4) caps a 512^3 CTA at
// 4 rows, hence its bands.
//
// Design (time skew on a cluster, halos shared instead of recomputed).  A
// cluster of `ctas` CTAs (up to 16: non-portable) covers a band of the
// (j, z) half-plane: CTA k holds `rows` whole j rows of it, every z, so no
// z halo exists, and the band's rows form a ring over the cluster.  When
// the band is the whole half-plane (256^3: 16 CTAs of 8 rows) the ring is
// the level's own j wrap and nothing is recomputed; otherwise (512^3: six
// bands of 48 owned rows) a band also computes 2T rows past each outer
// edge, which the ring's closure corrupts one row per level and nothing
// writes out.  The cluster walks an x range [x0, x1) with the TPU
// kernels' time-skew schedule: at step t, level L (0: the input black;
// 2s - 1: red of sweep s; 2s: black of sweep s) finishes plane t - L
// (relax.py:1633-1678).  A thread holds K z points of one row (4, or 2
// where Z % 4 != 0); per level it keeps in registers the plane it finished
// at the previous step (the centre of the next level's update) and reads
// the plane before it from its own place in shared memory, just before it
// overwrites that place with this step's plane: so the x - 1 / x / x + 1
// neighbours cost one register set and one load a level.  The j and z
// neighbours come from a tile per level in shared memory holding the
// plane each level finished at the previous step, double-buffered by step
// parity, with one halo row above and below the CTA's rows.  Each tile
// row stores its even z points, then its odd ones, so a point's j
// neighbour (row j + 1 for even z and j - 1 for odd z at an even step, the
// other way at an odd one: the same for every level) is one 8-byte load
// per colour, and a halo row is read at one z parity only.  After each
// step a CTA bulk-copies that half of its first and of its last row (all
// levels at once, contiguous) into its two neighbours' halo rows with
// cp.async.bulk.shared::cluster, completing on their mbarrier of that
// parity.  No cluster barrier and no remote load in the sweep: only the
// CTA's edge rows wait on its own mbarrier for the previous step's
// halos, and one block barrier ends each step.  Steps come in pairs so
// that the parity is a compile-time constant; an interior step (every
// plane it touches inside the level, past the warm-up) takes a body
// without range checks.  RHS and input planes are loaded a step ahead
// into registers (16-byte loads).  x does not wrap: planes outside
// [1, X - 1] are zero, and a chunk that starts at x0 > 0 begins 2T planes
// early (level l skips the first 2l of them, which only lead to levels
// that are not exact); the x chunks fill the card's resident clusters.
// The launch geometry (cluster, rows, bands, chunks) is the caller's
// (ops/cuda/relax.py timeskew_layout) and checked here.
//
// The error mode (template flag E; ops/cuda/relax.py error_timeskew) is
// row 10's function, the bf16 defect path's error sweeps: from e = 0
// (v_zero on a leg's first launch), the black error half b and the
// residual halves rr, rb in bf16 (2 B a point, exact when widened), the
// update Poisson.split_update_folded (relax.cu's folded_update, its iso
// branch included: isotropic (p0 + p1 + p2) a0 - r inv_den), and each
// level-step's result rounded to bf16 (__float2bfloat16_rn) before any
// neighbour reads it, so a leg is bitwise relax.error_sweeps_plain: the
// where form and the red input never read are that function's own.  The
// tiles stay float (the rounded values are exact there), so the layout,
// the bands and T = 4 are the float32 mode's.  A leg of 100 sweeps at
// T = 4 reads rr, rb and b and writes b 25 times (8 B a halves point a
// launch: 1.7 GB at 256^3, 13 GB at 512^3); its bound is the operations,
// 8 an updated point a half-sweep (1.3e10 at 256^3, 0.20 ms at 67
// TFLOP/s; 1.1e11, 1.6 ms, at 512^3), against the one-launch-a-half-sweep
// chain's pass over device memory a half-sweep.  Built for k = 4 only (the
// defect plan takes the mode where Z % 4 == 0), once for each of the
// update's two forms (no branch a point): eight instantiations.  A level's
// RHS words stay packed two a register until used, and each level-step's
// four values are rounded two a conversion.  On the card (PERF.md) a
// 100-sweep leg takes 2.44 ms at 256^3 and 24.2 ms at 512^3, against 5.94
// and 44.1 for the half-sweep chain.
//
// The shard chunk (pdemg_timeskew_shard, parallel/halo.py's time-skew
// engine) is the same walk on one shard's extended slab: XE = x_loc + 4T
// planes, plane x being global plane g0 + x of a level of XG planes (g0
// even, so the parity of x is the global one).  A plane updates iff
// 1 <= x <= XE - 1 and 1 <= g <= XG - 1; the input black half is read on
// every plane of the slab (plane 0 too: it is a halo, not the boundary)
// up to global plane XG - 1, and reads past it or the slab are zero,
// which is the TPU kernel's gate on its +1 read.  Edge corruption moves
// two planes per sweep, so after T sweeps the owned window [2T, 2T +
// x_loc) is exact.  The wrapper runs a chunk of t sweeps as t // T
// launches of T and one of t % T, each computing only the window that the
// next one (or the owned window) needs, and the last one writes the owned
// window straight into the shard's own halves (out_lo: the slab plane
// written to plane 0 of the output); r is written by the last launch of a
// leg only, in both modes.
//
// Numerics: built with --fmad=false and Poisson.split_update's order
// (stencil.cuh), so the result is bitwise the plain PyTorch version's
// (ops/cuda/relax.py timeskew_sweeps_plain) and does not depend on T, the
// cluster, the bands or the x chunks.  Element offsets are 32-bit and
// formed only for planes inside the level: the wrapper refuses a level of
// 2^31 points or more.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "stencil.cuh"  // split_update, folded_update

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCtas = 16;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may hold
constexpr int kSyncBytes = 16;    // the two halo mbarriers (static)
constexpr int kMaxDynSmem = kMaxSmem - kSyncBytes;

// ops/cuda/relax.py TimeskewLayout
struct TimeskewLayout {
  int k;           // z points per thread: 4, or 2
  int ctas;        // CTAs per cluster (along j)
  int rows;        // j rows per CTA
  int band;        // rows a band owns (ctas * rows when halo == 0)
  int halo;        // rows a band computes past each outer edge: 0 or 2T
  int bands;       // bands over the half-plane
  int chunks;      // x chunks of the window
  int lx;          // planes per x chunk (even)
  int threads;     // per CTA
  int smem_bytes;  // dynamic shared memory per CTA
};

// Element pointers: float, or bf16 in the error mode.
struct Args {
  const void* b;
  const void* fr;
  const void* fb;
  void* r;   // null: r is not written
  void* bo;
  int X, Y2, Z;
  int v_zero;          // b is zero and not read
  int vlo, vhi, ilo;   // planes [vlo, vhi] update, b is read on [ilo, vhi]
  int w_lo, w_hi;      // the planes written, plane x to plane x - out_lo
  int out_lo;
  float w0, w1, w2, inv_den;  // error mode: a0, a1, a2 (folded), inv_den
  TimeskewLayout lay;
};

__device__ __forceinline__ int wrap_mod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of this CTA's shared `p` in CTA `cta` of the cluster.
__device__ __forceinline__ unsigned remote_addr(const void* p, int cta) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(cta));
  return a;
}

// K consecutive floats of device memory (16- or 8-byte aligned).
template <int K>
__device__ __forceinline__ void ldg(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x; v[1] = a.y;
  }
}

template <int K>
__device__ __forceinline__ void stg(float* p, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int K>
__device__ __forceinline__ void stg_bf16(__nv_bfloat16* p,
                                         const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  } else {
    *reinterpret_cast<unsigned*>(p) = pack_bf16(v[0], v[1]);
  }
}

// K consecutive values of a row as loaded from device memory: floats, or
// in the error mode the bf16 bits, two a register, widened where they are
// used (exact): half the registers a level's RHS holds.
template <int K, bool E>
struct Row {
  float v[K];
  __device__ __forceinline__ float at(int k) const { return v[k]; }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = 0.0f;
  }
  __device__ __forceinline__ void load(const void* p, int off) {
    ldg<K>(static_cast<const float*>(p) + off, v);
  }
};

template <int K>
struct Row<K, true> {
  unsigned w[K / 2];
  __device__ __forceinline__ float at(int k) const {
    return __uint_as_float((k & 1) ? (w[k >> 1] & 0xffff0000u)
                                   : (w[k >> 1] << 16));
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < K / 2; ++k) w[k] = 0u;
  }
  __device__ __forceinline__ void load(const void* p, int off) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + off;
    if constexpr (K == 4) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(q));
      w[0] = a.x;
      w[1] = a.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(q));
    }
  }
};

template <int K, bool E>
__device__ __forceinline__ void st_elems(void* p, int off,
                                         const float (&v)[K]) {
  if constexpr (E) {
    stg_bf16<K>(static_cast<__nv_bfloat16*>(p) + off, v);
  } else {
    stg<K>(static_cast<float*>(p) + off, v);
  }
}

// H = K / 2 floats of shared memory: a thread's even or odd z points.
template <int H>
__device__ __forceinline__ void lds(const float* p, float (&v)[H]) {
  if constexpr (H == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

template <int H>
__device__ __forceinline__ void sts(float* p, float a0, float a1) {
  if constexpr (H == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a0, a1);
  } else {
    *p = a0;
  }
}

// Tile layout (floats), per step parity: rows 0 ... rows + 1 (0 and
// rows + 1 the halo rows), each row the even z points of the 2T tile
// levels, then their odd z points, each level's Z / 2 points padded to Zp
// (a multiple of 4).  A halo row is read at one z parity only (the one
// whose partner lies across it at that step), and that parity of a row is
// contiguous over the levels and 16-byte aligned: one bulk copy sends it.
__host__ __device__ inline int padded_half(int Z) {
  return ((Z >> 1) + 3) & ~3;
}

// M: the mode, 0 float32, 1 the error mode with isotropic spacing, 2 the
// error mode with anisotropic spacing (folded_update's two forms)
template <int T, int K, int M>
__global__ void __launch_bounds__(kMaxThreads, 1)
    timeskew_kernel(const __grid_constant__ Args a) {
  constexpr bool E = M != 0;
  constexpr int NT = 2 * T;   // tile levels 0 ... 2T - 1 (2T is only written)
  constexpr int NL = NT + 1;  // levels 0 ... 2T
  constexpr int H = K / 2;
  extern __shared__ __align__(16) float tiles[];
  __shared__ __align__(8) uint64_t bar[2];  // halo rows of parity p landed

  const TimeskewLayout& L = a.lay;
  const int Z = a.Z, Zh = Z >> 1, Zp = padded_half(Z), R = L.rows;
  const int G = Z / K;
  const int OD = NT * Zp;       // the odd points of a tile row
  const int RS = 2 * OD;        // floats per tile row
  const int PS = (R + 2) * RS;  // floats per parity
  const int tid = threadIdx.x;
  const int i = tid / G, g = tid - (tid / G) * G;
  const bool active = i < R;
  const int rank = (int)blockIdx.x;  // the cluster is (ctas, 1, 1)
  const int pos = rank * R + i;      // row among the band's computed rows
  const int first = (int)blockIdx.y * L.band;  // the band's first owned row
  const int jg = wrap_mod(first - L.halo + pos, a.Y2);
  const bool owned = active && pos >= L.halo && pos < L.halo + L.band &&
                     first + pos - L.halo < a.Y2;
  const int plane = a.Y2 * Z;
  const int col = jg * Z + g * K;
  const int x0 = a.w_lo + (int)blockIdx.z * L.lx;
  const int x1 = min(x0 + L.lx, a.w_hi);
  const int t0 = x0 - NT, t1 = x1 + NT;  // steps [t0, t1)

  // this thread's points in tile level 0: evens at `me`, odds at
  // me + OD; the z neighbours z0 - 1 (odd) and z0 + K (even), wrapped in
  // the row; level l at + l Zp
  const int me = (i + 1) * RS + g * H;
  const int zl = (i + 1) * RS + OD + (g == 0 ? Zh - 1 : g * H - 1);
  const int zr = (i + 1) * RS + (g == G - 1 ? 0 : g * H + H);
  const bool row0 = jg == 0, zfirst = g == 0;
  // the CTA's first and last rows: the only ones that read halo rows and
  // that the bulk copies read
  const bool edge = active && (i == 0 || i == R - 1);

  for (int k = tid; k < 2 * PS; k += blockDim.x) tiles[k] = 0.0f;
  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :
                   : "r"(smem_addr(bar + p))
                   : "memory");
    }
    // the initialised barriers seen by the cluster's bulk copies
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA of the cluster zeroed and initialised before any copy
  cg::this_cluster().sync();

  const int left = (rank + L.ctas - 1) % L.ctas;
  const int right = (rank + 1) % L.ctas;
  const unsigned half_bytes = 4u * (unsigned)OD;

  // in[0]: b at plane tn; in[l]: level l's RHS (fr for red, fb for black)
  // at plane tn - l; zero outside [ilo, vhi] and [vlo, vhi]
  Row<K, E> in[NL];
  // unchecked (interior steps): every plane loaded lies in the level
  auto load_in = [&](int l, int tn, auto checked) {
    constexpr bool kChecked = decltype(checked)::value;
    const int x = tn - l;
    if (!kChecked) {
      in[l].load(l == 0 ? a.b : (l & 1) ? a.fr : a.fb, x * plane + col);
      return;
    }
    if (l == 0) {
      if (!a.v_zero && x >= a.ilo && x <= a.vhi) {
        in[0].load(a.b, x * plane + col);
        return;
      }
    } else if (x >= a.vlo && x <= a.vhi) {
      in[l].load((l & 1) ? a.fr : a.fb, x * plane + col);
      return;
    }
    in[l].zero();
  };
  if (active) {
#pragma unroll
    for (int l = 0; l < NL; ++l) load_in(l, t0, std::true_type{});
  }

  // per tile level: the plane it finished at the previous step
  float mid[NT][K];
#pragma unroll
  for (int l = 0; l < NT; ++l) {
#pragma unroll
    for (int k = 0; k < K; ++k) mid[l][k] = 0.0f;
  }
  unsigned phase = 0;  // bit p: the parity of bar[p]'s phase to wait for

  // One step at t of parity P: level l finishes plane t - l.  Unchecked
  // (an interior step): every level's plane lies in [vlo, vhi] and is
  // exact, and so do the planes loaded for the next step
  auto step = [&](int t, auto parity, auto checked) {
    constexpr int P = decltype(parity)::value;
    constexpr bool kChecked = decltype(checked)::value;
    float* const wt = tiles + P * PS;              // written: this step
    const float* const rt = tiles + (P ^ 1) * PS;  // read: previous step
    // the previous step's halo rows landed (an interior step always has
    // one)
    if (edge && (!kChecked || t > t0)) {
      const unsigned ph = (phase >> (P ^ 1)) & 1u;
      unsigned done = 0;
      while (!done) {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_addr(bar + (P ^ 1))), "r"(ph)
            : "memory");
      }
      phase ^= 1u << (P ^ 1);
    }
    if (active) {
      // the step's j neighbour rows: at an even step a point's partner is
      // row j + 1 for even z, j - 1 for odd z (every level, either
      // colour); the other way round at an odd step.  A point is masked
      // off at z = 0 and where its partner is row j - 1 of row j = 0
      constexpr int SE = P == 0 ? 1 : -1;
      float hi[K];
#pragma unroll
      for (int k = 0; k < K; ++k) hi[k] = in[0].at(k);
      load_in(0, t + 1, checked);
#pragma unroll
      for (int l = 1; l < NL; ++l) {
        const int lt = (l - 1) * Zp;  // level l - 1 in a tile row
        // level l - 1's plane x - 1 (two steps old) from its place, then
        // this step's plane x + 1 into it
        float lo_e[H], lo_o[H];
        lds<H>(wt + lt + me, lo_e);
        lds<H>(wt + lt + me + OD, lo_o);
        if constexpr (H == 2) {
          sts<H>(wt + lt + me, hi[0], hi[2]);
          sts<H>(wt + lt + me + OD, hi[1], hi[3]);
        } else {
          sts<H>(wt + lt + me, hi[0], 0.0f);
          sts<H>(wt + lt + me + OD, hi[1], 0.0f);
        }
        const int x = t - l;
        float nv[K];
        // planes outside [vlo, vhi] are zero; level l is exact from the
        // chunk's step t0 + 2l on, and what it computes before feeds only
        // levels that are not exact either: skipped (uniform across the
        // CTA)
        if (!kChecked || (x >= a.vlo && x <= a.vhi && t - t0 >= 2 * l)) {
          const float* c = mid[l - 1];
          float ye[H], yo[H];
          lds<H>(rt + lt + me + SE * RS, ye);
          lds<H>(rt + lt + me + OD - SE * RS, yo);
          const float wl = rt[lt + zl], wr = rt[lt + zr];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int h = k >> 1;
            const float lo = (k & 1) ? lo_o[h] : lo_e[h];
            const float yn = (k & 1) ? yo[h] : ye[h];
            const float zm = k == 0 ? wl : c[k - 1];
            const float zp = k == K - 1 ? wr : c[k + 1];
            const float px = lo + hi[k];
            const float py = c[k] + yn;
            const float pz = zm + zp;
            if constexpr (E) {
              // the error equation's folded update
              nv[k] = folded_update(px, py, pz, in[l].at(k), M == 1, a.w0,
                                    a.w1, a.w2, a.inv_den);
            } else {
              nv[k] = split_update(px, py, pz, in[l].at(k), a.w0, a.w1, a.w2,
                                   a.inv_den);
            }
          }
          if constexpr (E) {
            // rounded to bf16 before any neighbour reads it, two values a
            // conversion
#pragma unroll
            for (int k = 0; k < K; k += 2) {
              const __nv_bfloat162 h2 = __floats2bfloat162_rn(nv[k], nv[k + 1]);
              const unsigned w = *reinterpret_cast<const unsigned*>(&h2);
              nv[k] = __uint_as_float(w << 16);
              nv[k + 1] = __uint_as_float(w & 0xffff0000u);
            }
          }
          if (row0 || zfirst) {  // a few threads: the masked points
#pragma unroll
            for (int k = 0; k < K; ++k) {
              // even z at an odd step and odd z at an even one partner
              // row j - 1
              const bool j_off = row0 && ((k & 1) ? P == 0 : P == 1);
              if (j_off || (zfirst && k == 0)) nv[k] = 0.0f;
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) nv[k] = 0.0f;
        }
        load_in(l, t + 1, checked);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          mid[l - 1][k] = hi[k];
          hi[k] = nv[k];
        }
      }
      // the last level (black of sweep T) at plane t - 2T, the one before
      // it (red of sweep T) at t - 2T + 1
      // (an interior step writes both: x0 <= xb and xr < x1)
      if (owned) {
        const int xb = t - NT, xr = xb + 1;
        if (!kChecked || (xb >= x0 && xb < x1))
          st_elems<K, E>(a.bo, (xb - a.out_lo) * plane + col, hi);
        if (a.r && (!kChecked || (xr >= x0 && xr < x1)))
          st_elems<K, E>(a.r, (xr - a.out_lo) * plane + col, mid[NT - 1]);
      }
    }
    // the edge rows written (generic proxy) before the bulk copies
    // (async proxy) read them
    if (edge) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0 && (!kChecked || t + 1 < t1)) {
      // expect both neighbours' halves on bar[P].  At the next step (of
      // parity P ^ 1) the left CTA's lower halo row is read at odd z if
      // P == 0 (at even z if P == 1), the right CTA's upper one at the
      // other parity: send those halves of the first and the last row
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :
                   : "r"(smem_addr(bar + P)), "r"(2 * half_bytes)
                   : "memory");
      const int lo_half = P == 0 ? OD : 0, hi_half = OD - lo_half;
      const float* src[2] = {wt + RS + lo_half, wt + R * RS + hi_half};
      float* dst[2] = {wt + (R + 1) * RS + lo_half, wt + hi_half};
      const int cta[2] = {left, right};
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];"
            :
            : "r"(remote_addr(dst[d], cta[d])), "r"(smem_addr(src[d])),
              "r"(half_bytes), "r"(remote_addr(bar + P, cta[d]))
            : "memory");
      }
    }
  };

  // the interior steps [t_in, t_out): past the warm-up (t >= t0 + 4T),
  // every level's plane t - l in [vlo, vhi], the next step's loads (b at
  // t + 1, level l's RHS at t + 1 - l) in the level, b read, and a next
  // step in the chunk
  const int t_in = a.v_zero ? t1 : max(max(t0 + 2 * NT, a.vlo + NT),
                                        a.ilo - 1);
  const int t_out = min(a.vhi, t1 - 1);  // t + 1 <= vhi, t + 2 < t1
  // t0 is even (x0 and 2T are)
  for (int t = t0; t < t1; t += 2) {
    if (t >= t_in && t + 1 < t_out) {
      step(t, std::integral_constant<int, 0>{}, std::false_type{});
      step(t + 1, std::integral_constant<int, 1>{}, std::false_type{});
    } else {
      step(t, std::integral_constant<int, 0>{}, std::true_type{});
      if (t + 1 < t1) {
        step(t + 1, std::integral_constant<int, 1>{}, std::true_type{});
      }
    }
  }
  // every copy into this CTA was waited for but the last step's, which
  // none sends; no CTA leaves while a neighbour may still read its rows
  cg::this_cluster().sync();
}

bool valid(const TimeskewLayout& L, int T, int W, int Y2, int Z) {
  if (T < 1 || T > 4 || W < 1 || Y2 < 1 || Z < 2 || Z % 2) return false;
  if (L.k != 2 && L.k != 4) return false;
  if (Z % L.k) return false;
  if (L.ctas < 1 || L.ctas > kMaxCtas || L.rows < 1) return false;
  const int G = Z / L.k;
  const long long threads = ((long long)L.rows * G + 31) / 32 * 32;
  if (L.threads != threads || threads > kMaxThreads) return false;
  const long long smem = 2LL * (L.rows + 2) * 2 * (2 * T) * padded_half(Z) * 4;
  if (L.smem_bytes != smem || smem > kMaxDynSmem) return false;
  if (L.halo == 0) {
    if (L.ctas * L.rows != Y2 || L.band != Y2 || L.bands != 1) return false;
  } else {
    if (L.halo != 2 * T || L.band != L.ctas * L.rows - 2 * L.halo ||
        L.band < 1 || L.bands != (Y2 + L.band - 1) / L.band) {
      return false;
    }
  }
  if (L.bands > 65535 || L.chunks < 1 || L.chunks > 65535) return false;
  if (L.lx < 2 || L.lx % 2 || (long long)L.chunks * L.lx < W ||
      (long long)(L.chunks - 1) * L.lx >= W) {
    return false;
  }
  return true;
}

using KernelFn = void (*)(Args);

template <int K, int M>
KernelFn kernel_at(int T) {
  switch (T) {
    case 1: return timeskew_kernel<1, K, M>;
    case 2: return timeskew_kernel<2, K, M>;
    case 3: return timeskew_kernel<3, K, M>;
    case 4: return timeskew_kernel<4, K, M>;
    default: return nullptr;
  }
}

// The instantiation serving T, k and the mode M (T in 1 ... 4, k in {2,
// 4}; the error modes are built for k = 4 only: null otherwise).
KernelFn kernel_for(int T, int K, int M) {
  if (M == 1) return K == 4 ? kernel_at<4, 1>(T) : nullptr;
  if (M == 2) return K == 4 ? kernel_at<4, 2>(T) : nullptr;
  return K == 4 ? kernel_at<4, 0>(T) : kernel_at<2, 0>(T);
}

// A kernel's attributes: the shared memory it may take, and clusters past
// the portable 8 CTAs.  Once per kernel, outside any capture.
cudaError_t opt_in(KernelFn fn) {
  static KernelFn done[32];
  static int n = 0;
  for (int i = 0; i < n; ++i) {
    if (done[i] == fn) return cudaSuccess;
  }
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess && n < 32) done[n++] = fn;
  return e;
}

struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  Launch(const TimeskewLayout& L, cudaStream_t stream) {
    cfg.gridDim = dim3(L.ctas, L.bands, L.chunks);
    cfg.blockDim = dim3(L.threads, 1, 1);
    cfg.dynamicSmemBytes = L.smem_bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = L.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

int launch(Args& a, const TimeskewLayout* lay, int T, int mode,
           cudaStream_t stream) {
  if (!lay) return (int)cudaErrorInvalidValue;
  a.lay = *lay;
  if (!valid(a.lay, T, a.w_hi - a.w_lo, a.Y2, a.Z)) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.w_lo < 0 || a.w_lo % 2 || a.w_hi > a.X || a.w_lo >= a.w_hi ||
      a.out_lo > a.w_lo) {
    return (int)cudaErrorInvalidValue;
  }
  // the vector loads and stores: K elements of 4 bytes (2 in the error
  // mode)
  const uintptr_t align = (mode ? 2u : 4u) * (unsigned)a.lay.k;
  const void* ptrs[5] = {a.b, a.fr, a.fb, a.r, a.bo};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % align) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if ((long long)a.X * a.Y2 * a.Z >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const KernelFn fn = kernel_for(T, a.lay.k, mode);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in(fn);
  if (e != cudaSuccess) return (int)e;
  Launch l(a.lay, stream);
  e = cudaLaunchKernelEx(&l.cfg, fn, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (r, bo) = T red->black sweeps from the black half b (not read when
// v_zero: b = 0) and the RHS halves (fr, fb) on the launch geometry `lay`
// (relax.timeskew_layout); r may be null (only bo is written).  T = 4 is
// the wrapper's (relax.TIMESKEW_T, from an A/B on the card, PERF.md);
// T = 1 ... 3 serve the remainder launch of a leg.  Default visibility
// spelled out: the host compiler hides a function whose body launches a
// kernel taking a type of this file's unnamed namespace.
__attribute__((visibility("default"))) int pdemg_timeskew(
    const TimeskewLayout* lay, const float* b, const float* fr,
    const float* fb, float* r, float* bo, int X, int Y2, int Z, int T,
    int v_zero, float w0, float w1, float w2, float inv_den, void* stream) {
  // planes 1 .. X - 1 update and the input is read there (plane 0 of b is
  // the boundary); the whole level is the window
  Args a = {b, fr, fb, r, bo, X, Y2, Z, v_zero, 1, X - 1, 1, 0, X, 0,
            w0, w1, w2, inv_den, {}};
  return launch(a, lay, T, 0, (cudaStream_t)stream);
}

// The error mode: (er, bo) = T red->black sweeps of the error equation
// A e = r on bf16 halves from the black error half b (not read when
// v_zero: b = 0) and the bf16 residual halves (rr, rb), with
// Poisson.split_update_folded's constants (iso, a0 ... a2, inv_den), every
// level-step rounded to bf16; er may be null.  k = 4 only.
__attribute__((visibility("default"))) int pdemg_timeskew_error(
    const TimeskewLayout* lay, const __nv_bfloat16* b,
    const __nv_bfloat16* rr, const __nv_bfloat16* rb, __nv_bfloat16* er,
    __nv_bfloat16* bo, int X, int Y2, int Z, int T, int v_zero, int iso,
    float a0, float a1, float a2, float inv_den, void* stream) {
  Args a = {b, rr, rb, er, bo, X, Y2, Z, v_zero, 1, X - 1, 1, 0, X, 0,
            a0, a1, a2, inv_den, {}};
  return launch(a, lay, T, iso ? 1 : 2, (cudaStream_t)stream);
}

// One launch of T sweeps on a shard's extended slab of XE planes whose
// plane 0 is global plane g0 (even) of a level of XG planes: the planes
// [w_lo, w_hi) of (r, bo), plane x written to plane x - out_lo; r may be
// null.  Exact where the input is exact on [w_lo - 2T, w_hi + 2T)
// (clipped to the slab).
__attribute__((visibility("default"))) int pdemg_timeskew_shard(
    const TimeskewLayout* lay, const float* b, const float* fr,
    const float* fb, float* r, float* bo, int XE, int Y2, int Z, int T,
    int g0, int XG, int w_lo, int w_hi, int out_lo, float w0, float w1,
    float w2, float inv_den, void* stream) {
  if (g0 % 2) return (int)cudaErrorInvalidValue;
  const int vlo = max(1, 1 - g0), vhi = min(XE - 1, XG - 1 - g0);
  if (vlo > vhi) return (int)cudaErrorInvalidValue;
  Args a = {b, fr, fb, r, bo, XE, Y2, Z, 0, vlo, vhi, 0, w_lo, w_hi,
            out_lo, w0, w1, w2, inv_den, {}};
  return launch(a, lay, T, 0, (cudaStream_t)stream);
}

// How many clusters of the launch shape `lay` (its k, ctas, threads and
// shared memory) the card holds at once at T, of the float32 kernel or
// (err) the error mode's (0: it refuses the cluster), into *clusters; a
// CUDA error code.
__attribute__((visibility("default"))) int pdemg_timeskew_clusters(
    const TimeskewLayout* lay, int T, int err, int* clusters) {
  if (!lay || T < 1 || T > 4 || (lay->k != 2 && lay->k != 4) ||
      lay->ctas < 1 || lay->ctas > kMaxCtas || lay->threads < 32 ||
      lay->threads > kMaxThreads || lay->smem_bytes < 0 ||
      lay->smem_bytes > kMaxDynSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const KernelFn fn = kernel_for(T, lay->k, err ? 1 : 0);
  if (!fn) return (int)cudaErrorInvalidValue;
  const cudaError_t e = opt_in(fn);
  if (e != cudaSuccess) return (int)e;
  TimeskewLayout L = *lay;
  L.bands = 1;
  L.chunks = 1;
  Launch l(L, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &l.cfg);
}

}  // extern "C"
