// Color-split red-black Gauss-Seidel for 3D wrap-storage levels (sm_90a).
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/relax.py:_pallas_split          (dense -> halves)
//   pde_multigrid_tpu/ops/pallas/relax.py:_pallas_merge          (halves -> dense)
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_slab_relax  (the sweeps)
//
// Layout ("halves"): a dense (X, Y, Z) float32 level is stored as two
// (X, Y/2, Z) arrays.  With q = (x + z) % 2, red (parity 0) lives at
// y = 2j + q and black at y = 2j + 1 - q, so every neighbour of a red
// point is black and vice versa: a half-sweep computes exactly the points
// it updates.
//
// What bounds these kernels on the card: device-memory traffic.  A
// half-sweep reads the updated color (4 B), its RHS half (4 B) and the
// other color's seven neighbours, which the L1/L2 caches serve from one
// streamed read (4 B), and writes 4 B: about 16 B per updated point for
// one flop-light 7-point update.  split/merge move 8 B per dense point.
// The simple design: one thread per output point, consecutive threads on
// consecutive z (coalesced loads and stores), neighbours read straight
// from global memory and left to the caches, one launch per half-sweep.
// No tiling in shared memory and no sweeps fused per launch yet: the TPU
// kernel's trapezoidal multi-sweep slabs are the obvious next step.
//
// Wrap storage: stored plane 0 of each axis is the zero Dirichlet boundary
// for both ends, so neighbour indices wrap modulo the extent (the +1
// neighbour of x = X-1 is plane 0, which the masks never update).  The
// masks are those of relax.py:1117-1151: x >= 1 and z >= 1, red
// `j >= 1 || q == 1`, black `j >= 1 || q == 0`.
//
// Numerics: built with --fmad=false, so every product and sum rounds on
// its own exactly as the plain PyTorch version (ops/cuda/relax.py) does;
// the two agree bit for bit.
//
// The error-equation leg (error_leg_kernel) replaces
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_resident_sweeps
// on every defect level whose four halves the card's shared memory holds
// (128^3 and below; ops/cuda/relax.py error_leg_layout): the inner
// smoother of the bf16 defect correction (ops/cuda/defect.py), nu
// red-black sweeps of A e = r from e = 0 on bf16 halves, computed in
// float32 with Poisson.split_update_folded, each write `ok ? upd : 0`
// (masked-off error points are identically zero, so the old value is
// never read).  The larger levels take the same function T sweeps a launch
// on the wavefront's clusters (csrc/timeskew.cu, error mode).  The
// port's first form, one launch per half-sweep (error_half_sweep_kernel:
// a thread on two consecutive z points from bf16x2 loads, rows launched
// as blockIdx.y = j, blockIdx.z = x, the first red half-sweep reading no
// black half), stays for the even levels that fit neither
// (ops/cuda/relax.py error_form: 1024^3, whose half-plane row the
// wavefront's tile cannot hold, or Z % 4 != 0 past the leg's shared
// memory); no bench row has such a level.
//
// What bounds it.  A leg reads rr, rb once and writes er, eb once (8 B a
// halves point: 8 MB at 128^3, 2.5 us at 3.35 TB/s), and does 8 float32
// operations an updated point a half-sweep (3 pair sums, 2 sums, 2
// products, the select: 1.7e9 for a 100-sweep leg at 128^3, 25 us at
// 67 TFLOP/s).  So the operations bound it, and in practice the
// dependent half-sweeps: the chain of one launch per half-sweep this
// replaces paid a launch and a pass over device memory each (6.5 us a
// half-sweep at 128^3 against a 1.9 us byte bound).
//
// Design: the TPU kernel's own form, one launch per leg with all four
// halves on chip.  They do not fit one CTA or one 16-CTA cluster at
// 128^3 (8 MB), so the grid is co-resident, at most one CTA an SM: the
// halves are cut into blocks of up to 4 x planes by `rows` whole j rows
// (every z), one a CTA (128^3: 32 x 4 blocks of 4 planes by 16 rows, 128
// CTAs of 1024 threads).  Thread (r, zz) owns the z pair (2 zz, 2 zz + 1)
// of row r on every plane of its block and keeps that column of er and
// eb in registers, so its x neighbours inside the block cost no load;
// shared memory holds the block's er and eb (the y and z neighbours,
// other threads' words), with a halo row either side of each plane's
// rows where the j neighbours' face words land, and its rr and rb.  Each colour phase covers the
// whole level before the other colour starts (the TPU kernel's global
// red -> black order): one block barrier a half-sweep, and no grid-wide
// one.  The four faces a block shares with its x and j neighbours go
// through device memory as one 8-byte word a z pair, epoch (the
// half-sweep that wrote it, + 1) in the high half and the pair's bf16
// bits in the low one (st.relaxed.gpu: a word arrives whole, so no fence
// and no separate flag); a thread waits for just the words it reads, by
// their epoch (ld.relaxed.gpu, coherent past the L1).  A block computes
// its faces first, so their words go out early in the half-sweep, then
// its interior.  A word is rewritten two half-sweeps later, only after
// the writer has read the word its reader wrote in between, so no slot
// is overwritten before it is read.  At the end every CTA writes its
// columns, meets the others at one barrier on two counters, and zeroes
// its outbox; the last CTA through the barrier zeroes the counters.  So
// outboxes and counters are 0 whenever no leg runs, and a replayed CUDA
// graph starts clean.  The launch is cooperative
// (cudaLaunchAttributeCooperative): CUDA checks that the grid is
// co-resident, and a grid it cannot co-schedule fails to launch (the
// wrapper raises) rather than deadlocking.  The spacing form of the
// update (isotropic or not) is a template flag.  Plane 0 of each half is
// always written 0, so the x wrap of plane X - 1 reads zero, as does the
// j wrap of row Y/2 - 1 (its partner is a y = 0 point); the z wrap stays
// inside a row.  bf16 conversions go only through exact widening and
// __floats2bfloat162_rn (round to nearest even, as torch's
// .to(bfloat16)), each half-sweep's result rounded before any neighbour
// reads it, so the leg is bitwise relax.error_sweeps_plain.  On the card
// (PERF.md; scripts/probe_error_leg.py splits the time) a 100-sweep leg
// at 128^3 takes 0.60 ms, ~3 us a half-sweep, against 1.29 for the
// half-sweep chain; one flag a CTA behind a fence, and slabs of one plane
// a CTA, were slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "stencil.cuh"  // split_update, folded_update, row_grid, row_block

namespace {

constexpr int kThreads = 256;

__global__ void split_kernel(const float* __restrict__ v,
                             float* __restrict__ r, float* __restrict__ b,
                             int X, int Y2, int Z) {
  const long long n = (long long)X * Y2 * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % Z);
  const long long xj = i / Z;
  const int j = (int)(xj % Y2);
  const int x = (int)(xj / Y2);
  const int q = (x + z) & 1;
  const long long row = ((long long)x * (2 * Y2) + 2 * j) * Z + z;
  if (r) r[i] = v[row + (long long)q * Z];  // null: the black half only
  b[i] = v[row + (long long)(1 - q) * Z];
}

__global__ void merge_kernel(const float* __restrict__ r,
                             const float* __restrict__ b,
                             float* __restrict__ v, int X, int Y2, int Z) {
  const long long n = (long long)X * Y2 * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % Z);
  const long long xj = i / Z;
  const int j = (int)(xj % Y2);
  const int x = (int)(xj / Y2);
  const int q = (x + z) & 1;
  const long long row = ((long long)x * (2 * Y2) + 2 * j) * Z + z;
  v[row + (long long)q * Z] = r[i];
  v[row + (long long)(1 - q) * Z] = b[i];
}

// One half-sweep: u (the color being updated) in place from w (the other
// color) and fu (u's RHS half).  color 0 = red, 1 = black.
__global__ void half_sweep_kernel(float* __restrict__ u,
                                  const float* __restrict__ w,
                                  const float* __restrict__ fu,
                                  int X, int Y2, int Z, int color,
                                  float w0, float w1, float w2,
                                  float inv_den) {
  const long long n = (long long)X * Y2 * Z;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int z = (int)(i % Z);
  const long long xj = i / Z;
  const int j = (int)(xj % Y2);
  const int x = (int)(xj / Y2);
  const int q = (x + z) & 1;

  const long long plane = (long long)Y2 * Z;
  const int xm = (x == 0) ? X - 1 : x - 1;
  const int xp = (x == X - 1) ? 0 : x + 1;
  const int jm = (j == 0) ? Y2 - 1 : j - 1;
  const int jp = (j == Y2 - 1) ? 0 : j + 1;
  const int zm = (z == 0) ? Z - 1 : z - 1;
  const int zp = (z == Z - 1) ? 0 : z + 1;
  const long long base = (long long)x * plane + (long long)j * Z;

  // neighbour pair sums, in the TPU kernel's order (relax.py:1164-1176)
  const float p0 = w[(long long)xm * plane + (long long)j * Z + z] +
                   w[(long long)xp * plane + (long long)j * Z + z];
  // red: y-pair = w[j] + (q ? w[j+1] : w[j-1]); black: the mirror
  const int jo = (color == 0) ? (q ? jp : jm) : (q ? jm : jp);
  const float p1 = w[base + z] + w[(long long)x * plane + (long long)jo * Z + z];
  const float p2 = w[base + zm] + w[base + zp];

  const float upd = split_update(p0, p1, p2, fu[i], w0, w1, w2, inv_den);

  const bool jz_ok = (j >= 1) || (color == 0 ? q == 1 : q == 0);
  const float m = (x >= 1 && z >= 1 && jz_ok) ? 1.0f : 0.0f;
  const float old = u[i];
  u[i] = old + m * (upd - old);
}

__device__ __forceinline__ __nv_bfloat162 ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const __nv_bfloat162*>(p);
}

// One half-sweep of the error equation at the points z0 = 2t, z0 + 1 of
// row (x, j): eu (bf16, the color being updated) written from ew (bf16,
// the other color; not read when v_zero) and ru (bf16, eu's residual
// half).  Z is even, and every row starts 4-byte aligned.
__global__ void error_half_sweep_kernel(__nv_bfloat16* __restrict__ eu,
                                        const __nv_bfloat16* __restrict__ ew,
                                        const __nv_bfloat16* __restrict__ ru,
                                        int X, int Y2, int Z, int color,
                                        int v_zero, int iso, float a0,
                                        float a1, float a2, float inv_den) {
  const int z0 = 2 * (blockIdx.x * blockDim.x + threadIdx.x);  // row launch
  if (z0 >= Z) return;
  const int j = blockIdx.y;
  const int x = blockIdx.z;
  const int q0 = (x + z0) & 1;  // z0 + 1 has parity 1 - q0
  // red with q = 1 or black with q = 0: the point's y-pair partner row is
  // j + 1, and it never lies on the y = 0 boundary
  const bool up0 = (color == 0) == (q0 == 1);
  const long long plane = (long long)Y2 * Z;
  const long long i = (long long)x * plane + (long long)j * Z + z0;

  // pair sums in the f32 half-sweep's order; zero from e = 0
  float p0[2] = {0.0f, 0.0f}, p1[2] = {0.0f, 0.0f}, p2[2] = {0.0f, 0.0f};
  if (!v_zero) {
    const int xm = (x == 0) ? X - 1 : x - 1;
    const int xp = (x == X - 1) ? 0 : x + 1;
    const int jm = (j == 0) ? Y2 - 1 : j - 1;
    const int jp = (j == Y2 - 1) ? 0 : j + 1;
    const int zm = (z0 == 0) ? Z - 1 : z0 - 1;     // below z0
    const int zp = (z0 + 2 == Z) ? 0 : z0 + 2;      // above z0 + 1
    const long long row = i - z0;  // (x, j, 0)
    const long long jz = (long long)j * Z + z0;
    const __nv_bfloat162 c = ld2(ew + i);
    const __nv_bfloat162 a = ld2(ew + xm * plane + jz);
    const __nv_bfloat162 b = ld2(ew + xp * plane + jz);
    const __nv_bfloat162 yp = ld2(ew + x * plane + (long long)jp * Z + z0);
    const __nv_bfloat162 ym = ld2(ew + x * plane + (long long)jm * Z + z0);
    const float wzm = __bfloat162float(ew[row + zm]);
    const float wzp = __bfloat162float(ew[row + zp]);
    p0[0] = __low2float(a) + __low2float(b);
    p0[1] = __high2float(a) + __high2float(b);
    p1[0] = __low2float(c) + (up0 ? __low2float(yp) : __low2float(ym));
    p1[1] = __high2float(c) + (up0 ? __high2float(ym) : __high2float(yp));
    p2[0] = wzm + __high2float(c);
    p2[1] = __low2float(c) + wzp;
  }
  const __nv_bfloat162 r = ld2(ru + i);
  const float u0 = folded_update(p0[0], p1[0], p2[0], __low2float(r), iso,
                                 a0, a1, a2, inv_den);
  const float u1 = folded_update(p0[1], p1[1], p2[1], __high2float(r), iso,
                                 a0, a1, a2, inv_den);
  // masks: x >= 1, z >= 1, and red `j >= 1 or q == 1`, black
  // `j >= 1 or q == 0` (z0 + 1 >= 1 always)
  const bool ok0 = x >= 1 && z0 >= 1 && (j >= 1 || up0);
  const bool ok1 = x >= 1 && (j >= 1 || !up0);
  __nv_bfloat162 out;
  out.x = __float2bfloat16_rn(ok0 ? u0 : 0.0f);
  out.y = __float2bfloat16_rn(ok1 ? u1 : 0.0f);
  *reinterpret_cast<__nv_bfloat162*>(eu + i) = out;
}

// ops/cuda/relax.py ErrorLegLayout: the leg's launch geometry.  The
// halves are cut into blocks of `planes` x planes by `rows` j rows (every
// z), CTA c = bx * yblocks + by owning block (bx, by).
struct ErrorLegLayout {
  int ctas;        // CTAs, at most one an SM, co-resident
  int planes;      // x planes of a block (<= kLegMaxPlanes)
  int rows;        // j rows of a block
  int yblocks;     // blocks along j
  int threads;     // rows * Z / 2, rounded up to a warp
  int smem_bytes;  // dynamic shared memory per CTA
};

constexpr int kLegMaxThreads = 1024;
constexpr int kLegMaxSmem = 232448;  // 227 KB, the most one CTA may hold
constexpr int kLegMaxPlanes = 4;

struct LegArgs {
  __nv_bfloat16* er;
  __nv_bfloat16* eb;
  const __nv_bfloat16* rr;
  const __nv_bfloat16* rb;
  // the outboxes: per CTA and colour its four faces (the block's first
  // and last x planes, rows x Z / 2 words each, and its first and last j
  // rows, planes x Z / 2 words each), a word (epoch << 32 | a z pair's
  // bf16 bits) for each z pair of the face; all 0 at entry and exit
  unsigned long long* box;
  int* bar;  // the final barrier's two counters: 0 at entry and exit
  int X, Y2, Z, nsweeps;
  float a0, a1, a2, inv_den;
  ErrorLegLayout lay;
};

// Device-memory words seen by every SM (coherent at gpu scope, past the
// incoherent L1); 8 aligned bytes, so an epoch and its data arrive as one.
__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_word(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :
               : "l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// A whole leg of nsweeps red-black error sweeps from e = 0 (see the
// header).  Thread (r, zz) owns the z pair (2 zz, 2 zz + 1), one 32-bit
// word of bf16 bits, of row r of every plane of its CTA's block, and
// keeps that column's words of er and eb in registers: its x neighbours
// inside the block are its own registers.  Shared memory holds the
// block's er and eb, which the y and z neighbours read, each plane with
// a halo row before and after its rows (planes x (rows + 2) x Z / 2
// words; the j neighbours' face words land there, and where there is no
// neighbour they stay 0), then its rr and rb (planes x rows x Z / 2).
template <bool ISO>
__global__ void __launch_bounds__(kLegMaxThreads, 1)
    error_leg_kernel(const __grid_constant__ LegArgs a) {
  extern __shared__ __align__(16) unsigned smw[];
  const ErrorLegLayout& L = a.lay;
  const int Y2 = a.Y2, Zh = a.Z >> 1, PX = L.planes, JR = L.rows;
  const int Sw = Y2 * Zh, PW = JR * Zh, Bw = PX * PW;  // words
  const int HP = (JR + 2) * Zh, EW = PX * HP;  // a plane, a colour of e
  const int c = blockIdx.x, tid = threadIdx.x, YB = L.yblocks;
  const int bx = c / YB, by = c - (c / YB) * YB;
  const int x0 = bx * PX, np = min(PX, a.X - x0);
  const int j0 = by * JR, nr = min(JR, Y2 - j0);
  // the neighbour blocks (none past the level's edges, whose reads are of
  // zero or masked points: x planes 0 and the y = 0 points of j rows 0)
  const bool xl = bx > 0, xh = x0 + np < a.X, jl = by > 0, jh = j0 + nr < Y2;
  // outbox words: CTA cta, colour k, face f (0: first x plane, 1: last x
  // plane, 2: first j row, 3: last j row) at (cta * 2 + k) * FW + face(f)
  const int FW = 2 * PW + 2 * PX * Zh;
  auto face = [&](int f) { return f < 2 ? f * PW : 2 * PW + (f - 2) * PX * Zh; };

  const int zz = tid % Zh, r = tid / Zh, j = j0 + r;
  const bool active = r < nr;
  const int zzm = (zz == 0) ? Zh - 1 : zz - 1;  // its word holds z0 - 1
  const int zzp = (zz == Zh - 1) ? 0 : zz + 1;  // its word holds z0 + 2
  const int me = r * Zh + zz;                   // in a plane of the block
  const long long gme = (long long)x0 * Sw + (long long)j0 * Zh + me;
  // this thread's j face (a middle block has at least 2 rows: one side)
  const int jside = (r == 0 && jl) ? 1 : (r == nr - 1 && jh) ? 2 : 0;

  // this column's words of er and eb (0 past np)
  unsigned ew[2][kLegMaxPlanes];
#pragma unroll
  for (int p = 0; p < kLegMaxPlanes; ++p) ew[0][p] = ew[1][p] = 0u;
  {
    const unsigned* const rr = reinterpret_cast<const unsigned*>(a.rr);
    const unsigned* const rb = reinterpret_cast<const unsigned*>(a.rb);
    for (int i = tid; i < 2 * EW; i += blockDim.x) smw[i] = 0u;
    if (active) {
      for (int p = 0; p < np; ++p) {
        smw[2 * EW + p * PW + me] = __ldg(rr + gme + (long long)p * Sw);
        smw[2 * EW + Bw + p * PW + me] = __ldg(rb + gme + (long long)p * Sw);
      }
    }
  }
  __syncthreads();

  // one half-sweep h of colour COL
  auto half = [&](int h, auto colour) {
    constexpr int COL = decltype(colour)::value, OTH = COL ^ 1;
    if (!active) return;
    unsigned* const W = smw + OTH * EW;
    // the neighbours' words of the other colour, from their half-sweep
    // h - 1 (epoch h), wanted by this thread: x faces on the block's first
    // and last planes, a j face on every plane of an edge row; at h = 0
    // the other colour is still 0
    const bool poll = h > 0;
    const bool nxl = poll && xl, nxh = poll && xh, nj = poll && jside;
    const int oxl = ((c - YB) * 2 + OTH) * FW + face(1) + me;
    const int oxh = ((c + YB) * 2 + OTH) * FW + face(0) + me;
    const int oj = jside == 1 ? ((c - 1) * 2 + OTH) * FW + face(3) + zz
                              : ((c + 1) * 2 + OTH) * FW + face(2) + zz;
    unsigned long long wxl = 0, wxh = 0, wj[kLegMaxPlanes];
    if (nxl) wxl = ld_word(a.box + oxl);
    if (nxh) wxh = ld_word(a.box + oxh);
#pragma unroll
    for (int p = 0; p < kLegMaxPlanes; ++p) {
      wj[p] = (nj && p < np) ? ld_word(a.box + oj + p * Zh) : 0ull;
    }
    if (nxl || nxh || nj) {
      for (;;) {
        bool stale = (nxl && (unsigned)(wxl >> 32) != (unsigned)h) ||
                     (nxh && (unsigned)(wxh >> 32) != (unsigned)h);
#pragma unroll
        for (int p = 0; p < kLegMaxPlanes; ++p) {
          stale |= nj && p < np && (unsigned)(wj[p] >> 32) != (unsigned)h;
        }
        if (!stale) break;
        __nanosleep(32);
        if (nxl && (unsigned)(wxl >> 32) != (unsigned)h)
          wxl = ld_word(a.box + oxl);
        if (nxh && (unsigned)(wxh >> 32) != (unsigned)h)
          wxh = ld_word(a.box + oxh);
#pragma unroll
        for (int p = 0; p < kLegMaxPlanes; ++p) {
          if (nj && p < np && (unsigned)(wj[p] >> 32) != (unsigned)h)
            wj[p] = ld_word(a.box + oj + p * Zh);
        }
      }
    }
    // the j words into this thread's halo row, the x words kept
    if (nj) {
      unsigned* const halo = W + (jside == 1 ? 0 : nr + 1) * Zh + zz;
#pragma unroll
      for (int p = 0; p < kLegMaxPlanes; ++p) {
        if (p < np) halo[p * HP] = (unsigned)wj[p];
      }
    }
    const unsigned xlo = (unsigned)wxl, xhi = (unsigned)wxh;
    // the outbox words of this half-sweep (none after the last)
    const unsigned long long ep = (unsigned long long)(h + 1) << 32;
    const bool pub = h + 1 < 2 * a.nsweeps;
    const int own = (c * 2 + COL) * FW;

    // the update of plane p
    auto update = [&](int p) {
      const int x = x0 + p;
      const unsigned* const wr = W + p * HP + (r + 1) * Zh;  // the row
      // z0 is even, so q = (x + z0) % 2 = x % 2 (z0 + 1 has 1 - q); red
      // with q = 1 or black with q = 0: the point's y-pair partner row is
      // j + 1, and it never lies on the y = 0 boundary
      const bool up0 = (COL == 0) == ((x & 1) == 1);
      const unsigned cw = ew[OTH][p];
      const unsigned xa = p > 0 ? ew[OTH][p - 1] : xlo;
      const unsigned xb =
          p + 1 < kLegMaxPlanes && p < np - 1 ? ew[OTH][p + 1] : xhi;
      const unsigned ya = wr[zz - Zh], yb = wr[zz + Zh];
      const unsigned wm = wr[zzm], wp = wr[zzp];
      // pair sums in the f32 half-sweep's order
      const float p00 = bf_lo(xa) + bf_lo(xb);
      const float p01 = bf_hi(xa) + bf_hi(xb);
      const float p10 = bf_lo(cw) + (up0 ? bf_lo(yb) : bf_lo(ya));
      const float p11 = bf_hi(cw) + (up0 ? bf_hi(ya) : bf_hi(yb));
      const float p20 = bf_hi(wm) + bf_hi(cw);
      const float p21 = bf_lo(cw) + bf_lo(wp);
      const unsigned rv = smw[2 * EW + COL * Bw + p * PW + me];
      // the spacing form a template flag: no branch a point
      const float u0 = folded_update(p00, p10, p20, bf_lo(rv), ISO, a.a0,
                                     a.a1, a.a2, a.inv_den);
      const float u1 = folded_update(p01, p11, p21, bf_hi(rv), ISO, a.a0,
                                     a.a1, a.a2, a.inv_den);
      // masks: x >= 1, z >= 1, and red `j >= 1 or q == 1`, black
      // `j >= 1 or q == 0` (z0 + 1 >= 1 always)
      const bool ok0 = x >= 1 && zz >= 1 && (j >= 1 || up0);
      const bool ok1 = x >= 1 && (j >= 1 || !up0);
      const __nv_bfloat162 out =
          __floats2bfloat162_rn(ok0 ? u0 : 0.0f, ok1 ? u1 : 0.0f);
      const unsigned ow = *reinterpret_cast<const unsigned*>(&out);
      ew[COL][p] = ow;
      smw[COL * EW + p * HP + (r + 1) * Zh + zz] = ow;
      if (pub) {
        const unsigned long long w = ep | ow;
        if (p == 0 && xl) st_word(a.box + own + face(0) + me, w);
        if (p == np - 1 && xh) st_word(a.box + own + face(1) + me, w);
        if (jside) st_word(a.box + own + face(jside + 1) + p * Zh + zz, w);
      }
    };
    // the block's faces first (the planes and rows a neighbour reads:
    // their words go out early in the half-sweep, and the neighbours
    // wrote the ones read here early in theirs), then the interior
#pragma unroll
    for (int p = 0; p < kLegMaxPlanes; ++p) {
      if (p < np && (jside || (p == 0 && xl) || (p == np - 1 && xh)))
        update(p);
    }
#pragma unroll
    for (int p = 0; p < kLegMaxPlanes; ++p) {
      if (p < np && !(jside || (p == 0 && xl) || (p == np - 1 && xh)))
        update(p);
    }
  };

  for (int h = 0; h < 2 * a.nsweeps; h += 2) {
    half(h, std::integral_constant<int, 0>{});
    __syncthreads();  // the colour's block complete before it is read
    half(h + 1, std::integral_constant<int, 1>{});
    __syncthreads();
  }
  // the leg's result: this column's words of both colours
  if (active) {
    unsigned* const er = reinterpret_cast<unsigned*>(a.er);
    unsigned* const eb = reinterpret_cast<unsigned*>(a.eb);
#pragma unroll
    for (int p = 0; p < kLegMaxPlanes; ++p) {
      if (p < np) {
        er[gme + (long long)p * Sw] = ew[0][p];
        eb[gme + (long long)p * Sw] = ew[1][p];
      }
    }
  }
  // one barrier (every CTA past its last read of an outbox), then the
  // outboxes and the counters back to 0 for the next launch
  __syncthreads();
  if (tid == 0) {
    atomicAdd(a.bar, 1);
    while (ld_acquire(a.bar) < L.ctas) {
    }
  }
  __syncthreads();
  for (int k = tid; k < 2 * FW; k += blockDim.x) a.box[c * 2 * FW + k] = 0ull;
  if (tid == 0 && atomicAdd(a.bar + 1, 1) == L.ctas - 1) {
    a.bar[0] = 0;  // the last one through: every CTA has left the wait
    a.bar[1] = 0;
  }
}

bool leg_valid(const ErrorLegLayout& L, int X, int Y2, int Z) {
  if (X < 1 || Y2 < 1 || Z < 2 || Z % 2) return false;
  const int Zh = Z / 2;
  if (L.planes < 1 || L.planes > kLegMaxPlanes || L.rows < 1 ||
      L.rows > Y2 || (long long)L.rows * Zh > kLegMaxThreads) {
    return false;
  }
  if (L.yblocks != (Y2 + L.rows - 1) / L.rows) return false;
  if (L.ctas != (X + L.planes - 1) / L.planes * L.yblocks) return false;
  if (L.threads != (L.rows * Zh + 31) / 32 * 32) return false;
  // a middle block of one row would face both ways
  if (L.yblocks > 1 && L.rows < 2) return false;
  // er, eb with their halo rows, rr, rb
  const long long smem = 8LL * L.planes * Z * (L.rows + 1);
  return L.smem_bytes == smem && smem <= kLegMaxSmem;
}

inline unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int pdemg_split(const float* v, float* r, float* b, int X, int Y2, int Z,
                void* stream) {
  const long long n = (long long)X * Y2 * Z;
  split_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      v, r, b, X, Y2, Z);
  return (int)cudaGetLastError();
}

int pdemg_merge(const float* r, const float* b, float* v, int X, int Y2,
                int Z, void* stream) {
  const long long n = (long long)X * Y2 * Z;
  merge_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      r, b, v, X, Y2, Z);
  return (int)cudaGetLastError();
}

int pdemg_half_sweep(float* u, const float* w, const float* fu, int X,
                     int Y2, int Z, int color, float w0, float w1, float w2,
                     float inv_den, void* stream) {
  const long long n = (long long)X * Y2 * Z;
  half_sweep_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      u, w, fu, X, Y2, Z, color, w0, w1, w2, inv_den);
  return (int)cudaGetLastError();
}

int pdemg_error_half_sweep(__nv_bfloat16* eu, const __nv_bfloat16* ew,
                           const __nv_bfloat16* ru, int X, int Y2, int Z,
                           int color, int v_zero, int iso, float a0,
                           float a1, float a2, float inv_den, void* stream) {
  if (!row_launch_ok(X, Y2) || Z % 2) {
    return (int)cudaErrorInvalidConfiguration;
  }
  // one thread per two points of a row
  error_half_sweep_kernel<<<row_grid(X, Y2, Z / 2), row_block(Z / 2), 0,
                            (cudaStream_t)stream>>>(
      eu, ew, ru, X, Y2, Z, color, v_zero, iso, a0, a1, a2, inv_den);
  return (int)cudaGetLastError();
}

// (er, eb) = nsweeps red-black sweeps of the error equation from e = 0 on
// the bf16 residual halves (rr, rb), one cooperative launch on the layout
// `lay` (relax.error_leg_layout); box: lay->ctas * 2 * (rows + planes) * Z
// words and bar: 2 ints, all 0 (and left 0).  Default visibility spelled out: the
// host compiler hides a function whose body launches a kernel taking a
// type of this file's unnamed namespace.
__attribute__((visibility("default"))) int pdemg_error_leg(
    const ErrorLegLayout* lay, __nv_bfloat16* er, __nv_bfloat16* eb,
    const __nv_bfloat16* rr, const __nv_bfloat16* rb,
    unsigned long long* box, int* bar, int X, int Y2, int Z, int nsweeps,
    int iso, float a0, float a1, float a2, float inv_den, void* stream) {
  if (!lay || !box || !bar || nsweeps < 1 || !leg_valid(*lay, X, Y2, Z)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[4] = {er, eb, rr, rb};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 4) return (int)cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(box) % 8) return (int)cudaErrorInvalidValue;
  LegArgs args = {er, eb, rr, rb, box, bar, X, Y2, Z, nsweeps,
                  a0, a1, a2, inv_den, *lay};
  void (*const kernel)(LegArgs) =
      iso ? error_leg_kernel<true> : error_leg_kernel<false>;
  static bool opted[2] = {false, false};  // once each, outside any capture
  if (!opted[iso != 0]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLegMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted[iso != 0] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(lay->ctas, 1, 1);
  cfg.blockDim = dim3(lay->threads, 1, 1);
  cfg.dynamicSmemBytes = lay->smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
