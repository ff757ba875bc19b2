// Dense red-black Gauss-Seidel on a 2D level too large for the dense leg
// kernel (csrc/resident.cu), in 2D tiles with a 2T-point halo (sm_90a), for
// the HJB minimum-time equation (upwind scheme) and for 2D Poisson: one
// template on the stencil (`Op`: hjb2d.cuh's HJBOp, poisson2d.cuh's
// PoissonOp).
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_slab_relax
// on the HJB path (the 513^2 finest level of the bench's hjb2d row) and on
// the 2D Poisson wrap-storage levels 4096^2, 2048^2 and 1024^2 (JAX's plan)
// and 512^2 (the dense leg's capacity gate: no cluster holds it).  The
// Pallas kernel walks full-row axis-0 slabs with a 2T-row trapezoid halo,
// a layout that follows the TPU's (8, 128) tiling and DMA alignment.  Here
// the level is cut into 2D tiles (ops/cuda/slab2d.py `slab_layout` picks
// every number), one CTA each: 513^2 in 16 x 8 tiles of 32 x 64 owned
// points (the last tile of each axis also owns the level's last row or
// column), 128 CTAs for 132 SMs.  A CTA loads its tile with a halo of H =
// 2T points on every side (clipped at the level's edge) and relaxes the
// whole loaded region, holding its edge: a stale value spreads one point
// inward per half-sweep, so after T sweeps the owned points, 2T from any
// cut edge, are exact (the Pallas kernel's argument, relax.py:342-348).
//
// The update reads both x neighbours, both y neighbours and f, HJB's also
// four coefficients of the point's column (hjb2d.cuh); red are the points
// with x + y even, and a colour's points read the other colour alone.  Per
// point and half-sweep of its colour 15 float operations (Poisson 7 and
// the blend's 2); v, f and a mask byte read once and v written once, 13 B
// a point (Poisson 12: no mask).
// Wrap storage (Poisson): the tiles cut the logical X x Y level whose row
// X - 1 and column Y - 1 are stored row and column 0, the boundary both
// ends share (resident.cu's header); a tile loads them from there and no
// tile writes them.  What bounds it on the card: not
// bytes (513^2 moves 3.4 MB, 1 us at 3.35 TB/s) but each half-sweep's
// chain of dependent shared loads and products and its block barrier.
//
// Design (csrc/resident.cu's HJB leg, on tiles):
//   * Columns in registers.  A thread owns the column y of a segment of L
//     rows of the loaded region (L a template instance): its f, the
//     update-mask bit of each of its rows and its column's four
//     coefficients, in registers with compile-time indices for the whole
//     launch, and its values, which it also keeps in shared memory.  Its
//     register rows start on a parity chosen so that red sits at even
//     register rows; a point's update is two shared loads (the y
//     neighbours, on the lanes beside it) and one shared store; before each
//     half-sweep a thread reloads the two rows past its segment that the
//     other segments wrote.  A warp's lanes are consecutive columns and the
//     row stride is even, so each shared access of a warp hits 32 banks.
//   * The whole leg in one launch (`leg`): the tiles' CTAs are co-resident
//     (a cooperative launch, one CTA an SM), and in place of a launch every
//     T sweeps each CTA refreshes its halo.  It publishes its owned edge
//     strips, H deep (the top and bottom H rows and the first and last H
//     columns of its owned points, on the sides that have a neighbour),
//     into its outbox in device memory, one 8-byte word a point (epoch <<
//     32 | the float's bits) written by st.relaxed.gpu, so a word arrives
//     whole and no fence or flag is needed; then it requests the words of
//     its halo from the at most 8 neighbours' outboxes (ld.relaxed.gpu,
//     coherent past the L1), a batch of kHaloBatch a thread before it waits
//     for any, and reads again until each carries the refresh's epoch.
//     Which points go where is listed once a launch, in a table in shared
//     memory after the tile (`build_table`), so a refresh does no index
//     arithmetic.
//     Outboxes come in two parities used in turns: a CTA rewrites a parity
//     two refreshes later, after it took its neighbours' words of the
//     refresh between, which each sent only after taking its own.  The
//     epoch is (launch << 8 | refresh + 1), the launch from a counter in
//     device memory that the last CTA to finish increments: words of an
//     earlier launch never match, the outboxes need no clearing, and a
//     replayed CUDA graph counts on (csrc/masked_block.cu's exchange).
//   * A level whose tiles the card cannot hold co-resident (1025^2 and
//     up) takes at most T sweeps a launch from one buffer into another (no
//     outbox), the wrapper chaining the launches.
// On an H100 (PERF.md, Findings) a 30-sweep leg at 513^2 in one launch
// takes less than half the time of the 8 launches of T = 4 sweeps that
// were its first form, and two thirds of the same kernel at T sweeps a
// launch.
// Each launch reads `src` and writes the owned points of every tile into
// `dst`, a separate array (a tile reads its halo from its neighbours'
// owned points at the start).
//
// Update form: v + m * (kernel_update - v) with m = 1 on the update mask
// (HJB: the interior without the pinned target ball; Poisson: the
// interior); points off the colour or the mask are never written.  Built
// with --fmad=false, in the plain version's operation order (hjb2d.cuh,
// poisson2d.cuh): bitwise equal to it for any nsweeps and T.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hjb2d.cuh"      // HJB2D, HJBOp
#include "poisson2d.cuh"  // Poisson2D, PoissonOp

// The layout of a launch (slab2d.HJBSlabLayout fills it in).
struct HJBSlab {
  int X, Y;        // the level (logical: wrap storage holds X - 1 by Y - 1)
  int ntx, nty;    // tiles along x and y, one CTA each, tile (tx, ty) the
                   // CTA tx nty + ty
  int BX, BY;      // rows and columns a tile owns; the last tile of each
                   // axis also owns the rest of the level
  int T;           // sweeps between halo refreshes (the leg), or the most
                   // a launch takes
  int H;           // halo points each side: 2T
  int G;           // row segments of a tile's loaded rows
  int L;           // rows a segment: a template instance
  int NC;          // threads a segment: the widest tile's inner loaded
                   // columns, rounded up to a warp
  int S;           // the tile's row stride in shared memory: NC + 2
  int rows;        // the tile's rows in shared memory: G L + 4
  int threads;     // G NC
  int smem_bytes;  // 4 rows S, and 8 bytes an entry of a leg's refresh
                   // table
  int leg;         // 1: a whole leg in one cooperative launch, halos
                   // refreshed through device memory; 0: at most T sweeps
  int wrap;        // 1: wrap storage, row / column X - 1 / Y - 1 read from
                   // stored row / column 0 and never written
};

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // 227 KB, the most one CTA may hold
constexpr int kHaloBatch = 4;     // halo words a thread has in flight
constexpr int kMaxRefresh = 254;  // refreshes a launch: the epoch's byte

// Device-memory words seen by every SM (gpu scope, past the incoherent
// L1); 8 aligned bytes, so an epoch and its data arrive as one.
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
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_count(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// A tile's owned and loaded points, from its CTA.
struct Tile {
  int tx, ty;
  int xo, xo_end, yo, yo_end;  // owned: [xo, xo_end) x [yo, yo_end)
  int xs, xe, ys, ye;          // loaded: [xs, xe) x [ys, ye)
};

__device__ __forceinline__ Tile tile_of(const HJBSlab& g, int cta) {
  Tile t;
  t.tx = cta / g.nty;
  t.ty = cta - t.tx * g.nty;
  t.xo = t.tx * g.BX;
  t.xo_end = t.tx + 1 == g.ntx ? g.X : t.xo + g.BX;
  t.yo = t.ty * g.BY;
  t.yo_end = t.ty + 1 == g.nty ? g.Y : t.yo + g.BY;
  t.xs = max(0, t.xo - g.H);
  t.xe = min(g.X, t.xo_end + g.H);
  t.ys = max(0, t.yo - g.H);
  t.ye = min(g.Y, t.yo_end + g.H);
  return t;
}

// Outbox words of one CTA at one parity: its top and bottom strips (H rows
// by the widest tile's WY owned columns), then its left and right strips
// (the tallest tile's WX owned rows by H columns).
__host__ __device__ __forceinline__ int face_words(const HJBSlab& g) {
  const int WX = g.X - (g.ntx - 1) * g.BX;
  const int WY = g.Y - (g.nty - 1) * g.BY;
  return 2 * g.H * WY + 2 * WX * g.H;
}

// Entries of a leg's refresh table, in shared memory after the tile (none
// without outboxes): entry i < FW the i-th point the CTA publishes, entry
// FW + i its i-th halo point, each (shared index, word).  A CTA has at most
// the widest loaded region less the smallest owned one (BX x BY) as halo.
__host__ __device__ __forceinline__ int table_entries(const HJBSlab& g) {
  if (!g.leg || g.ntx * g.nty == 1) return 0;
  const int WX = g.X - (g.ntx - 1) * g.BX;
  const int WY = g.Y - (g.nty - 1) * g.BY;
  const int LX = min(WX + 2 * g.H, g.X), LY = min(WY + 2 * g.H, g.Y);
  return face_words(g) + LX * LY - g.BX * g.BY;
}

// This CTA's number, read anew at each use: a tile's bounds are derived
// where they are used rather than held in registers for the whole launch.
__device__ __forceinline__ int cta_id() {
  int c;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(c));
  return c;
}

// Shared row of global row x: two guard rows before the loaded first.
__device__ __forceinline__ int srow(int x, int xs) { return x - xs + 2; }

// Calls fn(k, c, entry) for each point (x0 + k, y0 + c) of an nr x nc
// rectangle, entry = base + k nc + c: warps along rows, lanes along
// columns, no division.
template <typename F>
__device__ __forceinline__ void for_rect(int nr, int nc, int base, F&& fn) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < nr; k += nw) {
    for (int c = lane; c < nc; c += 32) fn(k, c, base + k * nc + c);
  }
}

// A leg's refresh table of this CTA (the tile's shared indices of its
// points and their words): entries 0 .. npub - 1 the points it publishes,
// its top and bottom strips (H rows by its owned columns) and its left and
// right strips (its owned rows by H columns), each where it has a
// neighbour on that side, at word (side's offset) + (row) W + (column) in
// its outbox (W the strip's width: WY, or H); entries FW .. FW + nhalo - 1
// its halo points, each at its word in the outbox of the neighbour that
// owns it, counted from the outboxes' start at one parity (CTA c's at c 2
// FW): above and below its owned rows a point lies in the bottom or top
// strip of the tile above or below (corners included), beside them in
// the right or left strip of the tile to the left or right.  Returns
// npub; nhalo is the loaded points less the owned ones.
__device__ __forceinline__ int build_table(const HJBSlab& g, const Tile& t,
                                           int S, int FW, int2* tab) {
  const int H = g.H;
  const int OX = t.xo_end - t.xo, OY = t.yo_end - t.yo;
  const int WX = g.X - (g.ntx - 1) * g.BX;
  const int WY = g.Y - (g.nty - 1) * g.BY;
  auto at = [&](int x, int y) { return srow(x, t.xs) * S + (y - t.ys); };
  int n = 0;  // the published points so far
  if (t.tx > 0) {  // top strip
    for_rect(H, OY, n, [&](int k, int c, int e) {
      tab[e] = make_int2(at(t.xo + k, t.yo + c), k * WY + c);
    });
    n += H * OY;
  }
  if (t.tx + 1 < g.ntx) {  // bottom strip
    for_rect(H, OY, n, [&](int k, int c, int e) {
      tab[e] = make_int2(at(t.xo_end - H + k, t.yo + c), (H + k) * WY + c);
    });
    n += H * OY;
  }
  if (t.ty > 0) {  // left strip
    for_rect(OX, H, n, [&](int k, int c, int e) {
      tab[e] = make_int2(at(t.xo + k, t.yo + c), 2 * H * WY + k * H + c);
    });
    n += OX * H;
  }
  if (t.ty + 1 < g.nty) {  // right strip
    for_rect(OX, H, n, [&](int k, int c, int e) {
      tab[e] = make_int2(at(t.xo + k, t.yo_end - H + c),
                         2 * H * WY + WX * H + k * H + c);
    });
    n += OX * H;
  }
  const int LY = t.ye - t.ys;
  // the tile owning column y of this tile row: its index and first column
  auto owner = [&](int y) {
    return y < t.yo ? t.ty - 1 : (y >= t.yo_end ? t.ty + 1 : t.ty);
  };
  int m = FW;  // the halo points' entries
  const int above = t.xo - t.xs, below = t.xe - t.xo_end;
  for_rect(above, LY, m, [&](int k, int c, int e) {  // bottom strips above
    const int y = t.ys + c, ty = owner(y);
    tab[e] = make_int2(at(t.xs + k, y),
                       ((t.tx - 1) * g.nty + ty) * 2 * FW + H * WY +
                           (t.xs + k - (t.xo - H)) * WY + y - ty * g.BY);
  });
  m += above * LY;
  for_rect(below, LY, m, [&](int k, int c, int e) {  // top strips below
    const int y = t.ys + c, ty = owner(y);
    tab[e] = make_int2(at(t.xo_end + k, y),
                       ((t.tx + 1) * g.nty + ty) * 2 * FW + k * WY + y -
                           ty * g.BY);
  });
  m += below * LY;
  const int left = t.yo - t.ys, right = t.ye - t.yo_end;
  const int row = t.tx * g.nty;
  for_rect(OX, left, m, [&](int k, int c, int e) {  // right strip, left
    tab[e] = make_int2(at(t.xo + k, t.ys + c),
                       (row + t.ty - 1) * 2 * FW + 2 * H * WY + WX * H +
                           k * H + t.ys + c - (t.yo - H));
  });
  m += OX * left;
  for_rect(OX, right, m, [&](int k, int c, int e) {  // left strip, right
    tab[e] = make_int2(at(t.xo + k, t.yo_end + c),
                       (row + t.ty + 1) * 2 * FW + 2 * H * WY + k * H + c);
  });
  return n;
}

template <int L, class Op>
__global__ void __launch_bounds__(kMaxThreads, 1)
    slab2d_kernel(const float* __restrict__ src, float* __restrict__ dst,
                  const float* __restrict__ f, int nsweeps, HJBSlab g,
                  typename Op::Params p, unsigned long long* box,
                  unsigned* count) {
  extern __shared__ float sv[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int S = g.S;
  const int Xs = g.X - g.wrap, Ys = g.Y - g.wrap;  // the stored extents
  // this launch's number: read by every CTA before the last one finishes
  const unsigned launch = box ? ld_count(count) : 0u;

  // this thread's column (an inner column of the loaded region) and
  // segment; its register rows r = 0 .. L + 2 are the rows xr0 + r, with
  // xr0 + y even: red at even r, kept in shared memory from b
  float* b;
  Op op;  // the column's coefficients
  // bit r: the thread updates row xr0 + r (its segment, strictly inside
  // the loaded rows, on the mask)
  unsigned long long bits = 0;
  float fr[L + 3];
  // the refresh's table and the CTA's published and halo points
  const int FW = face_words(g);
  int2* const tab = reinterpret_cast<int2*>(sv + g.rows * S);
  int npub = 0, nhalo = 0;
  {
    const Tile t = tile_of(g, cta_id());
    const int LY = t.ye - t.ys;
    // the tile: zeros, then the loaded points
    for (int i = tid; i < g.rows * S; i += nt) sv[i] = 0.0f;
    __syncthreads();
    const int nload = (t.xe - t.xs) * LY;
    for (int i = tid; i < nload; i += nt) {
      const int k = i / LY;
      const int y = i - k * LY;
      const int x = t.xs + k, yy = t.ys + y;
      sv[(k + 2) * S + y] =
          src[(long long)(x < Xs ? x : 0) * Ys + (yy < Ys ? yy : 0)];
    }
    const int seg = tid / g.NC;
    const int y = t.ys + 1 + tid - seg * g.NC;
    const bool col = y <= t.ye - 2;
    const int seg0 = t.xs + seg * L;
    const int seg1 = min(seg0 + L, t.xe);
    const int xr0 = seg0 - 1 - ((seg0 - 1 + y) & 1);
    b = sv + srow(xr0, t.xs) * S + (y - t.ys);
    op.column(p, col ? y : 0);
    // every load issued before any is used; an updated point is never on
    // row X - 1 or column Y - 1, so it is stored at x Ys + y
    uint8_t mk[L + 3];
#pragma unroll
    for (int r = 0; r < L + 3; ++r) {
      const int x = xr0 + r;
      const bool in =
          col && x >= seg0 && x < seg1 && x > t.xs && x < t.xe - 1;
      const long long gi = in ? (long long)x * Ys + y : 0;
      mk[r] = in ? op.keep(p, x, y, gi) : 0;
      fr[r] = f[gi];
    }
#pragma unroll
    for (int r = 0; r < L + 3; ++r) {
      if (mk[r]) bits |= 1ull << r;
    }
    if (box) {  // the refresh's table, built once
      npub = build_table(g, t, S, FW, tab);
      nhalo = (t.xe - t.xs) * LY - (t.xo_end - t.xo) * (t.yo_end - t.yo);
    }
  }
  __syncthreads();

  float vr[L + 3];
#pragma unroll
  for (int r = 0; r < L + 3; ++r) vr[r] = b[r * S];

  // without outboxes (one tile, or at most T sweeps a launch) the launch
  // is one chunk
  const int T = box ? g.T : max(nsweeps, 1);
  const int nchunks = (nsweeps + T - 1) / T;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int tc = min(T, nsweeps - ch * T);
    for (int s = 0; s < tc; ++s) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (g.G > 1) {
          // the rows past the segment of the other colour, which the
          // segments beside it wrote: a segment holds L rows, so they sit
          // at fixed register rows
          vr[1 - c] = b[(1 - c) * S];
          vr[L + 1 + c] = b[(L + 1 + c) * S];
        }
        // the y neighbours of this colour's rows r = 2 i + 2 - c <= L + 1,
        // all loaded before any store: a store may not pass a load the
        // compiler cannot prove apart
        constexpr int NR = L / 2 + 1;
        const int nr = L / 2 + c;
        float nn[NR], ss[NR];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (i >= nr) break;
          const int r = 2 * i + 2 - c;
          nn[i] = b[r * S + 1];
          ss[i] = b[r * S - 1];
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (i >= nr) break;
          const int r = 2 * i + 2 - c;
          const float upd =
              op.update(p, vr[r + 1], vr[r - 1], nn[i], ss[i], fr[r]);
          const float old = vr[r];
          // m = 1: v + m * (upd - v); off the mask the point stays
          vr[r] = (bits >> r) & 1ull ? old + (upd - old) : old;
        }
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (i >= nr) break;
          const int r = 2 * i + 2 - c;
          if ((bits >> r) & 1ull) b[r * S] = vr[r];
        }
        __syncthreads();  // this colour done before the other reads it
      }
    }
    if (ch + 1 < nchunks) {
      // the halo refresh at parity ch & 1: the owned strips, exact after
      // the chunk, out with epoch ch + 1; the halo's words in
      const unsigned epoch = (launch << 8) | (unsigned)(ch + 1);
      const unsigned long long tag = (unsigned long long)epoch << 32;
      unsigned long long* const mine = box + (cta_id() * 2 + (ch & 1)) * FW;
      for (int i = tid; i < npub; i += nt) {
        const int2 e = tab[i];
        st_word(mine + e.y, tag | __float_as_uint(sv[e.x]));
      }
      const unsigned long long* const in = box + (ch & 1) * FW;
      for (int i0 = tid; i0 < nhalo; i0 += kHaloBatch * nt) {
        int2 e[kHaloBatch];
        unsigned long long w[kHaloBatch];
#pragma unroll
        for (int k = 0; k < kHaloBatch; ++k) {
          if (i0 + k * nt < nhalo) {
            e[k] = tab[FW + i0 + k * nt];
            w[k] = ld_word(in + e[k].y);
          }
        }
#pragma unroll
        for (int k = 0; k < kHaloBatch; ++k) {
          if (i0 + k * nt < nhalo) {
            while ((unsigned)(w[k] >> 32) != epoch) {
              __nanosleep(32);
              w[k] = ld_word(in + e[k].y);
            }
            sv[e[k].x] = __uint_as_float((unsigned)w[k]);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < L + 3; ++r) vr[r] = b[r * S];
    }
  }

  // the owned points, every one of them (dst is a whole new level; wrap:
  // row X - 1 and column Y - 1 are stored row and column 0, which their
  // owner writes)
  const Tile t = tile_of(g, cta_id());
  const int OX = t.xo_end - t.xo, OY = t.yo_end - t.yo;
  for (int i = tid; i < OX * OY; i += nt) {
    const int k = i / OY;
    const int yy = i - k * OY;
    const int x = t.xo + k, y = t.yo + yy;
    if (x < Xs && y < Ys) {
      dst[(long long)x * Ys + y] = sv[srow(x, t.xs) * S + y - t.ys];
    }
  }
  // every CTA past its last read of an outbox before the launch number
  // moves on
  if (box) {
    __syncthreads();
    if (tid == 0 && atomicAdd(count + 1, 1u) == gridDim.x - 1) {
      atomicExch(count + 1, 0u);  // the last one through
      atomicAdd(count, 1u);
    }
  }
}

// The layout as slab2d.slab_layout derives it: tiles that cover the level,
// each owning at least H rows and columns (its halo lies in its
// neighbours), the widest tile's loaded region in G segments of L rows by
// NC columns, within a CTA's threads and shared memory.
bool valid(const HJBSlab& g) {
  if (g.X < 3 || g.Y < 3 || g.ntx < 1 || g.nty < 1 || g.T < 1 ||
      g.H != 2 * g.T || g.BX < 1 || g.BY < 1) {
    return false;
  }
  if ((g.ntx > 1 && g.BX < g.H) || (g.nty > 1 && g.BY < g.H)) return false;
  const int WX = g.X - (g.ntx - 1) * g.BX;
  const int WY = g.Y - (g.nty - 1) * g.BY;
  if (WX < g.BX || WY < g.BY) return false;
  // the most rows and columns a tile loads
  const int LX = min(WX + 2 * g.H, g.X);
  const int LY = min(WY + 2 * g.H, g.Y);
  if (g.G < 1 || g.G * g.L < LX || (g.G - 1) * g.L >= LX) return false;
  if (g.NC < LY - 2 || g.NC % 32 || g.S < g.NC + 2 || g.S % 2 ||
      g.rows != g.G * g.L + 4 || g.threads != g.G * g.NC ||
      g.threads > kMaxThreads) {
    return false;
  }
  if ((g.leg != 0 && g.leg != 1) || (g.wrap != 0 && g.wrap != 1)) {
    return false;
  }
  return g.smem_bytes == 4 * g.rows * g.S + 8 * table_entries(g) &&
         g.smem_bytes <= kMaxSmem;
}

template <int L, class Op>
cudaError_t run(const float* src, float* dst, const float* f, int nsweeps,
                const HJBSlab& g, const typename Op::Params& p,
                unsigned long long* box, unsigned* count,
                cudaStream_t stream) {
  static const cudaError_t opted = cudaFuncSetAttribute(  // once, outside
      slab2d_kernel<L, Op>,                               // any capture
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opted != cudaSuccess) return opted;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.ntx * g.nty, 1, 1);
  cfg.blockDim = dim3(g.threads, 1, 1);
  cfg.dynamicSmemBytes = g.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.leg ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, slab2d_kernel<L, Op>, src,
                                           dst, f, nsweeps, g, p, box, count);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <class Op>
int launch(const float* src, float* dst, const float* f, int nsweeps,
           const HJBSlab* g, const typename Op::Params* p,
           unsigned long long* box, unsigned* count, void* stream) {
  if (!g || !p || !f || !valid(*g) || nsweeps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int most = g->leg ? (kMaxRefresh + 1) * g->T : g->T;
  const bool exchange = g->leg && g->ntx * g->nty > 1;
  if (nsweeps > most || exchange != (box != nullptr) ||
      (box == nullptr) != (count == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  switch (g->L) {
    case 4:
      return (int)run<4, Op>(src, dst, f, nsweeps, *g, *p, box, count, s);
    case 6:
      return (int)run<6, Op>(src, dst, f, nsweeps, *g, *p, box, count, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// `nsweeps` sweeps from src into dst (apart from src) with RHS f, in the
// layout *g (slab2d.slab_layout), the fields *p.  The leg form (g->leg)
// takes up to (kMaxRefresh + 1) T sweeps in one cooperative launch, its
// outboxes box (2 ntx nty face words) and its two counters count, zero
// when first used and never to be cleared (see the header); the other at
// most T sweeps, box and count null.  Default visibility spelled out: the
// host compiler hides a function whose body launches a kernel taking a
// type of this file's unnamed namespace.
__attribute__((visibility("default"))) int pdemg_slab2d(
    const float* src, float* dst, const float* f, int nsweeps,
    const HJBSlab* g, const HJB2D* p, unsigned long long* box,
    unsigned* count, void* stream) {
  if (g && g->wrap) return (int)cudaErrorInvalidValue;
  return launch<HJBOp>(src, dst, f, nsweeps, g, p, box, count, stream);
}

// The same on a 2D Poisson level (wrap or padded storage, g->wrap) with
// the constants *p.
__attribute__((visibility("default"))) int pdemg_slab2d_poisson(
    const float* src, float* dst, const float* f, int nsweeps,
    const HJBSlab* g, const Poisson2D* p, unsigned long long* box,
    unsigned* count, void* stream) {
  return launch<PoissonOp>(src, dst, f, nsweeps, g, p, box, count, stream);
}

}  // extern "C"
