// Red-black sweeps on colour-split halves of a padded 2D Lyapunov level
// (sm_90a), in three forms of one template: the chunk and the leg of the
// sharded and unsharded colour slab, and the whole-leg dense resident relax;
// and the chunk's one-rank form on a padded 2D Poisson level, whose stencil
// reads both sides (the template's stencil `St`: Lyap2D or Poisson2D).
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_color_slab_2d_shard
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_color_slab_2d
//     (its raw form, sweeps_per_call = T: the chunk's one-rank form)
//   pde_multigrid_tpu/ops/pallas/relax.py:make_resident_relax
//     (its 2D Lyapunov levels: the dense form)
//   and, for 2D Poisson, make_split_color_slab_2d's raw form on the padded
//   split levels 4097^2 ... 513^2 (pdemg_color_slab2d_poisson)
//
// The function.  Input: the red and black halves (layout of
// csrc/relax2d.cu, in the global colour convention: q = (g0 + x) % 2) and
// their RHS halves, Y2 slots a row, ext row 0 at global row g0.
// Lyapunov's stencil is one-sided (a red point at (x, j) reads B[x+1, j]
// and B[x, j+q]; a black one R[x+1, j] and R[x, j+1-q]), so a shard's halo
// sits on the +x side alone.  Coefficients, colour and interior test come
// from the global row g = g0 + x (lyapunov2d.cuh).  Output: the exact
// owned x_loc rows of both halves after t sweeps, written to ro / bo,
// which must not overlap the inputs (tiles read rows that other tiles
// own).  Without f (fr = fb = null) no RHS is read and no f a_f term is
// added: a zero RHS term would not be the same (-0 + +0 is +0, and 0 a_f
// is NaN where a_f is not finite).
//
//   * chunk (pdemg_color_slab2d_shard): one chunk of t sweeps on ext
//     halves of XE rows.  With XE >= x_loc + 2t the rows past x_loc are the
//     right neighbour's first rows (the ring's halo).  On a one-rank ring
//     -- and on an unsharded level, whose relax is JAX's sweeps_per_call =
//     T form: ceil(nsweeps / T) such chunks -- the caller passes XE =
//     x_loc: rows past it read as 0.  No interior point of such a shard
//     reads past x_loc, because its last row is the level's boundary or
//     padding (the argument that lets the last shard's ring-wrapped halo
//     be anything), so the owned rows are bitwise those of the ext form
//     and of the half-sweep chain, and no halo copy is needed.
//   * leg (pdemg_color_slab2d_leg): a whole leg of nsweeps on a one-rank
//     level held on chip: one CTA, or a cluster of up to 16 CTAs along x,
//     each holding a band of BX rows and the 2 kLegT rows past it.  Every
//     kLegT sweeps each CTA pushes the first 2 kLegT rows of its band into
//     its left neighbour's shared memory (DSMEM), and one cluster barrier
//     later that neighbour takes them as its halo rows.  A stale value
//     spreads one row per half-sweep toward -x, so after kLegT sweeps the
//     band is exact (the trapezoid argument), and the refreshed halo
//     restarts it: the owned rows are bitwise those of the chunked
//     schedule.
//   * dense (pdemg_resident2d): the leg on a dense level, in place: the
//     function of make_resident_relax, whose update is the blend
//     v + m (upd - v) with m = 1 on the colour's interior points (red:
//     x + y even) and whose RHS is f or none.  The band's dense rows are
//     split into colour halves as they load and merged as they store, so
//     the sweeps are the leg's; only the last step of the update differs
//     (old + (upd - old) in place of the select).  One cluster barrier
//     after the load: no CTA stores into v before every CTA has read the
//     rows it holds.
//
// Design.  A CTA holds a tile of RX x RJ points of both colours (owned
// BX x BJ, with a 2t halo on +x and, when the tile does not span the row,
// on +j) in shared memory: r and b with a zero row and a zero column past
// the tile, and fr, fb where the sweeps read f.  Each thread owns the
// fixed points p = tid + m NT (m < P) of the tile and computes their
// coefficients (ae, as and f af of each colour), interior flags and
// shared-memory offsets once a tile, into registers; a half-sweep is then
// two shared loads (three in the dense form: its blend reads the old
// value; all for G points before their stores), three products and sums
// and a predicated store a point, between block barriers.  A chunk
// launches one CTA an SM; each walks its tiles with the next tile's
// copies (cp.async, zero-filled past XE and Y2) in flight while it sweeps
// the current one.  Two forms (`Form`): 512 threads of 10 points (128
// registers) and 1024 of 4 (64, twice the warps to hide the barriers' and
// loads' latency, on levels whose tiles take more than one wave of CTAs).
// Rows past XE and slots past Y2 read as 0 and are never updated: no
// owned point depends on them (a point reading slot Y2 is the inert slot
// or the boundary column, never interior).  t is a run-time loop bound:
// templates unrolled per t cost build time.  The wrapper
// (relax2d.slab_tile, leg_layout) picks the form and the tiles: at 4097^2
// 1024 threads on 64 x 64 points (owned 56 x 56 at t = 4), whole rows
// where Y2 <= 64, and fewer rows where the tiles would not fill whole
// waves of CTAs.
//
// Poisson (pdemg_color_slab2d_poisson, the chunk on an unsharded level:
// XE = x_loc, g0 = 0).  A red point at (x, j) reads B[x - 1, j], B[x + 1,
// j], B[x, j - 1 + q] and B[x, j + q]; a black one R[x -+ 1, j], R[x, j -
// q] and R[x, j + 1 - q]: one row or slot either way a half-sweep, so a
// tile's halo is 2t rows on -x as well as +x and, where the tile does not
// span the row, 2t slots on both j sides (relax2d.slab_tile, sides = 2),
// and the tile carries a zero guard row and column before its points as
// well as after them.  Rows before 0 and past XE and slots before 0 and
// past Y2 read as 0, never updated: only boundary points and inert slots
// read them (rows -1 and X are read by rows 0 and X - 1, the boundary;
// slot -1 by y = 0, slot Y2 by the inert slot y = Y), so the owned rows
// are bitwise the half-sweep chain's.  The update is poisson2d.cuh's in
// split_update2d's order, and the select writes it: no coefficient is
// computed, f is read raw (-f), 7 float operations a point.
//
// What bounds it: per point and chunk it reads four halves and writes two
// (24 B; 16 B without f), plus the tile halo (1.31x the owned points at
// 4097^2); per interior point and half-sweep 4 float operations (two
// products, two sums; 3 without f, 5 with the dense form's blend), and
// once a tile 24 for the coefficients (lyap_coef, one IEEE division) and
// one for f af, recomputed on the halo points too.  With one CTA an SM a
// tile's dependent phases (copies, coefficients, 2t barrier-separated
// half-sweeps) leave issue slots idle.  Small levels are bound by
// latency: a leg on chip pays one launch and one cluster barrier every
// kLegT sweeps instead of a launch, two halo copies and a pass over
// device memory every chunk.
//
// Masked points are never written (the select form; the dense form's
// blend leaves them as the Pallas kernel's m = 0 does), so they stay
// bitwise; with --fmad=false (f af is rounded once, then added, as in
// split_update2d) the owned output equals the plain versions
// (relax2d.color_slab2d_shard_plain, resident.resident_relax_plain) bit
// for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "lyapunov2d.cuh"  // Lyap2D, lyap_coef, interior
#include "poisson2d.cuh"   // Poisson2D, poisson_update, poisson_interior

namespace cg = cooperative_groups;

namespace {

// The kernel's forms: threads a CTA, points a thread holds (both
// colours), and points whose neighbours load together (a divisor of the
// points).  A chunk on 512 threads of 10 points or 1024 of 4, a leg on
// 512 of 8 (its halo exchange needs registers).
template <int NT_, int P_, int G_>
struct Form {
  static constexpr int NT = NT_, P = P_, G = G_;
  static_assert(P % G == 0, "groups must tile the points");
};
using Chunk512 = Form<512, 10, 5>;
using Chunk1024 = Form<1024, 4, 4>;
using Leg = Form<512, 8, 4>;
constexpr int kLegT = 4;     // sweeps between a leg's halo refreshes
constexpr int kMaxCtas = 16;  // a non-portable cluster
constexpr int kMaxSmem = 227 * 1024;

struct Tile {
  int XE, x_loc, Y2, g0;  // rows loaded at most, owned rows, slots, g0
  int RX, RJ;  // loaded rows and slots of a tile
  int BX, BJ;  // owned rows and slots of a tile (the tile stride)
  int ntj, ntiles;  // tiles along j, tiles in all
  int Y;  // the dense form's columns (Y2 = ceil(Y / 2))
  int HX, HJ;  // halo rows and slots before the owned ones (0: one-sided)
};

// Zero guard rows and columns a tile carries before its points: one for a
// stencil that reads -x and -j (Poisson), none for Lyapunov's.
template <class St>
constexpr int kGuard = std::is_same<St, Poisson2D>::value ? 1 : 0;

// floats of one tile buffer: r and b with a zero row and column past the
// tile (and, with a guard, before it), and fr and fb where the sweeps read
// f
__host__ __device__ inline int buffer_floats(int RX, int RJ, bool with_f,
                                             int guard = 0) {
  return 2 * (RX + 1 + guard) * (RJ + 1 + guard) +
         (with_f ? 2 * RX * RJ : 0);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  // 4 bytes global -> shared, zero-filled where `in` is false
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// The first loaded row and slot of a tile: its owned origin less the halo
// before it (negative where the halo reaches before the level).
__device__ __forceinline__ void tile_origin(const Tile& T, bool leg,
                                            int tile, int& x0, int& j0) {
  const int ty = leg ? tile : tile / T.ntj;
  x0 = ty * T.BX - T.HX;
  j0 = (leg ? 0 : (tile - ty * T.ntj) * T.BJ) - T.HJ;
}

// The tile coordinates (lx, lj) of a thread's points p = tid + m NT in a
// tile of RJ slots a row, m = 0, 1, ...: one division, then steps.
struct Slots {
  int lx, lj, dx, dj, RJ;
  __device__ __forceinline__ Slots(int RJ_, int NT) : RJ(RJ_) {
    lx = threadIdx.x / RJ;
    lj = threadIdx.x - lx * RJ;
    dx = NT / RJ;
    dj = NT - dx * RJ;
  }
  __device__ __forceinline__ void next() {
    lx += dx;
    lj += dj;
    if (lj >= RJ) {
      lj -= RJ;
      ++lx;
    }
  }
};

// Start the copies of tile `tile` (r, b, and fr, fb WITH_F) into `buf`,
// one group.  DENSE: r and fr are the dense level and its RHS (X rows of
// Y), split into the halves as they load: red at y = 2j + q, black at
// y = 2j + 1 - q, zero past Y (the inert slot).
template <class F, bool DENSE, bool WITH_F, int GD>
__device__ __forceinline__ void load_tile(const float* r, const float* b,
                                          const float* fr, const float* fb,
                                          const Tile& T, bool leg, int tile,
                                          float* buf) {
  int x0, j0;
  tile_origin(T, leg, tile, x0, j0);
  const int S = T.RJ + 1 + GD;
  const int plane = (T.RX + 1 + GD) * S;
  const int npts = T.RX * T.RJ;
  Slots sl(T.RJ, F::NT);
#pragma unroll
  for (int m = 0; m < F::P; ++m, sl.next()) {
    const int pt = threadIdx.x + m * F::NT;
    if (pt < npts) {
      const int lx = sl.lx;
      const int lj = sl.lj;
      const int x = x0 + lx;
      const int j = j0 + lj;
      const int k = (lx + GD) * S + lj + GD;
      long long gr, gb;  // the red and black points' offsets
      bool in_r, in_b;
      if (DENSE) {
        const int q = x & 1;
        const long long row = (long long)x * T.Y;
        in_r = x < T.XE && 2 * j + q < T.Y;
        in_b = x < T.XE && 2 * j + 1 - q < T.Y;
        gr = in_r ? row + 2 * j + q : 0;
        gb = in_b ? row + 2 * j + 1 - q : 0;
      } else {
        in_r = in_b = x >= 0 && x < T.XE && j >= 0 && j < T.Y2;
        gr = gb = in_r ? (long long)x * T.Y2 + j : 0;
      }
      cp_async4(buf + k, r + gr, in_r);
      cp_async4(buf + plane + k, (DENSE ? r : b) + gb, in_b);
      if (WITH_F) {
        cp_async4(buf + 2 * plane + pt, fr + gr, in_r);
        cp_async4(buf + 2 * plane + npts + pt, (DENSE ? fr : fb) + gb, in_b);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// t sweeps (nchunks chunks: t each and t_last in the last, a leg's halo
// rows refreshed from the cluster's next CTA between them) on every tile
// of this CTA, the owned points out to ro, bo.  A chunk CTA walks the
// tiles blockIdx.x, + gridDim.x, ..., the next tile's copies in flight
// while it sweeps one (two buffers); a leg CTA (LEG) holds the band of its
// cluster rank.  Between a leg's chunks each CTA pushes its band's first
// 2 kLegT rows into the previous CTA's inbox (two, used in turns), one
// cluster barrier, then copies its own inbox into its halo rows: the
// barrier of the next refresh cannot pass before every CTA has emptied
// the inbox that refresh writes.  DENSE (a leg): r, fr and ro are the
// dense level, its RHS and the level again (in place); b, fb, bo unused.
// No pointer is __restrict__: the dense form reads and writes v.
template <bool LEG, bool DENSE, bool WITH_F, class F, class St = Lyap2D>
__global__ void __launch_bounds__(F::NT, 1)
    color_slab2d_kernel(const float* r, const float* b, const float* fr,
                        const float* fb, float* ro, float* bo, Tile T, int t,
                        int nchunks, int t_last, St p) {
  static_assert(LEG || !DENSE, "the dense form is a leg");
  constexpr bool POISSON = std::is_same<St, Poisson2D>::value;
  static_assert(!POISSON || !LEG, "the Poisson form is the chunk");
  constexpr int GD = kGuard<St>;
  extern __shared__ float smem[];
  // row stride: a zero column past the tile (and a guard column before)
  const int S = T.RJ + 1 + GD;
  const int plane = (T.RX + 1 + GD) * S;  // and a zero row (and a guard)
  constexpr int NT = F::NT, P = F::P, G = F::G;
  const int npts = T.RX * T.RJ;
  const int nslot = (npts + NT - 1) / NT;  // points a thread holds
  const int nbuf = !LEG && T.ntiles > (int)gridDim.x ? 2 : 1;
  const int bufsz = buffer_floats(T.RX, T.RJ, WITH_F, GD);
  const int tid = threadIdx.x;

  for (int q = 0; q < nbuf; ++q) {
    float* base = smem + q * bufsz;
    for (int i = tid; i < S; i += NT) {
      base[(T.RX + GD) * S + i] = 0.0f;
      base[plane + (T.RX + GD) * S + i] = 0.0f;
      if (GD) {
        base[i] = 0.0f;
        base[plane + i] = 0.0f;
      }
    }
    for (int i = tid; i < T.RX + GD; i += NT) {
      base[i * S + T.RJ + GD] = 0.0f;
      base[plane + i * S + T.RJ + GD] = 0.0f;
      if (GD) {
        base[i * S] = 0.0f;
        base[plane + i * S] = 0.0f;
      }
    }
  }

  int cur = 0;
  load_tile<F, DENSE, WITH_F, GD>(r, b, fr, fb, T, LEG, blockIdx.x, smem);
  for (int tile = blockIdx.x; tile < T.ntiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (!LEG && next < T.ntiles) {
      load_tile<F, DENSE, WITH_F, GD>(r, b, fr, fb, T, false, next,
                                      smem + (cur ^ 1) * bufsz);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (DENSE && gridDim.x > 1) {
      cg::this_cluster().sync();  // every band read before any is stored
    }
    float* sr = smem + cur * bufsz;
    float* sb = sr + plane;
    const float* sfr = sr + 2 * plane;
    const float* sfb = sfr + npts;
    int x0, j0;
    tile_origin(T, LEG, tile, x0, j0);

    // this thread's points: offsets, row parities, interior flags (bit 2m
    // red, 2m + 1 black) and coefficients (f af of each colour rounded
    // once, as split_update2d rounds it; Poisson: f), once a tile
    int off[P];
    unsigned qbits = 0, live = 0, owned = 0;
    float ae[2][P], as[2][P], ff[2][P];
    const int bj = min(T.BJ, T.Y2 - (j0 + T.HJ));
    const int bx = min(T.BX, T.x_loc - (x0 + T.HX));
    Slots sl(T.RJ, NT);
#pragma unroll
    for (int m = 0; m < P; ++m, sl.next()) {
      const int pt = tid + m * NT;
      off[m] = 0;
#pragma unroll
      for (int c = 0; c < 2; ++c) ae[c][m] = as[c][m] = ff[c][m] = 0.0f;
      if (pt >= npts) continue;
      const int lx = sl.lx;
      const int lj = sl.lj;
      if (lx >= T.HX && lx - T.HX < bx && lj >= T.HJ && lj - T.HJ < bj) {
        owned |= 1u << m;
      }
      const int x = x0 + lx;
      const int j = j0 + lj;
      off[m] = (lx + GD) * S + lj + GD;
      if (x < 0 || x >= T.XE || j < 0 || j >= T.Y2) continue;
      const int gx = T.g0 + x;
      const int q = gx & 1;
      qbits |= (unsigned)q << m;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int y = 2 * j + (c == 0 ? q : 1 - q);
        if constexpr (POISSON) {
          if (!poisson_interior(gx, y, p)) continue;
          live |= 1u << (2 * m + c);
          if (WITH_F) ff[c][m] = c == 0 ? sfr[pt] : sfb[pt];
        } else {
          if (!interior(gx, y, p)) continue;
          live |= 1u << (2 * m + c);
          const Coef cf = lyap_coef(gx, y, p);
          ae[c][m] = cf.ae;
          as[c][m] = cf.as;
          if (WITH_F) ff[c][m] = (c == 0 ? sfr[pt] : sfb[pt]) * cf.af;
        }
      }
    }

    for (int ch = 0; ch < nchunks; ++ch) {
      const int tc = ch == nchunks - 1 ? t_last : t;
      for (int s = 0; s < tc; ++s) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* u = c == 0 ? sr : sb;        // the colour updated
          const float* w = c == 0 ? sb : sr;  // the other colour
#pragma unroll
          for (int m0 = 0; m0 < P; m0 += G) {
            if (m0 >= nslot) break;
            if constexpr (POISSON) {
              // x - 1 and x + 1 at slot j; y - 1 and y + 1 at slots j +
              // jm and j + jm + 1 (red jm = q - 1, black -q), all loaded
              // for the group before its stores
              float xm[G], xp[G], ym[G], yp[G];
#pragma unroll
              for (int i = 0; i < G; ++i) {
                const int m = m0 + i;
                if (m >= nslot) break;
                const int q = (qbits >> m) & 1;
                const int jm = c == 0 ? q - 1 : -q;
                xm[i] = w[off[m] - S];
                xp[i] = w[off[m] + S];
                ym[i] = w[off[m] + jm];
                yp[i] = w[off[m] + jm + 1];
              }
#pragma unroll
              for (int i = 0; i < G; ++i) {
                const int m = m0 + i;
                if (!((live >> (2 * m + c)) & 1u)) continue;
                // the select: split_update2d's value (no f: f = 0, whose
                // -0 adds nothing)
                u[off[m]] = poisson_update(xm[i], xp[i], ym[i], yp[i],
                                           WITH_F ? ff[c][m] : 0.0f, p);
              }
            } else {
              // east (gx + 1, y) at slot j, south (gx, y + 1) at slot j +
              // sft (y = 2j + sft), and the dense form's old values, loaded
              // for the group before its stores
              float e[G], so[G], o[G];
#pragma unroll
              for (int i = 0; i < G; ++i) {
                const int m = m0 + i;
                const int q = (qbits >> m) & 1;
                if (m >= nslot) break;
                e[i] = w[off[m] + S];
                so[i] = w[off[m] + (c == 0 ? q : 1 - q)];
                if (DENSE) o[i] = u[off[m]];
              }
#pragma unroll
              for (int i = 0; i < G; ++i) {
                const int m = m0 + i;
                if (!((live >> (2 * m + c)) & 1u)) continue;
                // the order of split_update2d: east ae + south as (+ f af)
                float v = e[i] * ae[c][m];
                v = v + so[i] * as[c][m];
                if (WITH_F) v = v + ff[c][m];
                if (DENSE) {
                  u[off[m]] = o[i] + (v - o[i]);  // m = 1: v + m (upd - v)
                } else {
                  u[off[m]] = v;
                }
              }
            }
          }
          __syncthreads();  // this colour done before the other reads it
        }
      }
      if (LEG && ch + 1 < nchunks) {
        // the band's halo rows: the next CTA's first 2 kLegT rows, exact
        // after this chunk, pushed into this CTA's inbox `ch & 1`
        cg::cluster_group cl = cg::this_cluster();
        const int rows = 2 * kLegT * S;
        float* inbox = smem + bufsz + (ch & 1) * 2 * rows;
        if (blockIdx.x > 0) {
          float* dst = cl.map_shared_rank(inbox, blockIdx.x - 1);
          for (int i = tid; i < rows; i += NT) {
            dst[i] = sr[i];
            dst[rows + i] = sb[i];
          }
        }
        cl.sync();
        if (blockIdx.x + 1 < gridDim.x) {
          for (int i = tid; i < rows; i += NT) {
            sr[T.BX * S + i] = inbox[i];
            sb[T.BX * S + i] = inbox[rows + i];
          }
        }
        __syncthreads();
      }
    }

    Slots sw(T.RJ, NT);
#pragma unroll
    for (int m = 0; m < P; ++m, sw.next()) {
      if (!((owned >> m) & 1u)) continue;
      const int x = x0 + sw.lx;
      const int j = j0 + sw.lj;
      if (DENSE) {
        // merged back into the dense rows (nothing past Y)
        const int q = x & 1;
        const long long row = (long long)x * T.Y;
        if (2 * j + q < T.Y) ro[row + 2 * j + q] = sr[off[m]];
        if (2 * j + 1 - q < T.Y) ro[row + 2 * j + 1 - q] = sb[off[m]];
      } else {
        const long long g = (long long)x * T.Y2 + j;
        ro[g] = sr[off[m]];
        bo[g] = sb[off[m]];
      }
    }
    cur ^= nbuf - 1;
    __syncthreads();  // this buffer read out before it is refilled
  }
}

// A kernel's attributes: dynamic shared memory past 48 KB, and clusters
// past the portable 8 CTAs.  Once per process and form, at its first
// launch (outside any graph capture: the callers run eagerly first).
template <bool LEG, bool DENSE, bool WITH_F, class F, class St = Lyap2D>
cudaError_t opt_in() {
  static const cudaError_t status = [] {
    const auto kernel = color_slab2d_kernel<LEG, DENSE, WITH_F, F, St>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess || !LEG) return e;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return status;
}

// The card's SMs: a chunk launches at most one CTA on each.
int num_sms() {
  static const int n = [] {
    int dev = 0, count = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess) {
      return 0;
    }
    return count;
  }();
  return n;
}

bool tile_ok(const Tile& T, int pts, size_t smem) {
  return T.RX >= 1 && T.RJ >= 1 && T.BX >= 1 && T.BJ >= 1 &&
         T.BX <= T.RX && T.BJ <= T.RJ && T.RX * T.RJ <= pts &&
         smem <= (size_t)kMaxSmem;
}

// Whether a tile of R loaded and B owned points along an axis of n points
// (E of them loaded at most) carries the halo t sweeps need: 2t past its
// owned points (Lyapunov) or on each side (Poisson, `two`: the halo split
// evenly, (R - B) / 2 before), except where one tile spans the axis.
inline bool halo_ok(int R, int B, int n, int E, int t, bool two) {
  if (B >= n && R >= E) return !two || (R - B) % 2 == 0;
  return two ? R - B >= 4 * t && (R - B) % 2 == 0 : R - B >= 2 * t;
}

template <bool WITH_F, class F, class St>
int launch_chunk(const float* r, const float* b, const float* fr,
                 const float* fb, float* ro, float* bo, int XE, int x_loc,
                 int Y2, int g0, int t, int RX, int RJ, int BX, int BJ,
                 const St* p, cudaStream_t stream) {
  constexpr bool two = std::is_same<St, Poisson2D>::value;
  if (t < 1 || x_loc < 1 || Y2 < 1 || XE < x_loc || BX < 1 || BJ < 1 ||
      (two && XE != x_loc)) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntj = (Y2 + BJ - 1) / BJ;
  const int ntiles = ((x_loc + BX - 1) / BX) * ntj;
  const int HX = two ? (RX - BX) / 2 : 0, HJ = two ? (RJ - BJ) / 2 : 0;
  const Tile T{XE, x_loc, Y2, g0, RX, RJ, BX, BJ, ntj, ntiles, 2 * Y2,
               HX, HJ};
  // the tile's halo covers 2t rows and slots beside its owned points (past
  // them, or on both sides), except where it reaches past the rows (XE) or
  // slots (Y2) that exist
  const bool halo_x = halo_ok(RX, BX, x_loc, XE, t, two);
  const bool halo_j = halo_ok(RJ, BJ, Y2, Y2, t, two);
  const int sms = num_sms();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int grid = ntiles < sms ? ntiles : sms;
  const size_t smem = (ntiles > grid ? 2 : 1) *
                      buffer_floats(RX, RJ, WITH_F, kGuard<St>) *
                      sizeof(float);
  if (!tile_ok(T, F::NT * F::P, smem) || !halo_x || !halo_j) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = opt_in<false, false, WITH_F, F, St>();
  if (e != cudaSuccess) return (int)e;
  color_slab2d_kernel<false, false, WITH_F, F, St>
      <<<grid, F::NT, smem, stream>>>(r, b, fr, fb, ro, bo, T, t, 1, t, *p);
  return (int)cudaGetLastError();
}

// The chunk in the form `threads` names (Chunk512 or Chunk1024), with or
// without f.
template <class St>
int chunk(const float* r, const float* b, const float* fr, const float* fb,
          float* ro, float* bo, int XE, int x_loc, int Y2, int g0, int t,
          int RX, int RJ, int BX, int BJ, int threads, const St* p,
          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if ((fr == nullptr) != (fb == nullptr) ||
      (threads != Chunk512::NT && threads != Chunk1024::NT)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool big = threads == Chunk1024::NT;
  if (fr == nullptr) {
    return big ? launch_chunk<false, Chunk1024>(r, b, fr, fb, ro, bo, XE,
                                                x_loc, Y2, g0, t, RX, RJ, BX,
                                                BJ, p, s)
               : launch_chunk<false, Chunk512>(r, b, fr, fb, ro, bo, XE,
                                               x_loc, Y2, g0, t, RX, RJ, BX,
                                               BJ, p, s);
  }
  return big ? launch_chunk<true, Chunk1024>(r, b, fr, fb, ro, bo, XE, x_loc,
                                             Y2, g0, t, RX, RJ, BX, BJ, p, s)
             : launch_chunk<true, Chunk512>(r, b, fr, fb, ro, bo, XE, x_loc,
                                            Y2, g0, t, RX, RJ, BX, BJ, p, s);
}

// A leg of nsweeps on a one-rank level of X rows (Y2 slots a row; the
// dense form's rows hold Y points), on nctas CTAs of RX loaded and BX
// owned rows.
template <bool DENSE, bool WITH_F>
int launch_leg(const float* r, const float* b, const float* fr,
               const float* fb, float* ro, float* bo, int X, int Y, int Y2,
               int nsweeps, int RX, int BX, int nctas, const Lyap2D* p,
               cudaStream_t stream) {
  const Tile T{X, X, Y2, 0, RX, Y2, BX, Y2, 1, nctas, Y};
  // one CTA holds the whole level (no halo: one chunk of nsweeps); a
  // cluster's bands hold 2 kLegT halo rows each, taken from the next band
  const bool one = nctas == 1 && BX >= X && RX >= X;
  const bool bands = nctas > 1 && nctas <= kMaxCtas && BX >= 2 * kLegT &&
                     RX == BX + 2 * kLegT && nctas * BX >= X &&
                     (nctas - 1) * BX < X;
  // the tile, and two inboxes of 2 kLegT rows of r and b
  const size_t smem =
      (buffer_floats(RX, Y2, WITH_F) + 8 * kLegT * (Y2 + 1)) * sizeof(float);
  if (nsweeps < 1 || X < 1 || Y2 < 1 || (DENSE && Y2 != (Y + 1) / 2) ||
      !tile_ok(T, Leg::NT * Leg::P, smem) || !(one || bands)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = opt_in<true, DENSE, WITH_F, Leg>();
  if (e != cudaSuccess) return (int)e;
  const int nchunks = one ? 1 : (nsweeps + kLegT - 1) / kLegT;
  const int t = one ? nsweeps : kLegT;
  const int t_last = nsweeps - (nchunks - 1) * t;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(nctas, 1, 1);
  cfg.blockDim = dim3(Leg::NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nctas > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, color_slab2d_kernel<true, DENSE, WITH_F, Leg>,
                         r, b, fr, fb, ro, bo, T, t, nchunks, t_last, *p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One chunk: t sweeps on the (XE, Y2) ext halves r, b (RHS fr, fb, or
// both null: no RHS), in tiles of RX x RJ loaded and BX x BJ owned points,
// on CTAs of `threads` (512 or 1024); the owned x_loc rows out to ro, bo.
// XE = x_loc is the one-rank form.
__attribute__((visibility("default"))) int pdemg_color_slab2d_shard(
    const float* r, const float* b, const float* fr, const float* fb,
    float* ro, float* bo, int XE, int x_loc, int Y2, int g0, int t, int RX,
    int RJ, int BX, int BJ, int threads, const Lyap2D* p, void* stream) {
  return chunk(r, b, fr, fb, ro, bo, XE, x_loc, Y2, g0, t, RX, RJ, BX, BJ,
               threads, p, stream);
}

// The 2D Poisson chunk on an unsharded padded level's halves (XE = x_loc
// = X, g0 = 0), with the constants *p: tiles of RX x RJ loaded points with
// (RX - BX) / 2 and (RJ - BJ) / 2 halo rows and slots on each side
// (relax2d.slab_tile, sides = 2).
__attribute__((visibility("default"))) int pdemg_color_slab2d_poisson(
    const float* r, const float* b, const float* fr, const float* fb,
    float* ro, float* bo, int XE, int x_loc, int Y2, int g0, int t, int RX,
    int RJ, int BX, int BJ, int threads, const Poisson2D* p, void* stream) {
  return chunk(r, b, fr, fb, ro, bo, XE, x_loc, Y2, g0, t, RX, RJ, BX, BJ,
               threads, p, stream);
}

// A whole leg: nsweeps on a one-rank level's (X, Y2) halves, held by
// nctas CTAs of RX loaded and BX owned rows; the level out to ro, bo.
__attribute__((visibility("default"))) int pdemg_color_slab2d_leg(
    const float* r, const float* b, const float* fr, const float* fb,
    float* ro, float* bo, int X, int Y2, int nsweeps, int RX, int BX,
    int nctas, const Lyap2D* p, void* stream) {
  return launch_leg<false, true>(r, b, fr, fb, ro, bo, X, 2 * Y2, Y2,
                                 nsweeps, RX, BX, nctas, p,
                                 (cudaStream_t)stream);
}

// A whole leg in place on a dense (X, Y) level v (RHS f, or null: none),
// in make_resident_relax's blend form, held as the leg holds its halves
// (RX loaded and BX owned rows on nctas CTAs, relax2d.leg_layout).
__attribute__((visibility("default"))) int pdemg_resident2d(
    float* v, const float* f, int X, int Y, int nsweeps, int RX, int BX,
    int nctas, const Lyap2D* p, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int Y2 = (Y + 1) / 2;
  if (f == nullptr) {
    return launch_leg<true, false>(v, nullptr, nullptr, nullptr, v, nullptr,
                                   X, Y, Y2, nsweeps, RX, BX, nctas, p, s);
  }
  return launch_leg<true, true>(v, nullptr, f, nullptr, v, nullptr, X, Y, Y2,
                                nsweeps, RX, BX, nctas, p, s);
}

}  // extern "C"
