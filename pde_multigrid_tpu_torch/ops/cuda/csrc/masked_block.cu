// Masked dense red-black Gauss-Seidel on one shard's extended block
// (sm_90a), the per-shard engine of parallel/halo.py on the 3D wrap
// Poisson levels the time-skew engine does not take.
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_masked_block_relax
// which runs t sweeps of `_sweeps` (relax.py:129-137) on a VMEM-resident
// block whose masks arrive as inputs, all t in one kernel invocation with
// a single HBM round trip: per sweep and colour
//   v = v + m * (kernel_update(v, f) - v)
// at every point of the block, m the colour's mask (red, then black).
// The masks are inputs because they depend on the shard's global row
// offset; they are built once per level and rank (parallel/halo.py).
//
// Function: each half-sweep computes every point of the (XB, Y, Z) block
// from the values before it (the masked-off points too, as c + m d with
// m = 0: skipping them would change the bits of -0 and let NaN through).
// Neighbours wrap modulo the block's extents on all three axes, as
// torch.roll does in the plain version: y and z are whole periodic
// (wrap-storage) axes; x wraps within the block, so the block's first and
// last planes read each other, which only the halo planes see (the owned
// planes lie 2t planes inside).
//
// Bytes and operations: a chunk of t sweeps reads v, f and both masks
// once and writes v once, 20 B a point (47 MB for the (144, 128, 128)
// block of the 128^3 level on one rank: 0.014 ms at 3.35 TB/s), and does
// 14 float32 operations a point a half-sweep (3 pair sums, the update's
// 8, the blend's 3).  So bytes bound it on paper; what bounds the chunk on
// the card is its 2t dependent half-sweeps, each needing the neighbours'
// faces of the one before.
//
// Design (masked_chunk_kernel): JAX's form, the block on chip for the
// whole chunk, one launch.  The block is too large for one CTA or one
// 16-CTA cluster (9.4 MB of v alone at 128^3), so the grid is
// co-resident, at most one CTA an SM, as relax.cu's error leg: the block
// is cut into `planes` x planes by `rows` whole y rows (every z), one a
// CTA (the (144, 128, 128) block: 16 x 8 blocks of 9 planes by 16 rows,
// 128 CTAs of 512 threads).  Shared memory holds the block's v, each
// plane with a halo row before and after its rows, and its f; thread (r,
// zq) owns the z quad (4 zq ... 4 zq + 3) of row r on every plane, and
// the masks of its column as bits in two registers (where every mask
// value of the CTA's block is exactly +0 or 1; else it reads them from
// device memory every half-sweep).  A half-sweep is Jacobi-like in the
// plain version (every point from the old values), so the CTA walks its
// planes two at a time, a block barrier a step: each thread computes its
// quads of the step's planes from the old values (its x neighbours are
// its own column, the old value of a plane already written kept in a
// register), and writes them once every thread has read the planes; the
// first step takes the last and the first plane, so both x faces are
// done first.
// The faces a block shares with its x and y neighbours (rings: x wraps
// within the block, y over the level) go through device memory as one
// 8-byte word a point, (epoch << 32 | the float's bits), written and
// read 16 bytes at a time by st/ld.relaxed.gpu, so a word arrives whole
// and no fence or flag is needed: a face goes out as soon as its plane is
// computed, and at the start of the next half-sweep each thread requests
// its x neighbours' quads and its share of the halo rows (at most 2
// quads) before waiting for any, by their epoch.  Each face has a slot per
// half-sweep parity; a slot is rewritten two half-sweeps later, only
// after the writer's block has taken the words its reader's block wrote
// in between, which the reader sends only after its own takes and a
// block barrier: no word is overwritten before it is read.  The epoch is (launch << 8 | half-sweep
// + 1), the launch taken from a counter in device memory that the last
// CTA to finish increments: words of an earlier launch never match, so
// the outboxes need no clearing, and a replayed CUDA graph counts on.  A
// block the grid holds whole (one CTA) exchanges nothing: its x and y
// wraps are its own column and rows.  The launch is cooperative
// (cudaLaunchAttributeCooperative): a grid the card cannot co-schedule
// fails to launch (the wrapper raises) rather than deadlocking.  On the
// card (PERF.md) a t = 4 chunk of the (144, 128, 128) block takes well
// under the one-colour form's 8 launches: each half-sweep costs its walk
// of 9 planes and the faces' round trip through the L2, which on blocks
// of fewer planes a CTA outweighs the launches it saves.
//
// The port's first form, one launch per colour half-sweep
// (masked_block_kernel: a thread per point, out = v + m (upd - v) from v
// into a second buffer), stays for those blocks (ops/cuda/masked_block.py
// `form`: fewer than CHUNK_MIN_PLANES planes a CTA, the FAS 65^3 row's)
// and for blocks the chunk's layout cannot hold.
//
// Numerics: --fmad=false and Poisson.kernel_update's order (num = -f;
// num += (v[-1] + v[+1]) w_ax per axis, x first; num * inv_den), then the
// blend's own order, so both forms are bitwise the plain version
// (ops/cuda/masked_block.py masked_block_plain), every point of the block.

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil.cuh"  // split_update, row_grid, row_block, row_launch_ok

namespace {

// The blend of one point: c + m (upd - c), each step rounded on its own.
__device__ __forceinline__ float blend(float c, float px, float py, float pz,
                                       float f, float m, float w0, float w1,
                                       float w2, float inv_den) {
  const float upd = split_update(px, py, pz, f, w0, w1, w2, inv_den);
  const float d = upd - c;
  const float md = m * d;
  return c + md;
}

__global__ void masked_block_kernel(const float* __restrict__ v,
                                    const float* __restrict__ f,
                                    const float* __restrict__ m,
                                    float* __restrict__ out, int XB, int Y,
                                    int Z, float w0, float w1, float w2,
                                    float inv_den) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Z) return;
  const int y = blockIdx.y, x = blockIdx.z;
  const long long p = at(x, y, z, Y, Z);
  const float px = v[at(wrap_dec(x, XB), y, z, Y, Z)] +
                   v[at(wrap_inc(x, XB), y, z, Y, Z)];
  const float py = v[at(x, wrap_dec(y, Y), z, Y, Z)] +
                   v[at(x, wrap_inc(y, Y), z, Y, Z)];
  const float pz = v[at(x, y, wrap_dec(z, Z), Y, Z)] +
                   v[at(x, y, wrap_inc(z, Z), Y, Z)];
  out[p] = blend(v[p], px, py, pz, f[p], m[p], w0, w1, w2, inv_den);
}

// ops/cuda/masked_block.py MaskedChunkLayout: the chunk's launch
// geometry.  The block is cut into blocks of `planes` x planes by `rows`
// y rows (every z), CTA c = bx * yblocks + by owning block (bx, by).
struct MaskedChunkLayout {
  int ctas;        // xblocks * yblocks, at most one an SM, co-resident
  int planes;      // x planes of a block (<= kChunkMaxPlanes)
  int rows;        // y rows of a block
  int xblocks;     // blocks along x
  int yblocks;     // blocks along y
  int threads;     // rows * Z / 4, rounded up to a warp
  int smem_bytes;  // dynamic shared memory per CTA
};

constexpr int kChunkThreads = 512;
constexpr int kChunkMaxSmem = 232448;  // 227 KB, the most one CTA may hold
constexpr int kChunkMaxPlanes = 16;  // 4 mask bits a plane in 64
constexpr int kChunkMaxSweeps = 127;  // 2t half-sweeps in the epoch's byte

struct ChunkArgs {
  float* v;  // the (XB, Y, Z) block, updated in place
  const float* f;
  const float* mr;
  const float* mb;
  // the outboxes (null on one CTA): per CTA and half-sweep parity its
  // four faces (the block's first and last x planes, rows x Z words each,
  // and its first and last y rows, planes x Z words each), a word (epoch
  // << 32 | a point's float bits) for each point of the face
  unsigned long long* box;
  // [0]: the launches finished (the epoch's high bits), [1]: the CTAs of
  // this launch finished (back to 0 by the last one); null on one CTA
  unsigned* count;
  int XB, Y, Z, nsweeps;
  float w0, w1, w2, inv_den;
  MaskedChunkLayout lay;
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

__device__ __forceinline__ unsigned ld_count(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The four words of a z quad at p, loaded (and, after wait_quad, the
// quad once all four carry the epoch: read again until they do).
struct Words {
  unsigned long long w[4];
};

__device__ __forceinline__ void load_quad(const unsigned long long* p,
                                          Words& q) {
  // two 16-byte loads (each 8-byte word arrives whole)
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(q.w[0]), "=l"(q.w[1])
               : "l"(p)
               : "memory");
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(q.w[2]), "=l"(q.w[3])
               : "l"(p + 2)
               : "memory");
}

__device__ __forceinline__ float4 wait_quad(const unsigned long long* p,
                                            Words q, unsigned epoch) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    while ((unsigned)(q.w[k] >> 32) != epoch) {
      __nanosleep(32);
      q.w[k] = ld_word(p + k);
    }
  }
  return make_float4(__uint_as_float((unsigned)q.w[0]),
                     __uint_as_float((unsigned)q.w[1]),
                     __uint_as_float((unsigned)q.w[2]),
                     __uint_as_float((unsigned)q.w[3]));
}

// A quad's four words (epoch in the high halves) to p.
__device__ __forceinline__ void put_quad(unsigned long long* p,
                                         unsigned long long ep, float4 o) {
  // two 16-byte stores, no "memory" clobber: the compiler may move the
  // sweep's shared-memory loads across them (the volatile polls stay
  // after them, and a block barrier orders them against the next
  // half-sweep)
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};"
               :
               : "l"(p), "l"(ep | __float_as_uint(o.x)),
                 "l"(ep | __float_as_uint(o.y)));
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};"
               :
               : "l"(p + 2), "l"(ep | __float_as_uint(o.z)),
                 "l"(ep | __float_as_uint(o.w)));
}

// A chunk of nsweeps masked sweeps on the whole block (see the header).
// Thread (r, zq) owns the z quad (4 zq ... 4 zq + 3) of row r of every
// plane of its CTA's block.  Shared memory holds the block's v, each
// plane with a halo row before and after its rows (planes x (rows + 2) x
// Z: the rows past the block's, read at the first half-sweep), then its f
// (planes x rows x Z).
__global__ void __launch_bounds__(kChunkThreads, 1)
    masked_chunk_kernel(const __grid_constant__ ChunkArgs a) {
  extern __shared__ __align__(16) float sm[];
  const MaskedChunkLayout& L = a.lay;
  const int Z = a.Z, Zq = Z >> 2, Y = a.Y, XB = a.XB;
  const int PX = L.planes, JR = L.rows, XBk = L.xblocks, YBk = L.yblocks;
  const int HP = (JR + 2) * Z;  // floats of a plane of V
  float* const V = sm;
  const float* const F = sm + PX * HP;
  const int c = blockIdx.x, tid = threadIdx.x;
  const int bx = c / YBk, by = c - bx * YBk;
  const int x0 = bx * PX, np = min(PX, XB - x0);
  const int y0 = by * JR, nr = min(JR, Y - y0);
  // the x and y faces go through device memory where the block has
  // neighbours; otherwise its wraps are its own columns and rows
  const bool xs = XBk > 1, ys = YBk > 1;
  const long long S = (long long)Y * Z;  // floats of a plane of the block

  const int zq = tid % Zq, r = tid / Zq, z0 = 4 * zq;
  const bool active = r < nr;
  const int zm = (z0 + Z - 1) % Z, zp = (z0 + 4) % Z;  // z0 - 1, z0 + 4
  const int own = (r + 1) * Z + z0;  // this thread's quad in a plane of V
  // the rows above and below in a plane of V (row s of V is block row s
  // - 1; 0 and nr + 1 the halo rows, which take the y neighbours' faces)
  const int su = r == 0 ? (ys ? 0 : nr) : r;
  const int sd = r == nr - 1 ? (ys ? nr + 1 : 1) : r + 2;
  const long long gme = (long long)x0 * S + (long long)(y0 + r) * Z + z0;

  // outbox words: CTA cta, parity k, face f at (cta * 2 + k) * FW +
  // face(f) + (r or p) * Z + z
  const int FW = 2 * JR * Z + 2 * PX * Z;
  auto face = [&](int f) {
    return f < 2 ? f * JR * Z : 2 * JR * Z + (f - 2) * PX * Z;
  };
  const int cxl = ((bx + XBk - 1) % XBk) * YBk + by;
  const int cxh = ((bx + 1) % XBk) * YBk + by;
  const int cyl = bx * YBk + (by + YBk - 1) % YBk;
  const int cyh = bx * YBk + (by + 1) % YBk;
  // this launch's number: read by every CTA before the last one finishes
  const unsigned launch = a.box ? ld_count(a.count) : 0u;

  auto ld4 = [](const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  };
  auto v4 = [&](int at) -> float4& {
    return *reinterpret_cast<float4*>(V + at);
  };
  // the shared v, f and halo rows and the x neighbours past the block, from
  // the block's v and f; the column's masks as bits (bit 4 p + i: plane p,
  // point z0 + i), where every mask value of the CTA's block is exactly +0
  // or 1 (else the masks are read from device memory every half-sweep:
  // `mexact` is the CTA's)
  float4 xl = make_float4(0.0f, 0.0f, 0.0f, 0.0f), xh = xl;
  unsigned long long rbits = 0ull, bbits = 0ull;
  bool odd = false;  // a mask value other than +0 and 1
  if (active) {
#pragma unroll 4
    for (int p = 0; p < np; ++p) {
      v4(p * HP + own) = ld4(a.v + gme + p * S);
      *reinterpret_cast<float4*>(sm + PX * HP + (p * JR + r) * Z + z0) =
          ld4(a.f + gme + p * S);
      const float4 mr = ld4(a.mr + gme + p * S);
      const float4 mb = ld4(a.mb + gme + p * S);
      const float ms[8] = {mr.x, mr.y, mr.z, mr.w, mb.x, mb.y, mb.z, mb.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const unsigned u = __float_as_uint(ms[k]);
        odd |= u != 0u && u != 0x3f800000u;
        const unsigned long long bit = (unsigned long long)(u == 0x3f800000u)
                                       << (4 * p + (k & 3));
        if (k < 4) {
          rbits |= bit;
        } else {
          bbits |= bit;
        }
      }
    }
    if (xs) {
      const long long row = (long long)(y0 + r) * Z + z0;
      xl = ld4(a.v + ((x0 + XB - 1) % XB) * S + row);
      xh = ld4(a.v + ((x0 + np) % XB) * S + row);
    }
  }
  if (ys) {
    // the rows either side of the block, every plane and z quad
    for (int i = tid; i < 2 * np * Zq; i += blockDim.x) {
      const int side = i / (np * Zq), p = (i / Zq) % np, q = i % Zq;
      const int y = side ? (y0 + nr) % Y : (y0 + Y - 1) % Y;
      v4(p * HP + (side ? nr + 1 : 0) * Z + 4 * q) =
          ld4(a.v + (x0 + p) * S + (long long)y * Z + 4 * q);
    }
  }
  const bool mexact = !__syncthreads_or(odd);

  const int nh = 2 * a.nsweeps;
  for (int h = 0; h < nh; ++h) {
    const float* const m = (h & 1) ? a.mb : a.mr;
    const unsigned long long mk = (h & 1) ? bbits : rbits;
    // this half-sweep's words go out with epoch h + 1; the neighbours'
    // words of the half-sweep before carry h
    const unsigned long long ep =
        (unsigned long long)((launch << 8) | (h + 1)) << 32;
    const unsigned want = (launch << 8) | h;
    const bool pub = h + 1 < nh, take = h > 0;
    unsigned long long* const out =
        a.box ? a.box + (c * 2 + (h & 1)) * FW : nullptr;
    const unsigned long long* const in =
        a.box ? a.box + ((h + 1) & 1) * FW : nullptr;
    float4 oldl = xh, oldprev = xl;
    if (take && xs && active) {
      // the x neighbours' last and first planes, sent at the start of
      // their half-sweep before: every word requested, then waited for
      const unsigned long long* const il =
          in + cxl * 2 * FW + face(1) + r * Z + z0;
      const unsigned long long* const ih =
          in + cxh * 2 * FW + face(0) + r * Z + z0;
      Words wl, wh;
      load_quad(il, wl);
      load_quad(ih, wh);
      xl = wait_quad(il, wl, want);
      xh = wait_quad(ih, wh, want);
    }
    if (take && ys) {
      // the y neighbours' rows beside the block (the row above is the
      // upper neighbour's last, the row below the lower one's first),
      // every plane, into the halo rows: at most 2 quads a thread
      // (planes <= rows), every word requested before any is waited for
      const unsigned long long* src[2];
      int at[2];
      Words w[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = tid + k * blockDim.x;
        const int side = i / (np * Zq), p = (i / Zq) % np, q = i % Zq;
        src[k] = (side ? in + cyh * 2 * FW + face(2)
                       : in + cyl * 2 * FW + face(3)) +
                 p * Z + 4 * q;
        at[k] = p * HP + (side ? nr + 1 : 0) * Z + 4 * q;
        if (i < 2 * np * Zq) load_quad(src[k], w[k]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (tid + k * blockDim.x < 2 * np * Zq) {
          v4(at[k]) = wait_quad(src[k], w[k], want);
        }
      }
      __syncthreads();  // the halo rows in place
    }
    if (active) {
      oldl = v4((np - 1) * HP + own);  // plane np - 1 before the half-sweep
      if (!xs) {  // x wraps within the column
        xl = oldl;
        xh = v4(own);
      }
    }
    // plane p's new quad from the old values: xm and xp its x neighbours,
    // the rest from shared memory, the mask from the bits
    auto update = [&](int p, float4 xm, float4 cc, float4 xp) {
      const int pv = p * HP;
      const float4 up = v4(pv + su * Z + z0), dn = v4(pv + sd * Z + z0);
      const float wm = V[pv + (r + 1) * Z + zm];
      const float wp = V[pv + (r + 1) * Z + zp];
      const float4 fv =
          *reinterpret_cast<const float4*>(F + (p * JR + r) * Z + z0);
      float4 mv;
      if (mexact) {
        const unsigned b = (unsigned)(mk >> (4 * p)) & 15u;
        mv = make_float4(b & 1u ? 1.0f : 0.0f, b & 2u ? 1.0f : 0.0f,
                         b & 4u ? 1.0f : 0.0f, b & 8u ? 1.0f : 0.0f);
      } else {
        mv = ld4(m + gme + p * S);
      }
      // pair sums x, y, z (minus, plus), as torch.roll's rolls
      float4 o;
      o.x = blend(cc.x, xm.x + xp.x, up.x + dn.x, wm + cc.y, fv.x, mv.x,
                  a.w0, a.w1, a.w2, a.inv_den);
      o.y = blend(cc.y, xm.y + xp.y, up.y + dn.y, cc.x + cc.z, fv.y, mv.y,
                  a.w0, a.w1, a.w2, a.inv_den);
      o.z = blend(cc.z, xm.z + xp.z, up.z + dn.z, cc.y + cc.w, fv.z, mv.z,
                  a.w0, a.w1, a.w2, a.inv_den);
      o.w = blend(cc.w, xm.w + xp.w, up.w + dn.w, cc.z + wp, fv.w, mv.w,
                  a.w0, a.w1, a.w2, a.inv_den);
      if (pub) {
        if (xs && p == 0) put_quad(out + face(0) + r * Z + z0, ep, o);
        if (xs && p == np - 1) put_quad(out + face(1) + r * Z + z0, ep, o);
        if (ys && r == 0) put_quad(out + face(2) + p * Z + z0, ep, o);
        if (ys && r == nr - 1) put_quad(out + face(3) + p * Z + z0, ep, o);
      }
      return o;
    };
    // The planes two a step, each computed from the old values and written
    // once every thread has read the step's planes (a block barrier a
    // step; the x neighbours are the thread's own column, the old value
    // of a plane already written kept in a register): first np - 1 and 0
    // (both x faces early), then 1 and 2, 3 and 4, ... up to np - 2.
    float4 oa = xl, ob = xl;
    if (active) {
      oa = update(np - 1, np > 1 ? v4((np - 2) * HP + own) : xl, oldl, xh);
      if (np > 1) {
        const float4 c0 = v4(own);
        ob = update(0, xl, c0, np == 2 ? oldl : v4(HP + own));
        oldprev = c0;
      }
    }
    __syncthreads();  // every read of the step's old values done
    if (active) {
      v4((np - 1) * HP + own) = oa;
      if (np > 1) v4(own) = ob;
    }
    for (int p = 1; p + 1 < np; p += 2) {
      const bool two = p + 2 < np;  // planes p and p + 1
      if (active) {
        const float4 ca = v4(p * HP + own);
        const float4 cb = p + 1 == np - 1 ? oldl : v4((p + 1) * HP + own);
        oa = update(p, oldprev, ca, cb);
        oldprev = ca;
        if (two) {
          ob = update(p + 1, ca, cb,
                      p + 2 == np - 1 ? oldl : v4((p + 2) * HP + own));
          oldprev = cb;
        }
      }
      __syncthreads();  // every read of the step's old values done
      if (active) {
        v4(p * HP + own) = oa;
        if (two) v4((p + 1) * HP + own) = ob;
      }
    }
    // a plane written at a step is read by other threads at the next
    // half-sweep's step of the same plane: a barrier between where the
    // half-sweep has more than one step
    if (np <= 2) __syncthreads();
  }
  if (active) {
    for (int p = 0; p < np; ++p) {
      *reinterpret_cast<float4*>(a.v + gme + p * S) = v4(p * HP + own);
    }
  }
  // every CTA past its last read of an outbox before the launch number
  // moves on
  if (a.box) {
    __syncthreads();
    if (tid == 0 && atomicAdd(a.count + 1, 1u) == (unsigned)L.ctas - 1) {
      atomicExch(a.count + 1, 0u);  // the last one through
      atomicAdd(a.count, 1u);
    }
  }
}

bool chunk_valid(const MaskedChunkLayout& L, int XB, int Y, int Z) {
  if (XB < 1 || Y < 1 || Z < 4 || Z % 4) return false;
  const int Zq = Z / 4;
  if (L.planes < 1 || L.planes > kChunkMaxPlanes || L.rows < 1 ||
      L.rows > Y || (long long)L.rows * Zq > kChunkThreads) {
    return false;
  }
  if (L.yblocks != (Y + L.rows - 1) / L.rows) return false;
  if (L.xblocks != (XB + L.planes - 1) / L.planes) return false;
  if (L.ctas != L.xblocks * L.yblocks) return false;
  if (L.threads != (L.rows * Zq + 31) / 32 * 32) return false;
  // a thread takes at most 2 quads of the y halo rows
  if (L.yblocks > 1 && L.planes > L.rows) return false;
  // v with its halo rows, and f
  const long long smem = 4LL * L.planes * Z * (2 * L.rows + 2);
  return L.smem_bytes == smem && smem <= kChunkMaxSmem;
}

}  // namespace

extern "C" {

// out = v + m * (Poisson.kernel_update(v, f) - v) on the (XB, Y, Z) block,
// one colour (m its mask); out must not alias v.
int pdemg_masked_block(const float* v, const float* f, const float* m,
                       float* out, int XB, int Y, int Z, float w0, float w1,
                       float w2, float inv_den, void* stream) {
  if (!row_launch_ok(XB, Y)) return (int)cudaErrorInvalidConfiguration;
  masked_block_kernel<<<row_grid(XB, Y, Z), row_block(Z), 0,
                        (cudaStream_t)stream>>>(v, f, m, out, XB, Y, Z, w0,
                                                w1, w2, inv_den);
  return (int)cudaGetLastError();
}

// nsweeps masked sweeps (red then black) of the (XB, Y, Z) block v, in
// place, one cooperative launch on the layout `lay`
// (masked_block.chunk_layout); box: lay->ctas * 2 * 2 (rows + planes) * Z
// words and count: 2 counters, zero when first used (and never to be
// cleared: see the header), both null when lay->ctas is 1.  Default
// visibility spelled out: the host compiler hides a function whose body
// launches a kernel taking a type of this file's unnamed namespace.
__attribute__((visibility("default"))) int pdemg_masked_chunk(
    const MaskedChunkLayout* lay, float* v, const float* f, const float* mr,
    const float* mb, unsigned long long* box, unsigned* count, int XB,
    int Y, int Z, int nsweeps, float w0, float w1, float w2, float inv_den,
    void* stream) {
  if (!lay || nsweeps < 1 || nsweeps > kChunkMaxSweeps ||
      !chunk_valid(*lay, XB, Y, Z)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((lay->ctas > 1) != (box != nullptr) || (box == nullptr) != (count ==
                                                                  nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* ptrs[4] = {v, f, mr, mb};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  }
  static const cudaError_t opted = cudaFuncSetAttribute(  // once, outside
      masked_chunk_kernel,                                 // any capture
      cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkMaxSmem);
  if (opted != cudaSuccess) return (int)opted;
  ChunkArgs args = {v, f, mr, mb, box, count, XB, Y, Z, nsweeps,
                    w0, w1, w2, inv_den, *lay};
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, masked_chunk_kernel, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
