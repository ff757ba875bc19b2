// Time-skewed red-black Gauss-Seidel on 3D wrap-storage halves, T sweeps
// per launch (sm_90a).
//
// Replaces the TPU kernels
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_timeskew_relax     (whole half-planes)
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_timeskew_relax_jb  (j-blocked)
// Both compute one function: from the black half b and the RHS halves
// fr, fb of a level in the halves layout (X, Y/2, Z) (q = (x + z) % 2, red
// at y = 2j + q, black at y = 2j + 1 - q), the (r, b) halves after T
// red->black sweeps, every update written as `ok ? upd : 0` (the masks of
// relax.py:1117-1151).  So the red input is never read, plane 0 of both
// outputs is zero, plane 0 of b and the plane past X - 1 read as zero, and
// the j and z wrap reads land on zero or masked points.  The TPU's split
// into two kernels is a VMEM budget (whole half-planes stop fitting at
// 513^3); a Hopper block holds neither, so one kernel serves both, with T
// a template parameter.
//
// What bounds it: float32 operations.  Per launch it reads b, fr and fb
// once and writes r and b once: 20 B per halves point, 10 B per dense
// point, for T sweeps (the half-sweep kernel moves ~16 B per halves point
// per half-sweep).  A 100-sweep leg at 256^3 must move 168 MB (50 us at
// 3.35 TB/s) but does 2.18e10 operations, 13 per update (0.33 ms at
// 67 TFLOP/s); at 512^3 0.40 and 2.6 ms.  The redundant halo adds to the
// operations, and instruction issue and the per-step barrier to the time
// (PERF.md): the design below spends its effort on instructions per point.
//
// Design (2.5D blocking with halo recompute).  A CTA is a window of
// kWZ x kWJ (z, j) columns: kWJ warps, one per row j, each lane holding
// two neighbouring z points (8-byte loads and stores).  It walks an x
// range [x0, x1) with the TPU kernels' time-skew schedule: at step t,
// level L (0: the input black; 2s - 1: red of sweep s; 2s: black of sweep
// s) finishes plane t - L, so red_s is at t - 2s + 1 and black_s at t - 2s
// (relax.py:1633-1678).  A thread keeps the last three planes of its two
// columns of every level in registers (the x - 1, x and x + 1
// neighbours); the z neighbours come from the neighbouring lanes by warp
// shuffles; the j neighbours from one shared-memory tile per level that
// holds the plane the level finished at the previous step,
// double-buffered by step parity: every neighbour a step reads was written
// a step earlier, so one barrier per step serves all 2T updates.  The
// global loads of a step (the input plane and each level's RHS value) are
// issued a step early, so their latency overlaps a step of arithmetic.
// Steps whose planes all lie inside [1, X - 1] take a body without range
// checks.  A half-sweep reads +-1 in j and z, so the exact region shrinks
// by one column per level from the window's edges, and only the central
// (kWZ - 4T) x (kWJ - 4T) columns of the last two levels are written out.
// The window's coordinates wrap modulo Y/2 and Z, so a window at the
// level's edge reads the real wrapped neighbours, as torch.roll does.  x
// does not wrap: planes outside [1, X - 1] are zero, and a chunk that
// starts at x0 > 0 begins 2T planes early, computing planes that only its
// own discarded region reads; the x chunks are sized to fill the card's
// resident CTAs.  Redundant work: kWZ kWJ / ((kWZ - 4T)(kWJ - 4T)) in
// (j, z) and (x1 - x0 + 4T) / (x1 - x0) in x.  Later work: a TMA or
// cp.async prefetch of whole planes, and warp specialisation.
//
// Numerics: built with --fmad=false and Poisson.split_update's order
// (stencil.cuh), so the result is bitwise the plain PyTorch version's
// (ops/cuda/relax.py timeskew_sweeps_plain) and does not depend on T, the
// window or the x chunks.  Element offsets are 32-bit: the wrapper refuses
// a level whose (X + 16) Y/2 Z reaches 2^31 (beyond 80 GB in any case).
// Z is even and the halves 8-byte aligned (checked by the wrapper).

#include <cuda_runtime.h>

#include <type_traits>

#include "stencil.cuh"  // split_update

namespace {

constexpr int kLanes = 32;         // threads along z, two points each
constexpr int kWZ = 2 * kLanes;    // window columns along z
constexpr int kWJ = 24;            // window rows along j: one warp each
constexpr int kThreads = kLanes * kWJ;
constexpr int kTile = kWZ * kWJ;   // floats per shared-memory tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap_mod(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
    timeskew_kernel(const float* __restrict__ b_in,
                    const float* __restrict__ fr,
                    const float* __restrict__ fb, float* __restrict__ r_out,
                    float* __restrict__ b_out, int X, int Y2, int Z, int Lx,
                    int v_zero, float w0, float w1, float w2,
                    float inv_den) {
  constexpr int H = 2 * T;         // levels after the input; halo per side
  constexpr int NL = H + 1;        // levels 0 .. 2T
  constexpr int BZ = kWZ - 2 * H;  // owned columns
  constexpr int BJ = kWJ - 2 * H;
  // tiles[(level * 2 + parity) * kTile + (row * 2 + point) * kLanes +
  // lane], levels 0 .. 2T - 1 (the last level is only written out): each
  // point's 32 lanes contiguous, so no load or store has a bank conflict
  extern __shared__ float tiles[];

  const int lane = threadIdx.x, row = threadIdx.y;
  const int zo = blockIdx.x * BZ + 2 * lane - H;  // unwrapped, even
  const int jo = blockIdx.y * BJ + row - H;
  const int zg = wrap_mod(zo, Z), jg = wrap_mod(jo, Y2);  // point 1: zg + 1
  // each point of the level is owned by exactly one thread of the grid
  const bool owned = 2 * lane >= H && 2 * lane < H + BZ && row >= H &&
                     row < H + BJ && zo < Z && jo < Y2;
  const int x0 = blockIdx.z * Lx;
  const int x1 = min(x0 + Lx, X);
  const int plane = Y2 * Z;
  const int col = jg * Z + zg;

  // tile offsets of point 0 of this thread and of the rows j + 1 and
  // j - 1, clamped at the window's edge (rows outside the exact region)
  const int me = row * kWZ + lane;
  const int up = (row < kWJ - 1 ? row + 1 : row) * kWZ + lane;
  const int dn = (row > 0 ? row - 1 : row) * kWZ + lane;
  const bool z_ok = zg >= 1, j_ok = jg >= 1;

  for (int k = row * kLanes + lane; k < 2 * H * kTile; k += kThreads)
    tiles[k] = 0.0f;

  // in_[0]: b at plane tn; in_[l]: level l's RHS (fr for red, fb for
  // black) at plane tn - l; zero outside [1, X - 1]
  float2 in_[NL];
  auto prefetch = [&](int tn, auto checked) {
    constexpr bool kChecked = decltype(checked)::value;
    const float2 zero = make_float2(0.0f, 0.0f);
    int off = tn * plane + col;
    in_[0] = (!v_zero && (!kChecked || (tn >= 1 && tn <= X - 1)))
                 ? load2(b_in + off) : zero;
#pragma unroll
    for (int l = 1; l < NL; ++l) {
      off -= plane;
      const int x = tn - l;
      in_[l] = (!kChecked || (x >= 1 && x <= X - 1))
                   ? load2(((l & 1) ? fr : fb) + off) : zero;
    }
  };
  prefetch(x0 - H, std::true_type{});
  __syncthreads();

  // per level and point: planes t - L - 2 (lo), t - L - 1 (mid), t - L (hi)
  float lo0[NL], mid0[NL], hi0[NL], lo1[NL], mid1[NL], hi1[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l)
    lo0[l] = mid0[l] = hi0[l] = lo1[l] = mid1[l] = hi1[l] = 0.0f;

  auto step = [&](int t, auto checked) {
    constexpr bool kChecked = decltype(checked)::value;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      lo0[l] = mid0[l];
      mid0[l] = hi0[l];
      lo1[l] = mid1[l];
      mid1[l] = hi1[l];
    }
    float2 rhs[NL];
#pragma unroll
    for (int l = 0; l < NL; ++l) rhs[l] = in_[l];
    prefetch(t + 1, checked);
    const int pw = t & 1, pr = pw ^ 1;
    hi0[0] = rhs[0].x;
    hi1[0] = rhs[0].y;
    // point 0's planes of this step: black q = q0, red 1 - q0; point 1
    // the opposite.  A point with black q == 1 takes the y-pair partner
    // j - 1 in both colours, one with q == 0 j + 1, and both colours share
    // the mask `z >= 1 and (j >= 1 or q == 0)`
    const int q0 = (t + zg) & 1;
    const int y0 = q0 ? dn : up;
    const int y1 = (q0 ? up : dn) + kLanes;
    const bool ok0 = z_ok && (j_ok || !q0);
    const bool ok1 = j_ok || q0;  // z = zg + 1 >= 1
#pragma unroll
    for (int l = 1; l < NL; ++l) {
      const int x = t - l;
      float u0 = 0.0f, u1 = 0.0f;
      if (!kChecked || (x >= 1 && x <= X - 1)) {  // uniform across the CTA
        // level l - 1 at plane x, finished at the previous step
        const float* src = tiles + ((l - 1) * 2 + pr) * kTile;
        const float c0 = mid0[l - 1], c1 = mid1[l - 1];
        // z - 1 of point 0: the left lane's point 1; z + 1 of point 1: the
        // right lane's point 0 (the window's edge lanes read their own)
        const float zl = __shfl_up_sync(kFull, c1, 1);
        const float zr = __shfl_down_sync(kFull, c0, 1);
        const float px0 = lo0[l - 1] + hi0[l - 1];
        const float px1 = lo1[l - 1] + hi1[l - 1];
        const float py0 = c0 + src[y0];
        const float py1 = c1 + src[y1];
        const float pz0 = zl + c1;
        const float pz1 = c0 + zr;
        const float v0 =
            split_update(px0, py0, pz0, rhs[l].x, w0, w1, w2, inv_den);
        const float v1 =
            split_update(px1, py1, pz1, rhs[l].y, w0, w1, w2, inv_den);
        u0 = ok0 ? v0 : 0.0f;
        u1 = ok1 ? v1 : 0.0f;
      }
      hi0[l] = u0;
      hi1[l] = u1;
    }
    if (owned) {
      const int xr = t - (H - 1), xb = t - H;
      if (xr >= x0 && xr < x1)
        *reinterpret_cast<float2*>(r_out + xr * plane + col) =
            make_float2(hi0[H - 1], hi1[H - 1]);
      if (xb >= x0 && xb < x1)
        *reinterpret_cast<float2*>(b_out + xb * plane + col) =
            make_float2(hi0[H], hi1[H]);
    }
#pragma unroll
    for (int l = 0; l < H; ++l) {
      float* dst = tiles + (l * 2 + pw) * kTile + me;
      dst[0] = hi0[l];
      dst[kLanes] = hi1[l];
    }
    __syncthreads();
  };

  for (int t = x0 - H; t < x1 + H; ++t) {
    // planes t + 1 - 2T .. t + 1 (this step's and the prefetch's) inside
    // [1, X - 1]: no range checks
    if (t >= H + 1 && t <= X - 2)
      step(t, std::false_type{});
    else
      step(t, std::true_type{});
  }
}

// The x chunks per tile column: the count that minimises waves x steps,
// with `slots` CTAs resident on the card at once and a chunk of Lx planes
// taking Lx + 4T steps.
inline int x_chunks(int X, int tiles, int T, int slots) {
  int best = 1;
  long long best_cost = -1;
  for (int c = 1; c <= X; ++c) {
    const int lx = (X + c - 1) / c;
    if ((X + lx - 1) / lx != c) continue;  // the same chunks as a smaller c
    const long long waves = ((long long)tiles * c + slots - 1) / slots;
    const long long cost = waves * (lx + 4 * T);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

template <int T>
int launch(const float* b, const float* fr, const float* fb, float* r,
           float* bo, int X, int Y2, int Z, int v_zero, float w0, float w1,
           float w2, float inv_den, cudaStream_t stream) {
  constexpr int H = 2 * T;
  constexpr int BZ = kWZ - 2 * H, BJ = kWJ - 2 * H;
  constexpr int smem = 2 * H * kTile * (int)sizeof(float);
  static bool opted_in = false;  // once per process, outside any capture
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        timeskew_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  static int slots = 0;  // resident CTAs on the card
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, timeskew_kernel<T>, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
  }
  if (Z % 2) return (int)cudaErrorInvalidValue;
  const int gz = (Z + BZ - 1) / BZ, gj = (Y2 + BJ - 1) / BJ;
  if (gj > 65535) return (int)cudaErrorInvalidConfiguration;
  const int chunks = x_chunks(X, gz * gj, T, slots);
  const int Lx = (X + chunks - 1) / chunks;
  timeskew_kernel<T><<<dim3(gz, gj, chunks), dim3(kLanes, kWJ), smem,
                       stream>>>(b, fr, fb, r, bo, X, Y2, Z, Lx, v_zero, w0,
                                 w1, w2, inv_den);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (r, bo) = T red->black sweeps from the black half b (not read when
// v_zero: b = 0) and the RHS halves (fr, fb), Z even.  T = 2 is the
// wrapper's (relax.TIMESKEW_T, from an A/B on the card, PERF.md); T = 1
// serves the remainder launch of an odd leg.
int pdemg_timeskew(const float* b, const float* fr, const float* fb,
                   float* r, float* bo, int X, int Y2, int Z, int T,
                   int v_zero, float w0, float w1, float w2, float inv_den,
                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (T) {
    case 1:
      return launch<1>(b, fr, fb, r, bo, X, Y2, Z, v_zero, w0, w1, w2,
                       inv_den, s);
    case 2:
      return launch<2>(b, fr, fb, r, bo, X, Y2, Z, v_zero, w0, w1, w2,
                       inv_den, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
