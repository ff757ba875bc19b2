// One zebra line half-sweep on a 2D or 3D Poisson level (sm_90a): every
// line of one colour solved exactly along its line axis, in one launch.
//
// Replaces no Pallas kernel.  The JAX package runs line relaxation on its
// jnp tier: pde_multigrid_tpu/ops/stencil.py thomas_tridiagonal (host
// coefficient branch, a lax.scan of one multiply-add a point and row) and
// relax_zebra_line, with Poisson.line_system building each line's right
// side.  Written as plain PyTorch on the card, a half-sweep is a few
// launches a row of the line (about 1 500 at 257^3); this kernel is one.
// It computes, for the lines of colour c (their coordinate on the zebra
// axis has parity c) whose off-line coordinates are interior:
//
//   d  = f - (v[z-1] + v[z+1]) w_z - (v[t-1] + v[t+1]) w_t   (axis order)
//   d  = v + (d - v)  on interior rows of the line, v on the others
//   dp = alpha_i dp + beta_i d                            (forward, i up)
//   x  = dp - cp_i x                                      (backward, i down)
//   v  = v + (x - v)  on interior rows of the line
//
// with alpha, beta, cp the per-row constants of the host recurrence
// (ops/stencil.py thomas_coefficients, float64 cast to float32), in
// exactly the plain version's operation order; built with --fmad=false it
// agrees with relax_zebra_line bit for bit (up to the sign of a zero the
// plain blend writes on masked points).  Lines of the other colour and
// lines on the boundary or padding are not written: the plain blend leaves
// them as they were.
//
// Same-colour neighbours.  The zebra axis is (line + 1) % ndim; in 3D the
// lines next to a line along the third axis have its colour and are
// solved in the same half-sweep, from the old v (a Jacobi step along that
// axis).  One thread solves one line: its forward pass reads v and writes
// dp into a scratch array, its backward pass reads dp and writes v.  A
// line's v is read by its own thread and by the two lines beside it on
// the third axis, nothing else (the zebra-axis neighbours are the other
// colour's, which nobody writes).  So each CTA holds whole columns of
// lines along the third axis, and one block barrier between the passes
// lets every read of the old v happen before any write: the launch is in
// place, with no second copy of v.
//
// Bytes and operations a half-sweep: the function reads all of v (its
// own lines and their neighbour lines) and the colour's f and writes the
// colour's v: about 8 B a point, 136 MB at 257^3 (40.5 us at 3.35 TB/s).
// The kernel also writes and reads dp for the colour's points (4 B a
// point more, mostly in the L2) and reads the colour's v twice.  About
// 12 float operations a point.  Design: one thread a line, neighbouring
// threads on neighbouring lines of the third axis (the major axis z for
// line-0 in 3D: coalesced loads), a line's steps unrolled so several rows'
// loads are in flight; the per-row constants through the read-only cache
// (every thread of a warp reads the same row).  Nothing bounds it but the
// walk: a line's n rows are n dependent steps, and the small levels are a
// launch each.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

// ops/cuda/zebra_line.py ZebraLineParams
struct ZebraLineParams {
  int n_line;          // points along the line axis
  int s_line;          // its stride, floats
  int row_lo, row_hi;  // its interior rows (the others: identity rows)
  int n_zeb, s_zeb;    // the zebra axis: extent, stride
  int zeb0;            // the colour's first interior zebra coordinate
  int n_zeb_lines;     // its interior zebra coordinates zeb0, zeb0 + 2, ...
  int n_thr, s_thr;    // the third axis (3D): extent, stride
  int thr0;            // its first interior coordinate
  int n_thr_lines;     // its interior coordinates (2D: 1)
  int zeb_term_first;  // 1: the zebra axis precedes the third in axis order
  int lines_per_cta;   // whole columns: a multiple of n_thr_lines
  int threads;         // threads a CTA
  int ctas;            // CTAs of the launch
  float w_zeb, w_thr;  // 1/h^2 of the zebra and third axes
};

struct Line {
  long long base;  // offset of the line's row 0
  long long zm, zp, tm, tp;  // neighbour offsets along zebra and third axes
};

__device__ __forceinline__ Line line_of(long long g,
                                        const ZebraLineParams& p) {
  const int j = (int)(g / p.n_thr_lines);
  const int t = (int)(g - (long long)j * p.n_thr_lines);
  const int zc = p.zeb0 + 2 * j;
  const int tc = p.thr0 + t;
  Line L;
  L.base = (long long)zc * p.s_zeb + (long long)tc * p.s_thr;
  // interior coordinates are >= 1; the last one wraps to the zero plane
  // in wrap storage, as torch.roll does
  L.zm = -(long long)p.s_zeb;
  L.zp = zc + 1 == p.n_zeb ? -(long long)(p.n_zeb - 1) * p.s_zeb
                           : (long long)p.s_zeb;
  L.tm = -(long long)p.s_thr;
  L.tp = tc + 1 == p.n_thr ? -(long long)(p.n_thr - 1) * p.s_thr
                           : (long long)p.s_thr;
  return L;
}

template <int NDIM>
__device__ __forceinline__ void forward(const float* v,
                                        const float* __restrict__ f,
                                        float* __restrict__ dp_buf,
                                        const float* __restrict__ alpha,
                                        const float* __restrict__ beta,
                                        const Line& L,
                                        const ZebraLineParams& p) {
  float dp = 0.0f;
#pragma unroll 4
  for (int i = 0; i < p.n_line; ++i) {
    const long long at = L.base + (long long)i * p.s_line;
    const float vc = __ldg(v + at);
    float d = __ldg(f + at);
    const float pz = __ldg(v + at + L.zm) + __ldg(v + at + L.zp);
    if (NDIM == 3) {
      const float pt = __ldg(v + at + L.tm) + __ldg(v + at + L.tp);
      if (p.zeb_term_first) {
        d = d - pz * p.w_zeb;
        d = d - pt * p.w_thr;
      } else {
        d = d - pt * p.w_thr;
        d = d - pz * p.w_zeb;
      }
    } else {
      d = d - pz * p.w_zeb;
    }
    const bool inter = i >= p.row_lo && i <= p.row_hi;
    const float dr = inter ? vc + (d - vc) : vc;
    const float a = __ldg(alpha + i) * dp;
    const float b = __ldg(beta + i) * dr;
    dp = a + b;
    dp_buf[at] = dp;
  }
}

__device__ __forceinline__ void backward(float* v,
                                         const float* __restrict__ dp_buf,
                                         const float* __restrict__ cp,
                                         const Line& L,
                                         const ZebraLineParams& p) {
  float x = 0.0f;
#pragma unroll 4
  for (int i = p.n_line - 1; i >= 0; --i) {
    const long long at = L.base + (long long)i * p.s_line;
    const float c = __ldg(cp + i) * x;
    x = dp_buf[at] - c;
    if (i >= p.row_lo && i <= p.row_hi) {
      const float vc = v[at];
      v[at] = vc + (x - vc);
    }
  }
}

template <int NDIM>
__global__ void __launch_bounds__(kMaxThreads)
    zebra_line_kernel(float* v, const float* __restrict__ f,
                      float* __restrict__ dp_buf,
                      const float* __restrict__ coef,
                      const __grid_constant__ ZebraLineParams p) {
  const float* alpha = coef;
  const float* beta = coef + p.n_line;
  const float* cp = coef + 2 * p.n_line;
  const long long total = (long long)p.n_zeb_lines * p.n_thr_lines;
  const long long first = (long long)blockIdx.x * p.lines_per_cta;
  for (int li = threadIdx.x; li < p.lines_per_cta; li += blockDim.x) {
    const long long g = first + li;
    if (g >= total) break;
    forward<NDIM>(v, f, dp_buf, alpha, beta, line_of(g, p), p);
  }
  // every old value of this CTA's lines read before any is written
  __syncthreads();
  for (int li = threadIdx.x; li < p.lines_per_cta; li += blockDim.x) {
    const long long g = first + li;
    if (g >= total) break;
    backward(v, dp_buf, cp, line_of(g, p), p);
  }
}

bool valid(const ZebraLineParams& p, int ndim) {
  if (ndim != 2 && ndim != 3) return false;
  if (p.n_line < 1 || p.s_line < 1) return false;
  if (p.row_lo < 0 || p.row_hi >= p.n_line) return false;
  if (p.n_zeb < 2 || p.s_zeb < 1 || p.zeb0 < 1 || p.n_zeb_lines < 1) {
    return false;
  }
  if (p.zeb0 + 2LL * (p.n_zeb_lines - 1) > p.n_zeb - 1) return false;
  if (ndim == 3) {
    if (p.n_thr < 2 || p.s_thr < 1 || p.thr0 < 1 || p.n_thr_lines < 1 ||
        p.thr0 + (long long)p.n_thr_lines - 1 > p.n_thr - 1) {
      return false;
    }
  } else if (p.n_thr != 1 || p.s_thr != 0 || p.thr0 != 0 ||
             p.n_thr_lines != 1) {
    return false;
  }
  // whole columns of lines along the third axis in each CTA
  if (p.lines_per_cta < 1 || p.lines_per_cta % p.n_thr_lines) return false;
  if (p.threads < 32 || p.threads > kMaxThreads || p.threads % 32) {
    return false;
  }
  const long long total = (long long)p.n_zeb_lines * p.n_thr_lines;
  if ((long long)p.ctas * p.lines_per_cta < total ||
      (long long)(p.ctas - 1) * p.lines_per_cta >= total) {
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

// One half-sweep of colour `p->zeb0 % 2` on the level v (in place), f, the
// scratch dp (v's shape) and coef = alpha | beta | cp (n_line floats each),
// all device memory; ndim 2 or 3.  A CUDA error code.
__attribute__((visibility("default"))) int pdemg_zebra_line(
    float* v, const float* f, float* dp, const float* coef,
    const ZebraLineParams* p, int ndim, void* stream) {
  if (!valid(*p, ndim)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ndim == 3) {
    zebra_line_kernel<3><<<p->ctas, p->threads, 0, s>>>(v, f, dp, coef, *p);
  } else {
    zebra_line_kernel<2><<<p->ctas, p->threads, 0, s>>>(v, f, dp, coef, *p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
