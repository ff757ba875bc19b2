// Reduced-system (black-only) red-black Gauss-Seidel on padded 2D Lyapunov
// levels (sm_90a): one chunk of T red+black sweeps per launch, halves in,
// halves out.
//
// Replaces the TPU kernel
//   pde_multigrid_tpu/ops/pallas/relax.py:make_split_reduced_slab_2d
//
// Layout: the halves of csrc/relax2d.cu, (X, Y2) each, Y2 = ceil(Y/2); with
// q = x % 2, red at y = 2j + q, black at y = 2j + 1 - q.  Lyapunov's stencil
// is one-sided (a red point reads B[x+1, j] and B[x, j+q], a black one
// R[x+1, j] and R[x, j+1-q]), so red-black Gauss-Seidel is bipartite: one
// whole red+black sweep is the black-only update
//
//   b <- Cxx B[x+2, j] + Cxy B[x+1, j+1-q] + Cyy B[x, j+1] + Cf
//
// with sweep-invariant fields built once per launch from the coefficients
// of lyapunov2d.cuh at the black point, its red east neighbour (x+1, y)
// and its red south neighbour (x, y+1), the red interior masks folded in,
// the masked (Dirichlet) red values and the RHS terms folded into Cf
// (relax.py:3296-3331).  Masked blacks are held by the mask fold
// m_b*upd + (1 - m_b)*b0.  Red is rebuilt once, at the end, from the black
// state one sweep before the last (b_prev): after T sweeps Gauss-Seidel
// leaves r_T = R(b_{T-1}) (relax.py:3341-3358).  Every product and sum is
// the Pallas kernel's, in its order; with --fmad=false the kernel equals
// its plain version (ops/cuda/reduced2d.reduced_slab2d_plain) bit for bit.
// Reads past row X or slot Y2 take 0, what JAX's zero padding holds there:
// only masked points and terms with a zero coefficient read them.
//
// Design: one CTA owns a kBX x kBJ tile of black points.  It loads the
// tile with a one-sided halo, 2T rows on +x and T slots on +j (a sweep
// reads x+2, x+1 and j+1), into shared memory, builds the six fields of
// every loaded point there, and runs the sweeps between two black buffers
// in turn, one barrier a sweep.  A sweep leaves exact values two rows and
// one slot further from the far edges than the last, so sweep s (from 0)
// computes only the rows < LX - 2(s+1) and slots < LJ - (s+1) the later
// sweeps read; the last one computes the owned points, whose red it
// rebuilds from b_prev.  The output halves are apart from the inputs:
// tiles read rows that other tiles own.  T is a run-time loop bound.
//
// What bounds it: per point and chunk it reads r, b (and fr, fb) once and
// writes r and b (16 B f-less, 24 B with f), plus the halo
// ((kBX + 2T)(kBJ + T) / (kBX kBJ) = 1.69 at T = 8); per point and sweep
// 6 float operations, per point and chunk three coefficient evaluations
// (three IEEE divisions) and the fields.  Making it fast (wider tiles,
// fields in registers, TMA loads) is later work.

#include <cuda_runtime.h>

#include "lyapunov2d.cuh"  // Lyap2D, Coef, lyap_coef

namespace {

constexpr int kBX = 32;  // owned rows of a tile
constexpr int kBJ = 64;  // owned half slots of a tile
constexpr int kThreads = 256;
constexpr int kMaxT = 16;  // 8 fields of (32 + 32)(64 + 16) floats: 160 KB
constexpr int kFields = 8;  // two black buffers, Cxx, Cxy, Cyy, Cf, m_b, c_bk

inline size_t smem_bytes(int T) {
  return (size_t)kFields * (kBX + 2 * T) * (kBJ + T) * sizeof(float);
}

// a[x, j], or 0 past the last row or slot
__device__ __forceinline__ float at0(const float* __restrict__ a, int x,
                                     int j, int X, int Y2) {
  return (x < X && j < Y2) ? a[(long long)x * Y2 + j] : 0.0f;
}

__device__ __forceinline__ float mask(bool ok) { return ok ? 1.0f : 0.0f; }

template <bool WITH_F>
__global__ void __launch_bounds__(kThreads)
    reduced2d_kernel(const float* __restrict__ r, const float* __restrict__ b,
                     const float* __restrict__ fr,
                     const float* __restrict__ fb, float* __restrict__ ro,
                     float* __restrict__ bo, int X, int Y2, int T, Lyap2D p) {
  extern __shared__ float sm[];
  const int LX = kBX + 2 * T;
  const int LJ = kBJ + T;
  const int n = LX * LJ;
  float* cur = sm;
  float* nxt = sm + n;
  float* cxx = sm + 2 * n;
  float* cxy = sm + 3 * n;
  float* cyy = sm + 4 * n;
  float* cf = sm + 5 * n;
  float* mb = sm + 6 * n;
  float* cbk = sm + 7 * n;
  const int x0 = blockIdx.y * kBX;
  const int j0 = blockIdx.x * kBJ;

  // the fields of every loaded point (relax.py:3266-3331)
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lx = i / LJ;
    const int lj = i - lx * LJ;
    const int x = x0 + lx;
    const int j = j0 + lj;
    if (x >= X || j >= Y2) {  // past the level: 0, and it stays 0
      cur[i] = cxx[i] = cxy[i] = cyy[i] = cf[i] = mb[i] = cbk[i] = 0.0f;
      continue;
    }
    const int q = x & 1;
    const int yb = 2 * j + 1 - q;
    const bool okx = x >= 1 && x <= p.nx - 2;
    const bool oky_b = yb >= 1 && yb <= p.ny - 2;
    const float m_b = mask(okx && oky_b);
    const float m_rE = mask(x + 1 >= 1 && x + 1 <= p.nx - 2 && oky_b);
    const float m_rS = mask(okx && yb + 1 >= 1 && yb + 1 <= p.ny - 2);
    const Coef cb = lyap_coef(x, yb, p);
    const Coef cE = lyap_coef(x + 1, yb, p);
    const Coef cS = lyap_coef(x, yb + 1, p);
    const float aeE = cb.ae * m_rE;
    const float asS = cb.as * m_rS;
    cxx[i] = aeE * cE.ae;
    cxy[i] = aeE * cE.as + asS * cS.ae;
    cyy[i] = asS * cS.as;
    // the masked red neighbours' values: R[x+1, j] and R[x, j+1-q]
    const int js = q ? j : j + 1;
    float c = (cb.ae * (1.0f - m_rE)) * at0(r, x + 1, j, X, Y2);
    c = c + (cb.as * (1.0f - m_rS)) * at0(r, x, js, X, Y2);
    if (WITH_F) {
      float t = (aeE * cE.af) * at0(fr, x + 1, j, X, Y2);
      t = t + (asS * cS.af) * at0(fr, x, js, X, Y2);
      t = t + cb.af * fb[(long long)x * Y2 + j];
      c = c + t;
    }
    cf[i] = c;
    const float b0 = b[(long long)x * Y2 + j];
    mb[i] = m_b;
    cbk[i] = (1.0f - m_b) * b0;
    cur[i] = b0;
  }
  __syncthreads();

  // the sweeps before the last, each on the rows and slots later ones read
  for (int s = 0; s + 1 < T; ++s) {
    const int RX = LX - 2 * (s + 1);
    const int RJ = LJ - (s + 1);
    for (int i = threadIdx.x; i < RX * RJ; i += blockDim.x) {
      const int lx = i / RJ;
      const int lj = i - lx * RJ;
      const int k = lx * LJ + lj;
      const int q = (x0 + lx) & 1;
      const float bxy = q ? cur[k + LJ] : cur[k + LJ + 1];
      float u = cxx[k] * cur[k + 2 * LJ];
      u = u + cxy[k] * bxy;
      u = u + cyy[k] * cur[k + 1];
      u = u + cf[k];
      nxt[k] = mb[k] * u + cbk[k];
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
    __syncthreads();
  }

  // the last sweep on the owned points, from cur = b_prev, and the red
  // rebuilt from b_prev (relax.py:3341-3358)
  for (int i = threadIdx.x; i < kBX * kBJ; i += blockDim.x) {
    const int lx = i / kBJ;
    const int lj = i - lx * kBJ;
    const int x = x0 + lx;
    const int j = j0 + lj;
    if (x >= X || j >= Y2) continue;
    const int k = lx * LJ + lj;
    const int q = x & 1;
    const float bxy = q ? cur[k + LJ] : cur[k + LJ + 1];
    float u = cxx[k] * cur[k + 2 * LJ];
    u = u + cxy[k] * bxy;
    u = u + cyy[k] * cur[k + 1];
    u = u + cf[k];
    const long long g = (long long)x * Y2 + j;
    bo[g] = mb[k] * u + cbk[k];
    const int yr = 2 * j + q;
    const float m_r =
        mask(x >= 1 && x <= p.nx - 2 && yr >= 1 && yr <= p.ny - 2);
    const Coef cr = lyap_coef(x, yr, p);
    // east (x+1, y): B[x+1, j]; south (x, y+1): B[x, j+q]
    float ru = cr.ae * cur[k + LJ];
    ru = ru + cr.as * (q ? cur[k + 1] : cur[k]);
    if (WITH_F) ru = ru + cr.af * fr[g];
    const float r0 = r[g];
    ro[g] = m_r * ru + (1.0f - m_r) * r0;
  }
}

template <bool WITH_F>
int launch(const float* r, const float* b, const float* fr, const float* fb,
           float* ro, float* bo, int X, int Y2, int T, const Lyap2D& p,
           cudaStream_t stream) {
  static bool opted_in = false;  // once per process, outside any capture
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        reduced2d_kernel<WITH_F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxT));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((Y2 + kBJ - 1) / kBJ, (X + kBX - 1) / kBX, 1);
  reduced2d_kernel<WITH_F><<<grid, kThreads, smem_bytes(T), stream>>>(
      r, b, fr, fb, ro, bo, X, Y2, T, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One chunk of T sweeps: halves r, b (RHS halves fr, fb, or both null: the
// f-less kernel) of an (X, Y2) level -> ro, bo, apart from the inputs.
int pdemg_reduced2d(const float* r, const float* b, const float* fr,
                    const float* fb, float* ro, float* bo, int X, int Y2,
                    int T, const Lyap2D* p, void* stream) {
  if (T < 1 || T > kMaxT || X < 1 || Y2 < 1 ||
      (fr == nullptr) != (fb == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((X + kBX - 1) / kBX > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  return fr ? launch<true>(r, b, fr, fb, ro, bo, X, Y2, T, *p, st)
            : launch<false>(r, b, nullptr, nullptr, ro, bo, X, Y2, T, *p, st);
}

}  // extern "C"
