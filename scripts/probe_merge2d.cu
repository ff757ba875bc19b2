// Forms of the 2D merge converter (halves -> dense, row 15) for
// scripts/probe_merge2d.py, which builds this file on its own with nvcc
// and times each form against the package's merge2d_kernel
// (ops/cuda/csrc/relax2d.cu) on one card.
//
//   thread  a thread per dense point, launched as rows (blockIdx.z = x):
//           the port's first form;
//   quads<Q>  the package's form with Q quads in flight a thread: the dense
//           level as one flat array in 16-byte-aligned quads, lanes on
//           consecutive quads, all 4 Q loads before the first store;
//   staged  a CTA stages R rows of both halves in shared memory (coalesced
//           scalar loads, 4 in flight a thread), then writes the R dense
//           rows as 16-byte-aligned quads (a scalar head and tail) read
//           from shared memory.
// Layout: red at y = 2j + (x % 2), black at y = 2j + 1 - (x % 2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float merged_at(const float* __restrict__ r,
                                           const float* __restrict__ b,
                                           unsigned x, unsigned y,
                                           unsigned Y2) {
  const float* h = ((x ^ y) & 1u) ? b : r;
  return h[x * Y2 + (y >> 1)];
}

__global__ void thread_kernel(const float* __restrict__ r,
                              const float* __restrict__ b,
                              float* __restrict__ v, int Y, int Y2) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (y >= Y) return;
  const int x = blockIdx.z;
  const long long i = (long long)x * Y2 + (y >> 1);
  v[(long long)x * Y + y] = ((y & 1) == (x & 1)) ? r[i] : b[i];
}

template <int Q>
__global__ void __launch_bounds__(256)
    quads_kernel(const float* __restrict__ r, const float* __restrict__ b,
                 float* __restrict__ v, unsigned Y, unsigned Y2, unsigned n,
                 unsigned head, unsigned nquads) {
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const unsigned t = threadIdx.x;
    const unsigned i = t < 4 ? t : head + 4 * nquads + t - 4;
    if (t < 4 ? i < head : i < n) {
      const unsigned x = i / Y;
      v[i] = merged_at(r, b, x, i - x * Y, Y2);
    }
  }
  constexpr unsigned kSpan = 256 * Q;
  for (unsigned q0 = blockIdx.x * kSpan + threadIdx.x; q0 < nquads;
       q0 += gridDim.x * kSpan) {
    float w[Q][4];
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const unsigned q = q0 + k * 256;
      if (q < nquads) {
        const unsigned i = head + 4 * q;
        unsigned x = i / Y;
        unsigned y = i - x * Y;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[k][e] = merged_at(r, b, x, y, Y2);
          if (++y == Y) {
            y = 0;
            ++x;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const unsigned q = q0 + k * 256;
      if (q < nquads) {
        *reinterpret_cast<float4*>(v + head + 4 * q) =
            make_float4(w[k][0], w[k][1], w[k][2], w[k][3]);
      }
    }
  }
}

// CTA c stages rows [c R, c R + R) of both halves, then writes them dense.
__global__ void __launch_bounds__(256)
    staged_kernel(const float* __restrict__ r, const float* __restrict__ b,
                  float* __restrict__ v, unsigned X, unsigned Y, unsigned Y2,
                  unsigned R) {
  extern __shared__ float sm[];
  const unsigned x0 = blockIdx.x * R;
  const unsigned rows = min(R, X - x0);
  const unsigned nh = rows * Y2;
  const float* rs = r + x0 * Y2;
  const float* bs = b + x0 * Y2;
  for (unsigned i0 = threadIdx.x; i0 < nh; i0 += 4 * blockDim.x) {
    float tr[4], tb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned i = i0 + k * blockDim.x;
      tr[k] = i < nh ? rs[i] : 0.0f;
      tb[k] = i < nh ? bs[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned i = i0 + k * blockDim.x;
      if (i < nh) {
        sm[i] = tr[k];
        sm[nh + i] = tb[k];
      }
    }
  }
  __syncthreads();
  // the dense points [d0, d1) of these rows, as 16-byte-aligned quads
  const unsigned d0 = x0 * Y, d1 = d0 + rows * Y;
  const unsigned skew = (unsigned)(reinterpret_cast<uintptr_t>(v + d0) % 16);
  unsigned head = (16 - skew) % 16 / 4;
  if (head > d1 - d0) head = d1 - d0;
  const unsigned nq = (d1 - d0 - head) / 4;
  auto at = [&](unsigned i) {  // i counted from d0
    const unsigned k = i / Y, y = i - k * Y;
    const unsigned s = (((x0 + k) ^ y) & 1u) ? nh : 0u;
    return sm[s + k * Y2 + (y >> 1)];
  };
  if (threadIdx.x < 8) {
    const unsigned t = threadIdx.x;
    const unsigned i = t < 4 ? t : head + 4 * nq + t - 4;
    if (t < 4 ? i < head : i < d1 - d0) v[d0 + i] = at(i);
  }
  for (unsigned q = threadIdx.x; q < nq; q += blockDim.x) {
    const unsigned i = head + 4 * q;
    *reinterpret_cast<float4*>(v + d0 + i) =
        make_float4(at(i), at(i + 1), at(i + 2), at(i + 3));
  }
}

template <int Q>
int run_quads(const float* r, const float* b, float* v, int X, int Y,
              int ctas_per_sm, cudaStream_t stream) {
  const unsigned long long n = (unsigned long long)X * Y;
  const unsigned skew = (unsigned)(reinterpret_cast<uintptr_t>(v) % 16);
  unsigned head = (16 - skew) % 16 / 4;
  if (head > n) head = (unsigned)n;
  const unsigned nquads = (unsigned)((n - head) / 4);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  unsigned ctas = (nquads + 256 * Q - 1) / (256 * Q);
  if (ctas > (unsigned)(sms * ctas_per_sm)) ctas = sms * ctas_per_sm;
  if (ctas < 1) ctas = 1;
  quads_kernel<Q><<<ctas, 256, 0, stream>>>(r, b, v, Y, (Y + 1) / 2,
                                            (unsigned)n, head, nquads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int probe_merge_thread(const float* r, const float* b, float* v, int X,
                       int Y, void* stream) {
  const int threads = Y >= 128 ? 128 : ((Y + 31) / 32) * 32;
  thread_kernel<<<dim3((Y + 127) / 128, 1, X), threads, 0,
                  (cudaStream_t)stream>>>(r, b, v, Y, (Y + 1) / 2);
  return (int)cudaGetLastError();
}

int probe_merge_quads(const float* r, const float* b, float* v, int X, int Y,
                      int Q, int ctas_per_sm, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Q) {
    case 1:
      return run_quads<1>(r, b, v, X, Y, ctas_per_sm, s);
    case 2:
      return run_quads<2>(r, b, v, X, Y, ctas_per_sm, s);
    case 4:
      return run_quads<4>(r, b, v, X, Y, ctas_per_sm, s);
    case 8:
      return run_quads<8>(r, b, v, X, Y, ctas_per_sm, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int probe_merge_staged(const float* r, const float* b, float* v, int X,
                       int Y, int R, void* stream) {
  const unsigned Y2 = (Y + 1) / 2;
  const size_t smem = 2ull * R * Y2 * sizeof(float);
  static const cudaError_t opted = cudaFuncSetAttribute(
      staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opted != cudaSuccess) return (int)opted;
  staged_kernel<<<(X + R - 1) / R, 256, smem, (cudaStream_t)stream>>>(
      r, b, v, X, Y, Y2, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
