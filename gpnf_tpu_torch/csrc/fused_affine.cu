// Affine coupling transform with its log-det reduction, hand-written for
// Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_coupling.py, `_fwd_kernel` (launched
// by `_pallas_fused` from `fused_affine_forward`).
//
// For x, shift, raw of shape (B, D):
//   t      = raw + 2
//   y      = shift + x * sigmoid(t)
//   ldj[b] = sum_d log sigmoid(t[b, d])
// log sigmoid(t) is computed as -softplus(-t) = -(max(-t, 0) +
// log1p(exp(-|t|))): finite for every finite t, where log(sigmoid(t))
// underflows to -inf below t ~ -104 in fp32.
//
// What bounds it on the H100: bytes. It reads 3 B D values and writes B D
// + B (6.3 MB at B = 1024, D = 384 in fp32: 1.9 us at 3.35 TB/s) and does
// ~10 operations per element (0.004 GFLOP there).
//
// Design: one block of 256 threads per row; the threads walk the row at a
// stride of 256 (coalesced), each keeps a partial sum, and the block adds
// the partials with warp shuffles and one pass through shared memory, in a
// fixed order (the same result on every call). Every shape is taken: the
// Pallas kernel needs B % 8 == 0 and D % 128 == 0, and the TPU takes its
// jnp reference elsewhere. Float32 and float64 (two instantiations).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float log1p_(float v) { return log1pf(v); }
__device__ __forceinline__ double log1p_(double v) { return log1p(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_affine_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                        const T* __restrict__ raw, T* __restrict__ y,
                        T* __restrict__ ldj, int dim) {
  __shared__ T partial[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * dim;
  T sum = T(0);
  for (int d = threadIdx.x; d < dim; d += kThreads) {
    const T t = raw[base + d] + T(2);
    const T e = exp_(t >= T(0) ? -t : t);  // exp(-|t|)
    const T log_sig = -((t >= T(0) ? T(0) : -t) + log1p_(e));
    const T scale = t >= T(0) ? T(1) / (T(1) + e) : e / (T(1) + e);
    y[base + d] = shift[base + d] + x[base + d] * scale;
    sum += log_sig;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    T total = T(0);
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
    ldj[blockIdx.x] = total;
  }
}

template <typename T>
int fused_affine(const T* x, const T* shift, const T* raw, T* y, T* ldj,
                 int batch, int dim, cudaStream_t stream) {
  if (batch <= 0 || dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  fused_affine_kernel<T><<<batch, kThreads, 0, stream>>>(x, shift, raw, y,
                                                         ldj, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gpnf_fused_affine_f32(const float* x, const float* shift,
                                     const float* raw, float* y, float* ldj,
                                     int batch, int dim, void* stream) {
  return fused_affine<float>(x, shift, raw, y, ldj, batch, dim,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int gpnf_fused_affine_f64(const double* x, const double* shift,
                                     const double* raw, double* y, double* ldj,
                                     int batch, int dim, void* stream) {
  return fused_affine<double>(x, shift, raw, y, ldj, batch, dim,
                              static_cast<cudaStream_t>(stream));
}
