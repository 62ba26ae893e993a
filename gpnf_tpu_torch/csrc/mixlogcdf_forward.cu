// MixLogCDF coupling forward transform, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_mixlogcdf.py, `_kernel` (launched by
// `_pallas_forward` from `mixlogcdf_forward`).
//
// Per element (b, d), with K mixture components laid out (B, K, D):
//   log_pi  = log_softmax_k(pi)
//   z_k     = (x - mu_k) * exp(-s_k)
//   log_cdf = logsumexp_k(log_pi_k + log_sigmoid(z_k))
//   log_pdf = logsumexp_k(log_pi_k + z_k - s_k - 2 softplus(z_k))
//   u       = exp(log_cdf), logit with the 1e-22 clamps of `_kernel`
//   y       = (logit(u) + b) * exp(a)
//   ldj     = log_pdf + scale_ldj + a
//
// What bounds it on the H100: bytes. It reads 3*B*K*D + 3*B*D floats and
// writes 2*B*D (39.7 MB at B=64, K=32, D=1536: ~12 us at 3.35 TB/s) and
// does ~30 operations per (element, component), each exp/log counted once:
// ~0.1 G there, ~1.4 us at 67 TFLOP/s (more in practice, since the
// accurate expf/log1pf are multi-instruction sequences).
//
// Design: one thread per element. The K values of pi, mu and s sit at
// stride D, so for every k the 32 lanes of a warp read 32 consecutive
// floats (coalesced). The element's K logits stay in registers, so the
// log-softmax and both logsumexps are the same max-then-sum passes as the
// reference, in the same order; expf/logf/log1pf are the accurate library
// versions (no --use_fast_math), so the kernel agrees with the plain
// PyTorch version to fp32 rounding.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;

__global__ void __launch_bounds__(kThreads)
    mixlogcdf_forward_kernel(const float* __restrict__ x,
                             const float* __restrict__ a,
                             const float* __restrict__ b,
                             const float* __restrict__ pi,
                             const float* __restrict__ mu,
                             const float* __restrict__ log_s,
                             float* __restrict__ y, float* __restrict__ ldj,
                             int batch, int num_k, int dim) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * dim) return;
  const int row = static_cast<int>(idx / dim);
  const int d = static_cast<int>(idx - static_cast<long long>(row) * dim);
  const size_t base = static_cast<size_t>(row) * num_k * dim + d;

  float t_cdf[kMaxK];
  float t_pdf[kMaxK];
  float pmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < num_k) {
      t_cdf[k] = pi[base + static_cast<size_t>(k) * dim];
      pmax = fmaxf(pmax, t_cdf[k]);
    }
  }
  float psum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < num_k) psum += expf(t_cdf[k] - pmax);
  }
  const float log_psum = logf(psum);

  const float xv = x[idx];
  float cmax = -INFINITY;
  float dmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < num_k) {
      const float lpi = (t_cdf[k] - pmax) - log_psum;
      const float ls = log_s[base + static_cast<size_t>(k) * dim];
      const float z = (xv - mu[base + static_cast<size_t>(k) * dim]) * expf(-ls);
      const float l1p = log1pf(expf(-fabsf(z)));
      const float log_sig = fminf(z, 0.f) - l1p;
      const float softplus = fmaxf(z, 0.f) + l1p;
      t_cdf[k] = lpi + log_sig;
      t_pdf[k] = lpi + z - ls - 2.f * softplus;
      cmax = fmaxf(cmax, t_cdf[k]);
      dmax = fmaxf(dmax, t_pdf[k]);
    }
  }
  float csum = 0.f;
  float dsum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < num_k) {
      csum += expf(t_cdf[k] - cmax);
      dsum += expf(t_pdf[k] - dmax);
    }
  }
  const float log_cdf = logf(csum) + cmax;
  const float log_pdf = logf(dsum) + dmax;

  const float u = expf(log_cdf);
  const float u_c = fmaxf(u, 1e-22f);
  const float logit_u = -logf(fmaxf(1.f / u_c - 1.f, 1e-22f));
  const float scale_ldj = -logf(u_c) - logf(fmaxf(1.f - u, 1e-22f));
  const float av = a[idx];
  y[idx] = (logit_u + b[idx]) * expf(av);
  ldj[idx] = log_pdf + scale_ldj + av;
}

}  // namespace

extern "C" int gpnf_mixlogcdf_forward(const float* x, const float* a,
                                      const float* b, const float* pi,
                                      const float* mu, const float* log_s,
                                      float* y, float* ldj, int batch,
                                      int num_k, int dim, void* stream) {
  if (batch <= 0 || dim <= 0 || num_k <= 0 || num_k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(batch) * dim;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  mixlogcdf_forward_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, a, b, pi, mu, log_s, y, ldj, batch, num_k, dim);
  return static_cast<int>(cudaGetLastError());
}
