// Inverse of the logistic-mixture CDF, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_mixture_inverse.py, `_inv_kernel` /
// `_inv_body` (launched by `_pallas_inverse` from `mixture_inverse`).
//
// Per element (b, d), with K components laid out (B, K, D), solve
// CDF(x) = y on the fixed schedule of `_inv_body`:
//   bracket [min_k mu_k - 20 sum_k e^{s_k}, max_k mu_k + 20 sum_k e^{s_k}],
//   x = 0, then 26 bisection steps comparing log CDF(x) with log y,
//   then 4 Newton steps on log CDF(x) = log y, clipped to the bracket.
// The schedule is fixed (no early exit), as in the Pallas and jnp versions.
//
// What bounds it on the H100: operations, and among them the
// transcendentals. Every one of the 30 evaluations costs, per component,
// an exp and a log1p for the log-sigmoid and an exp for the logsumexp
// (the 4 Newton steps add the log-pdf terms): ~460 operations per
// (element, component), each exp/log counted once, ~1.4 G at B=64, K=32,
// D=1536 (~22 us at 67 TFLOP/s) against 38.5 MB of traffic (~11.5 us at
// 3.35 TB/s). The accurate expf/log1pf are several instructions each, so
// the instruction issue rate, not memory, sets the time.
//
// Design: one thread per element. The element's K log-weights (log-softmax
// taken once), means, inverse scales and log scales are loaded once
// (coalesced: stride D across k, consecutive d across the warp) and stay
// in registers for all 30 evaluations, so device memory is read once.
// Each evaluation writes its K terms into a register array and takes the
// logsumexp as max, then sum in k order. Where the CDF is flat, a
// last-bit difference in log CDF flips a bisection step and moves x by up
// to ~1e-4, so the plain PyTorch version (`mixture_inverse_plain`) sums in
// the same order with the same formulas, and the kernel holds to it
// closely; an online logsumexp (running max, rescaled sum) did not.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 32;
constexpr int kBisectIters = 26;
constexpr int kNewtonIters = 4;

// log-sum-exp of t[0, num_k) as the reference computes it: the max, then
// the sum of exp(t - max) in k order. The terms stay in registers (the
// loops unroll fully), so the two passes cost no memory traffic.
__device__ __forceinline__ float logsumexp(const float (&t)[kMaxK], int num_k) {
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < num_k) m = fmaxf(m, t[k]);
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < num_k) sum += expf(t[k] - m);
  }
  return logf(sum) + m;
}

__global__ void __launch_bounds__(kThreads)
    mixture_inverse_kernel(const float* __restrict__ y,
                           const float* __restrict__ pi,
                           const float* __restrict__ mu,
                           const float* __restrict__ log_s,
                           float* __restrict__ x_out, int batch, int num_k,
                           int dim) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * dim) return;
  const int row = static_cast<int>(idx / dim);
  const int d = static_cast<int>(idx - static_cast<long long>(row) * dim);
  const size_t base = static_cast<size_t>(row) * num_k * dim + d;

  float lpi[kMaxK];
  float m_k[kMaxK];
  float inv_s[kMaxK];
  float ls[kMaxK];
  float pmax = -INFINITY;
  float mu_min = INFINITY;
  float mu_max = -INFINITY;
  float scale_sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < num_k) {
      const size_t off = base + static_cast<size_t>(k) * dim;
      lpi[k] = pi[off];
      m_k[k] = mu[off];
      ls[k] = log_s[off];
      inv_s[k] = expf(-ls[k]);
      pmax = fmaxf(pmax, lpi[k]);
      mu_min = fminf(mu_min, m_k[k]);
      mu_max = fmaxf(mu_max, m_k[k]);
      scale_sum += expf(ls[k]);
    }
  }
  float psum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < num_k) psum += expf(lpi[k] - pmax);
  }
  const float log_psum = logf(psum);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < num_k) lpi[k] = (lpi[k] - pmax) - log_psum;
  }

  // __fmul_rn: no fused multiply-add here or in the Newton step, so the
  // products round as the plain version's separate operations do
  float lb = mu_min - __fmul_rn(20.f, scale_sum);
  float ub = mu_max + __fmul_rn(20.f, scale_sum);
  const float log_y = logf(y[idx]);
  float xv = 0.f;

  float t[kMaxK];
  for (int it = 0; it < kBisectIters; ++it) {
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < num_k) {
        const float z = (xv - m_k[k]) * inv_s[k];
        t[k] = lpi[k] + (fminf(z, 0.f) - log1pf(expf(-fabsf(z))));
      }
    }
    if (logsumexp(t, num_k) > log_y) {
      const float nx = (xv + lb) * 0.5f;
      ub = xv;
      xv = nx;
    } else {
      const float nx = (xv + ub) * 0.5f;
      lb = xv;
      xv = nx;
    }
  }

  for (int it = 0; it < kNewtonIters; ++it) {
    // the log-CDF and log-PDF terms in turn through one register array
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < num_k) {
        const float z = (xv - m_k[k]) * inv_s[k];
        t[k] = lpi[k] + (fminf(z, 0.f) - log1pf(expf(-fabsf(z))));
      }
    }
    const float log_cdf = logsumexp(t, num_k);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k < num_k) {
        const float z = (xv - m_k[k]) * inv_s[k];
        const float softplus = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
        t[k] = lpi[k] + z - ls[k] - 2.f * softplus;
      }
    }
    const float step =
        __fmul_rn(log_cdf - log_y, expf(log_cdf - logsumexp(t, num_k)));
    xv = fminf(fmaxf(xv - step, lb), ub);
  }
  x_out[idx] = xv;
}

}  // namespace

extern "C" int gpnf_mixture_inverse(const float* y, const float* pi,
                                    const float* mu, const float* log_s,
                                    float* x, int batch, int num_k, int dim,
                                    void* stream) {
  if (batch <= 0 || dim <= 0 || num_k <= 0 || num_k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(batch) * dim;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  mixture_inverse_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      y, pi, mu, log_s, x, batch, num_k, dim);
  return static_cast<int>(cudaGetLastError());
}
