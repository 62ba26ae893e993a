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
// ~0.1 G there, ~1.4 us at 67 TFLOP/s. Counted as instructions (the
// accurate expf and log1pf) the work is of the order of the memory's
// time: the kernel's SASS at K = 32 is 1,800 instructions
// (gpnf_tpu_torch/bench_mixture.py), at most all of them once a tile by
// each of 8 warps, at most ~2.2e7 warp instructions at those shapes, ~22
// us at 4 a clock on each of the 132 SMs.
//
// Design (mixture_lanes.cuh, as mixture_inverse.cu): a group of kGroup
// lanes owns an element, a lane 1 / kGroup of its components; a block
// stages its batch row's (K, kTileD) slabs of pi, mu and log s with
// cp.async (whole sectors), each lane takes its slots' terms (pad values
// in the last slot where K is not a multiple of kGroup), and the group's
// max and sum (slots, then a shuffle butterfly, a fixed order: two calls
// give the same bits) make the log-softmax and both logsumexps; lane 0
// stores y and ldj. expf/logf/log1pf are the accurate library versions (no
// --use_fast_math), so the kernel agrees with the plain PyTorch version
// (torch.logsumexp, another order) to fp32 rounding. A persistent block
// that staged its next tile while computing this one (two stages) was no
// faster on the H100 (gpnf_tpu_torch/bench_mixture.py), so a block takes
// one tile.
#include <cuda_runtime.h>
#include <math.h>

#include "mixture_lanes.cuh"

namespace {

using namespace mixture;

template <int SLOTS>
__global__ void __launch_bounds__(kThreads)
    mixlogcdf_forward_kernel(const float* __restrict__ x,
                             const float* __restrict__ a,
                             const float* __restrict__ b,
                             const float* __restrict__ pi,
                             const float* __restrict__ mu,
                             const float* __restrict__ log_s,
                             float* __restrict__ y, float* __restrict__ ldj,
                             int num_k, int dim, bool vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles_d = (dim + kTileD - 1) / kTileD;
  const int row = blockIdx.x / tiles_d;
  const int d0 = (blockIdx.x - row * tiles_d) * kTileD;
  stage_tile(smem, pi, mu, log_s, row, d0, num_k, dim, vec);
  gpnf::cp_async_commit();
  gpnf::cp_async_wait_all();
  __syncthreads();

  const int j = threadIdx.x % kGroup;
  const int e = threadIdx.x / kGroup;
  const int d = d0 + e;
  // lanes past the last d run on the zeros staged there and store nothing:
  // every lane of the warp takes part in the shuffles
  const bool live = d < dim;
  const size_t idx = static_cast<size_t>(row) * dim + (live ? d : 0);
  // the slabs are read where they are used (fewer registers than the
  // inverse's, which keeps them for 30 evaluations); a pad slot (k >= K)
  // reads row 0 and gets logit -inf, mean and log scale 0: z = 0 and both
  // its terms are -inf
  auto at = [&](int a_, int i) {
    const int k = j + kGroup * i;
    return smem[(a_ * num_k + (k < num_k ? k : 0)) * kLd + e];
  };
  auto valid = [&](int i) { return j + kGroup * i < num_k; };
  float pmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (valid(i)) pmax = fmaxf(pmax, at(0, i));
  }
  pmax = group_reduce(pmax, Max());
  float psum = 0.f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    psum += expf((valid(i) ? at(0, i) : -INFINITY) - pmax);
  }
  const float log_psum = logf(group_reduce(psum, Sum()));

  const float xv = live ? x[idx] : 0.f;
  float t_cdf[SLOTS], t_pdf[SLOTS];
  float cmax = -INFINITY, dmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const bool v = valid(i);
    const float lpi = ((v ? at(0, i) : -INFINITY) - pmax) - log_psum;
    const float ls = v ? at(2, i) : 0.f;
    const float z = (xv - (v ? at(1, i) : 0.f)) * expf(-ls);
    const float l1p = log1pf(expf(-fabsf(z)));
    t_cdf[i] = lpi + (fminf(z, 0.f) - l1p);
    t_pdf[i] = lpi + z - ls - 2.f * (fmaxf(z, 0.f) + l1p);
    cmax = fmaxf(cmax, t_cdf[i]);
    dmax = fmaxf(dmax, t_pdf[i]);
  }
  cmax = group_reduce(cmax, Max());
  dmax = group_reduce(dmax, Max());
  float csum = 0.f, dsum = 0.f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    csum += expf(t_cdf[i] - cmax);
    dsum += expf(t_pdf[i] - dmax);
  }
  csum = group_reduce(csum, Sum());
  dsum = group_reduce(dsum, Sum());
  if (!live || j != 0) return;
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
  return mixture::launch_tiles(
      [](auto slots) {
        return mixlogcdf_forward_kernel<decltype(slots)::value>;
      },
      batch, num_k, dim, pi, mu, log_s, stream, x, a, b, pi, mu, log_s, y,
      ldj);
}
