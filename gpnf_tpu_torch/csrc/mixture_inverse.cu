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
// an exp and a log1p for the log-sigmoid and an exp for the logsumexp;
// the 4 Newton steps add the log-pdf terms on the same z, e^{-|z|} and
// log1p: ~438 operations per (element, component), each exp/log counted
// once, ~1.38 G at B=64, K=32, D=1536 (~21 us at 67 TFLOP/s) against 38.5
// MB of traffic (~11.5 us at 3.35 TB/s). Counted as instructions the work
// is larger: at K = 32 a bisection step of a warp is 466 instructions for
// its lanes' 8 components each (~58 a component), a Newton step 634, and
// the only special-function instructions are the expf's MUFU.EX2: the
// accurate log1pf and logf are polynomials (gpnf_tpu_torch/bench_mixture.py
// counts them in the SASS). At B=64, K=32, D=1536 that is ~1.9e8 warp
// instructions, 0.18-0.21 ms at 4 a clock on each of the 132 SMs (1.98-
// 1.755 GHz), and the kernel takes ~0.197 ms there (H100 80GB HBM3 at 700
// W): the instruction throughput is its limit.
//
// Design (mixture_lanes.cuh): a group of kGroup lanes owns an element, a
// lane 1 / kGroup of its components (8 at K = 32); a block stages its
// batch row's (K, kTileD) slabs of pi, mu and log s with cp.async, and
// each lane keeps its slots' log-weights (the log-softmax taken once),
// means, inverse scales and log scales in registers for all 30
// evaluations, with pad values in the last slot where K is not a multiple
// of kGroup, so the slot loops have no branch. An evaluation is a lane's
// terms, then the group's max and sum in a fixed order (slots, then a
// shuffle butterfly): the bits are the same in every lane, so the
// bisection's compare is a select with no divergence in the group, and
// lane 0 stores x. Where the CDF is flat, a last-bit difference in log
// CDF flips a bisection step and moves x by up to ~1e-4, so the plain
// PyTorch version (`mixture_inverse_plain`) sums in the same order with
// the same formulas, and the kernel equals it bit for bit; an online
// logsumexp (running max, rescaled sum) did not.
#include <cuda_runtime.h>
#include <math.h>

#include "mixture_lanes.cuh"

namespace {

using namespace mixture;

constexpr int kBisectIters = 26;
constexpr int kNewtonIters = 4;

template <int SLOTS>
__global__ void __launch_bounds__(kThreads)
    mixture_inverse_kernel(const float* __restrict__ y,
                           const float* __restrict__ pi,
                           const float* __restrict__ mu,
                           const float* __restrict__ log_s,
                           float* __restrict__ x_out, int num_k, int dim,
                           bool vec) {
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

  // a pad slot (k >= K): log-weight -inf, mean 0, inverse scale 0, log
  // scale 0, so z = 0 and both its terms are -inf
  float lpi[SLOTS], m_k[SLOTS], inv_s[SLOTS], ls[SLOTS];
  float pmax = -INFINITY, mu_min = INFINITY, mu_max = -INFINITY;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int k = j + kGroup * i;
    lpi[i] = -INFINITY;
    m_k[i] = inv_s[i] = ls[i] = 0.f;
    if (k < num_k) {
      lpi[i] = smem[k * kLd + e];
      m_k[i] = smem[(num_k + k) * kLd + e];
      ls[i] = smem[(2 * num_k + k) * kLd + e];
      inv_s[i] = expf(-ls[i]);
      pmax = fmaxf(pmax, lpi[i]);
      mu_min = fminf(mu_min, m_k[i]);
      mu_max = fmaxf(mu_max, m_k[i]);
    }
  }
  pmax = group_reduce(pmax, Max());
  mu_min = group_reduce(mu_min, Min());
  mu_max = group_reduce(mu_max, Max());
  float psum = 0.f, scale_sum = 0.f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    if (j + kGroup * i < num_k) {
      psum += expf(lpi[i] - pmax);
      scale_sum += expf(ls[i]);
    }
  }
  psum = group_reduce(psum, Sum());
  scale_sum = group_reduce(scale_sum, Sum());
  const float log_psum = logf(psum);
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) lpi[i] = (lpi[i] - pmax) - log_psum;

  // __fmul_rn: no fused multiply-add here or in the Newton step, so the
  // products round as the plain version's separate operations do
  float lb = mu_min - __fmul_rn(20.f, scale_sum);
  float ub = mu_max + __fmul_rn(20.f, scale_sum);
  const float log_y = logf(live ? y[idx] : 0.5f);
  float xv = 0.f;

  // from here every slot is computed: a pad's terms add nothing
  for (int it = 0; it < kBisectIters; ++it) {
    float t[SLOTS];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const float z = (xv - m_k[i]) * inv_s[i];
      t[i] = lpi[i] + (fminf(z, 0.f) - log1pf(expf(-fabsf(z))));
      m = fmaxf(m, t[i]);
    }
    m = group_reduce(m, Max());
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) sum += expf(t[i] - m);
    sum = group_reduce(sum, Sum());
    // the same bits in every lane of the group: a uniform select
    const bool gt = logf(sum) + m > log_y;
    const float nx = (xv + (gt ? lb : ub)) * 0.5f;
    lb = gt ? lb : xv;
    ub = gt ? xv : ub;
    xv = nx;
  }

  for (int it = 0; it < kNewtonIters; ++it) {
    // z, e^{-|z|} and log1p once for the log-CDF and the log-PDF terms
    float tc[SLOTS], tp[SLOTS];
    float mc = -INFINITY, mp = -INFINITY;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const float z = (xv - m_k[i]) * inv_s[i];
      const float l1p = log1pf(expf(-fabsf(z)));
      tc[i] = lpi[i] + (fminf(z, 0.f) - l1p);
      tp[i] = lpi[i] + z - ls[i] - 2.f * (fmaxf(z, 0.f) + l1p);
      mc = fmaxf(mc, tc[i]);
      mp = fmaxf(mp, tp[i]);
    }
    mc = group_reduce(mc, Max());
    mp = group_reduce(mp, Max());
    float sc = 0.f, sp = 0.f;
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      sc += expf(tc[i] - mc);
      sp += expf(tp[i] - mp);
    }
    sc = group_reduce(sc, Sum());
    sp = group_reduce(sp, Sum());
    const float log_cdf = logf(sc) + mc;
    const float log_pdf = logf(sp) + mp;
    const float step = __fmul_rn(log_cdf - log_y, expf(log_cdf - log_pdf));
    xv = fminf(fmaxf(xv - step, lb), ub);
  }
  if (live && j == 0) x_out[idx] = xv;
}

}  // namespace

// The lanes an element's components spread over: the plain version sums in
// this group's order, and its wrapper checks that the two agree.
extern "C" int gpnf_mixture_group() { return mixture::kGroup; }

extern "C" int gpnf_mixture_inverse(const float* y, const float* pi,
                                    const float* mu, const float* log_s,
                                    float* x, int batch, int num_k, int dim,
                                    void* stream) {
  return mixture::launch_tiles(
      [](auto slots) {
        return mixture_inverse_kernel<decltype(slots)::value>;
      },
      batch, num_k, dim, pi, mu, log_s, stream, y, pi, mu, log_s, x);
}
