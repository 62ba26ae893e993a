// Multi-head self-attention for long sequences (512 < S <= 2048), forward
// with in-kernel dropout and backward, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py, `_fwd_kernel_bh` and
// `_bwd_kernel_bh` (both launched by `_run_bh`), from
// `fused_attention_long`. As there, the projection qkv = seq @ w^T and the
// backward's dseq = dqkv @ w and dW = dqkv^T seq are plain matrix products
// outside these kernels (torch.matmul in ops/kernels/fused_attention.py).
//
// For every batch row b and head h, with qkv (B, S, 3C) packed [k | v | q]:
//   k = qkv[b, :, h*Dh : (h+1)*Dh],  v = qkv[b, :, C + h*Dh : ...]
//   q = qkv[b, :, 2C + h*Dh : ...] * Dh^-1/2
//   P = softmax(q k^T);  Pd = keep * P / (1 - rate)
//   out[b, :, h*Dh : (h+1)*Dh] = Pd v
// The keep bit of score (b, h, i, j) comes from philox.cuh, the same pure
// function of (seed, b, h, i, j) as in fused_attention_proj.cu, so at one
// seed the two entries drop the same scores.
//
// Backward, with g = d out:
//   dV = Pd^T g;  dPd = g V^T;  dP = keep * dPd / (1 - rate)
//   dS = P * (dP - D),  D_i = sum_j dP_ij P_ij
//   dq = dS K * Dh^-1/2;  dK = dS^T q;  dqkv = [dK | dV | dq]
//
// What bounds it on the H100: operations. At the 64-px row's level 0
// (B=64, S=1024, C=96, 4 heads of Dh=24) the forward does two S x S x Dh
// products of 12.9 GFLOP each plus ~1.3 GOP of softmax: >= ~0.40 ms at the
// fp32 rate outside the tensor cores (67 TFLOP/s). The backward does five
// such products (the scores again, dPd, dV, dq, dK), ~64 GFLOP: >= ~0.96
// ms. The bytes (qkv, g, out, dqkv: 100-180 MB) need 30-53 us.
//
// Design (simple and exact first; tensor cores and TMA are later work).
// The Pallas kernels hold one head's (S, S) fp32 scores (4 MB at S=1024)
// and the proj kernel's layout holds one head's K, V and Q whole in shared
// memory (3*S*Dh*4 B = 295 KB at S=1024); neither fits a 227 KB block. So
// the key axis is tiled, and shared memory no longer grows with S:
//   - forward: a block per (64 queries, head, batch row), a thread per
//     query; q (scaled as it is loaded) and the output accumulator sit in
//     registers (Dh is a template parameter, 24 on this path); K and V
//     stream through shared memory in tiles of 64 keys, read by every
//     thread as warp-wide broadcasts; the online softmax of the proj
//     kernel (the denominator sums every exp(s - m); the accumulator adds
//     only the kept terms, scaled); one Philox call per four keys;
//   - backward, kernel 1 (a thread per query): pass A over the key tiles
//     finds m_i, l_i and D_i online (D rescales like the denominator);
//     pass B accumulates dq_i = sum_j p_ij (dP_ij - D_i) k_j and writes it,
//     scaled, into dqkv, and (m_i, 1/l_i, D_i) into a (B, H, S, 3) scratch;
//   - backward, kernel 2 (a thread per key): loops over query tiles of q,
//     g and the stats in shared memory and accumulates dV_j and dK_j.
//   No atomics: each dqkv element is written once by one thread, so the
//   backward repeats bit for bit. Both kernels read packed qkv and write
//   packed dqkv (B, S, 3C) directly, so no head split or merge copies.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kRows = 64;  // queries (forward, dq) or keys (dK/dV) a block
constexpr int kTile = 64;  // keys (or queries) per shared-memory tile

// Rows [r0, r0 + kTile) of the (S, Dh) slice that starts at `src` (row
// stride `stride` floats) into dst (kTile, DH), times `scale`; rows past S
// are zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int seq_len, size_t stride,
                                          float scale) {
  for (int e = threadIdx.x; e < kTile * DH; e += blockDim.x) {
    const int r = e / DH;
    const int d = e - r * DH;
    dst[e] = r0 + r < seq_len
                 ? src[static_cast<size_t>(r0 + r) * stride + d] * scale
                 : 0.f;
  }
}

template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(kRows)
    attention_long_fwd_kernel(const int* __restrict__ seed_ptr,
                              const float* __restrict__ qkv,
                              float* __restrict__ out, int seq_len,
                              int channels, float q_scale, uint32_t threshold,
                              float keep_scale) {
  __shared__ __align__(16) float k_s[kTile * DH];
  __shared__ __align__(16) float v_s[kTile * DH];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi = blockIdx.x * kRows + threadIdx.x;
  const bool valid = qi < seq_len;
  const size_t c3 = 3 * static_cast<size_t>(channels);
  const float* base = qkv + static_cast<size_t>(b) * seq_len * c3 + h * DH;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  float q[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = valid ? base[qi * c3 + 2 * channels + d] * q_scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < seq_len; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<DH>(k_s, base, j0, seq_len, c3, 1.f);
    load_tile<DH>(v_s, base + channels, j0, seq_len, c3, 1.f);
    __syncthreads();
    if (!valid) continue;
    const int nk = min(kTile, seq_len - j0);
    for (int t = 0; t < nk; t += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) {
        bits = gpnf::attention_dropout_bits(seed, b, h, qi, (j0 + t) >> 2);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (t + jj >= nk) break;
        const float* kj = k_s + (t + jj) * DH;
        float score = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) score = fmaf(q[d], kj[d], score);
        if (score > m) {
          const float corr = expf(m - score);
          l *= corr;
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] *= corr;
          m = score;
        }
        const float p = expf(score - m);
        l += p;
        float pd = p;
        if (DROPOUT) {
          pd = gpnf::philox_word(bits, jj) >= threshold ? p * keep_scale : 0.f;
        }
        const float* vj = v_s + (t + jj) * DH;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(pd, vj[d], acc[d]);
      }
    }
  }
  if (!valid) return;
  const float inv_l = 1.f / l;
  float* o = out + (static_cast<size_t>(b) * seq_len + qi) * channels + h * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) o[d] = acc[d] * inv_l;
}

// Backward kernel 1: a thread per query -> dq (scaled) into dqkv, and
// (m, 1/l, D) of the row into stats (B, H, S, 3).
template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(kRows)
    attention_long_dq_kernel(const int* __restrict__ seed_ptr,
                             const float* __restrict__ qkv,
                             const float* __restrict__ g,
                             float* __restrict__ dqkv,
                             float* __restrict__ stats, int seq_len,
                             int channels, int heads, float q_scale,
                             uint32_t threshold, float keep_scale) {
  __shared__ __align__(16) float k_s[kTile * DH];
  __shared__ __align__(16) float v_s[kTile * DH];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi = blockIdx.x * kRows + threadIdx.x;
  const bool valid = qi < seq_len;
  const size_t c3 = 3 * static_cast<size_t>(channels);
  const float* base = qkv + static_cast<size_t>(b) * seq_len * c3 + h * DH;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  float q[DH], gi[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = valid ? base[qi * c3 + 2 * channels + d] * q_scale : 0.f;
    gi[d] = valid ? g[(static_cast<size_t>(b) * seq_len + qi) * channels +
                      h * DH + d]
                  : 0.f;
  }

  // pass A: row max m, denominator l and dsum = sum_j exp(s_j - m) dP_j,
  // rescaled together whenever m grows
  float m = -INFINITY, l = 0.f, dsum = 0.f;
  for (int j0 = 0; j0 < seq_len; j0 += kTile) {
    __syncthreads();
    load_tile<DH>(k_s, base, j0, seq_len, c3, 1.f);
    load_tile<DH>(v_s, base + channels, j0, seq_len, c3, 1.f);
    __syncthreads();
    if (!valid) continue;
    const int nk = min(kTile, seq_len - j0);
    for (int t = 0; t < nk; t += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) {
        bits = gpnf::attention_dropout_bits(seed, b, h, qi, (j0 + t) >> 2);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (t + jj >= nk) break;
        const float* kj = k_s + (t + jj) * DH;
        const float* vj = v_s + (t + jj) * DH;
        float score = 0.f, dpd = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          score = fmaf(q[d], kj[d], score);
          dpd = fmaf(gi[d], vj[d], dpd);
        }
        float dp = dpd;
        if (DROPOUT) {
          dp = gpnf::philox_word(bits, jj) >= threshold ? dpd * keep_scale
                                                        : 0.f;
        }
        if (score > m) {
          const float corr = expf(m - score);
          l *= corr;
          dsum *= corr;
          m = score;
        }
        const float e = expf(score - m);
        l += e;
        dsum = fmaf(e, dp, dsum);
      }
    }
  }
  const float inv_l = valid ? 1.f / l : 0.f;
  const float big_d = dsum * inv_l;

  // pass B: dq_i = sum_j p_ij (dP_ij - D_i) k_j
  float dq[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) dq[d] = 0.f;
  for (int j0 = 0; j0 < seq_len; j0 += kTile) {
    __syncthreads();
    load_tile<DH>(k_s, base, j0, seq_len, c3, 1.f);
    load_tile<DH>(v_s, base + channels, j0, seq_len, c3, 1.f);
    __syncthreads();
    if (!valid) continue;
    const int nk = min(kTile, seq_len - j0);
    for (int t = 0; t < nk; t += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) {
        bits = gpnf::attention_dropout_bits(seed, b, h, qi, (j0 + t) >> 2);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (t + jj >= nk) break;
        const float* kj = k_s + (t + jj) * DH;
        const float* vj = v_s + (t + jj) * DH;
        float score = 0.f, dpd = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          score = fmaf(q[d], kj[d], score);
          dpd = fmaf(gi[d], vj[d], dpd);
        }
        float dp = dpd;
        if (DROPOUT) {
          dp = gpnf::philox_word(bits, jj) >= threshold ? dpd * keep_scale
                                                        : 0.f;
        }
        const float ds = expf(score - m) * inv_l * (dp - big_d);
#pragma unroll
        for (int d = 0; d < DH; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
      }
    }
  }
  if (!valid) return;
  float* row = dqkv + (static_cast<size_t>(b) * seq_len + qi) * c3 +
               2 * channels + h * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) row[d] = dq[d] * q_scale;
  float* st = stats + ((static_cast<size_t>(b) * heads + h) * seq_len + qi) * 3;
  st[0] = m;
  st[1] = inv_l;
  st[2] = big_d;
}

// Backward kernel 2: a thread per key -> dK and dV into dqkv.
template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(kRows)
    attention_long_dkv_kernel(const int* __restrict__ seed_ptr,
                              const float* __restrict__ qkv,
                              const float* __restrict__ g,
                              const float* __restrict__ stats,
                              float* __restrict__ dqkv, int seq_len,
                              int channels, int heads, float q_scale,
                              uint32_t threshold, float keep_scale) {
  __shared__ __align__(16) float q_s[kTile * DH];  // scaled q rows
  __shared__ __align__(16) float g_s[kTile * DH];
  __shared__ float st_s[kTile * 3];                 // m, 1/l, D per query
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kj = blockIdx.x * kRows + threadIdx.x;
  const bool valid = kj < seq_len;
  const size_t c3 = 3 * static_cast<size_t>(channels);
  const float* base = qkv + static_cast<size_t>(b) * seq_len * c3 + h * DH;
  const float* g_head =
      g + static_cast<size_t>(b) * seq_len * channels + h * DH;
  const float* st_head =
      stats + (static_cast<size_t>(b) * heads + h) * seq_len * 3;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  float k[DH], v[DH], dk[DH], dv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    k[d] = valid ? base[kj * c3 + d] : 0.f;
    v[d] = valid ? base[kj * c3 + channels + d] : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const int quad = kj >> 2;
  const int sel = kj & 3;
  for (int i0 = 0; i0 < seq_len; i0 += kTile) {
    __syncthreads();
    load_tile<DH>(q_s, base + 2 * channels, i0, seq_len, c3, q_scale);
    load_tile<DH>(g_s, g_head, i0, seq_len, channels, 1.f);
    const int ni = min(kTile, seq_len - i0);
    for (int e = threadIdx.x; e < ni * 3; e += blockDim.x) {
      st_s[e] = st_head[static_cast<size_t>(i0) * 3 + e];
    }
    __syncthreads();
    if (!valid) continue;
    for (int ii = 0; ii < ni; ++ii) {
      const float* qrow = q_s + ii * DH;
      const float* grow = g_s + ii * DH;
      float score = 0.f, dpd = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        score = fmaf(qrow[d], k[d], score);
        dpd = fmaf(grow[d], v[d], dpd);
      }
      const float p = expf(score - st_s[3 * ii]) * st_s[3 * ii + 1];
      float pd = p, dp = dpd;
      if (DROPOUT) {
        const bool keep =
            gpnf::philox_word(
                gpnf::attention_dropout_bits(seed, b, h, i0 + ii, quad),
                sel) >= threshold;
        pd = keep ? p * keep_scale : 0.f;
        dp = keep ? dpd * keep_scale : 0.f;
      }
      const float ds = p * (dp - st_s[3 * ii + 2]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dv[d] = fmaf(pd, grow[d], dv[d]);
        dk[d] = fmaf(ds, qrow[d], dk[d]);
      }
    }
  }
  if (!valid) return;
  float* row = dqkv + (static_cast<size_t>(b) * seq_len + kj) * c3 + h * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    row[d] = dk[d];
    row[channels + d] = dv[d];
  }
}

template <int DH>
cudaError_t launch_fwd(const int* seed, const float* qkv, float* out,
                       int batch, int seq_len, int channels, int heads,
                       uint32_t threshold, float keep_scale,
                       cudaStream_t stream) {
  const dim3 grid((seq_len + kRows - 1) / kRows, heads, batch);
  const float q_scale = 1.f / sqrtf(static_cast<float>(DH));
  if (threshold > 0) {
    attention_long_fwd_kernel<DH, true><<<grid, kRows, 0, stream>>>(
        seed, qkv, out, seq_len, channels, q_scale, threshold, keep_scale);
  } else {
    attention_long_fwd_kernel<DH, false><<<grid, kRows, 0, stream>>>(
        seed, qkv, out, seq_len, channels, q_scale, threshold, keep_scale);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const int* seed, const float* qkv, const float* g,
                       float* dqkv, float* stats, int batch, int seq_len,
                       int channels, int heads, uint32_t threshold,
                       float keep_scale, cudaStream_t stream) {
  const dim3 grid((seq_len + kRows - 1) / kRows, heads, batch);
  const float q_scale = 1.f / sqrtf(static_cast<float>(DH));
  if (threshold > 0) {
    attention_long_dq_kernel<DH, true><<<grid, kRows, 0, stream>>>(
        seed, qkv, g, dqkv, stats, seq_len, channels, heads, q_scale,
        threshold, keep_scale);
  } else {
    attention_long_dq_kernel<DH, false><<<grid, kRows, 0, stream>>>(
        seed, qkv, g, dqkv, stats, seq_len, channels, heads, q_scale,
        threshold, keep_scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (threshold > 0) {
    attention_long_dkv_kernel<DH, true><<<grid, kRows, 0, stream>>>(
        seed, qkv, g, stats, dqkv, seq_len, channels, heads, q_scale,
        threshold, keep_scale);
  } else {
    attention_long_dkv_kernel<DH, false><<<grid, kRows, 0, stream>>>(
        seed, qkv, g, stats, dqkv, seq_len, channels, heads, q_scale,
        threshold, keep_scale);
  }
  return cudaGetLastError();
}

bool valid_shape(int batch, int seq_len, int channels, int heads) {
  return batch > 0 && seq_len > 0 && heads > 0 && channels % heads == 0 &&
         batch <= 65535 && heads <= 65535;
}

}  // namespace

// out (B, S, C) from qkv (B, S, 3C); seed is a device (1,) int32, read only
// when threshold > 0.
extern "C" int gpnf_attention_long_fwd(const int* seed, const float* qkv,
                                       float* out, int batch, int seq_len,
                                       int channels, int heads,
                                       uint32_t threshold, float keep_scale,
                                       void* stream) {
  if (!valid_shape(batch, seq_len, channels, heads) ||
      (threshold > 0 && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPNF_FWD(D)                                                          \
  launch_fwd<D>(seed, qkv, out, batch, seq_len, channels, heads, threshold, \
                keep_scale, s)
  cudaError_t err;
  switch (channels / heads) {
    case 4: err = GPNF_FWD(4); break;
    case 8: err = GPNF_FWD(8); break;
    case 16: err = GPNF_FWD(16); break;
    case 24: err = GPNF_FWD(24); break;
    case 32: err = GPNF_FWD(32); break;
    case 48: err = GPNF_FWD(48); break;
    case 64: err = GPNF_FWD(64); break;
    default: err = cudaErrorInvalidValue;
  }
#undef GPNF_FWD
  return static_cast<int>(err);
}

// dqkv (B, S, 3C) from (seed, qkv, g); stats is the caller's (B, H, S, 3)
// scratch.
extern "C" int gpnf_attention_long_bwd(const int* seed, const float* qkv,
                                       const float* g, float* dqkv,
                                       float* stats, int batch, int seq_len,
                                       int channels, int heads,
                                       uint32_t threshold, float keep_scale,
                                       void* stream) {
  if (!valid_shape(batch, seq_len, channels, heads) ||
      (threshold > 0 && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPNF_BWD(D)                                                         \
  launch_bwd<D>(seed, qkv, g, dqkv, stats, batch, seq_len, channels, heads, \
                threshold, keep_scale, s)
  cudaError_t err;
  switch (channels / heads) {
    case 4: err = GPNF_BWD(4); break;
    case 8: err = GPNF_BWD(8); break;
    case 16: err = GPNF_BWD(16); break;
    case 24: err = GPNF_BWD(24); break;
    case 32: err = GPNF_BWD(32); break;
    case 48: err = GPNF_BWD(48); break;
    case 64: err = GPNF_BWD(64); break;
    default: err = cudaErrorInvalidValue;
  }
#undef GPNF_BWD
  return static_cast<int>(err);
}
