// Key-tiled multi-head attention: the forward with in-kernel dropout and
// the backward's two kernels, shared by fused_attention_long.cu (packed
// qkv, 512 < S <= 2048) and fused_attention.cu (separate q, k, v, or packed
// qkv, S <= 512). One template of device code serves every entry; a layout
// says where head (b, h) of each operand starts and how far apart its rows
// are.
//
// For every batch row b and head h, with q, k, v the head's (S, Dh) rows:
//   P = softmax((q_scale q) k^T);  Pd = keep * P / (1 - rate);  out = Pd v
// q_scale is Dh^-1/2 where the caller hands q unscaled (the packed entries:
// q is scaled as it is loaded) and 1 where q comes scaled (the separate
// entry). The keep bit of score (b, h, i, j) is word (j & 3) of Philox at
// counter (j >> 2, i, h, b) (philox.cuh), the same pure function of
// (seed, b, h, i, j) as in fused_attention_proj.cu, so at one seed every
// attention entry drops the same scores.
//
// Backward, with g = d out:
//   dV = Pd^T g;  dPd = g V^T;  dP = keep * dPd / (1 - rate)
//   dS = P * (dP - D),  D_i = sum_j dP_ij P_ij
//   dq = dS K * q_scale;  dK = dS^T (q_scale q)
//
// Design (simple and exact first; tensor cores and TMA are later work).
// The Pallas kernels hold one head's (S, S) fp32 scores (4 MB at S=1024),
// and a head's K and V whole (2*S*Dh*4 B, 256 KB at S=512, Dh=64) exceed a
// 227 KB block. So the key axis is tiled, and shared memory does not grow
// with S:
//   - forward: a block per (64 queries, head, batch row), a thread per
//     query; q (times q_scale) and the output accumulator sit in registers
//     (Dh is a template parameter); K and V stream through shared memory in
//     tiles of 64 keys, read by every thread as warp-wide broadcasts; the
//     online softmax of the proj kernel (the denominator sums every
//     exp(s - m); the accumulator adds only the kept terms, scaled); one
//     Philox call per four keys;
//   - backward, kernel 1 (a thread per query): pass A over the key tiles
//     finds m_i, l_i and D_i online (D rescales like the denominator);
//     pass B accumulates dq_i = sum_j p_ij (dP_ij - D_i) k_j and writes it
//     times q_scale, and (m_i, 1/l_i, D_i) into a (B, H, S, 3) scratch;
//   - backward, kernel 2 (a thread per key): loops over query tiles of q,
//     g and the stats in shared memory and accumulates dV_j and dK_j.
//   No atomics: each output element is written once by one thread, so the
//   backward repeats bit for bit. The packed layout reads qkv and writes
//   dqkv (B, S, 3C) in place, with no head split or merge copies.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "philox.cuh"

namespace gpnf {

constexpr int kAttnRows = 64;  // queries (forward, dq) or keys (dK/dV) a block
constexpr int kAttnTile = 64;  // keys (or queries) per shared-memory tile

// qkv (B, S, 3C) packed [k | v | q] along the channels, out and g (B, S, C),
// dqkv (B, S, 3C) packed as qkv. q, k, v (and dq, dk, dv) point at the
// first element of their third: qkv + 2C, qkv, qkv + C.
template <int D>
struct PackedQkv {
  static constexpr int kHeadDim = D;
  int seq_len, heads;
  __device__ size_t in_head(int b, int h) const {
    return static_cast<size_t>(b) * seq_len * 3 * heads * D + h * D;
  }
  __device__ size_t in_row() const { return 3 * static_cast<size_t>(heads) * D; }
  __device__ size_t out_head(int b, int h) const {
    return static_cast<size_t>(b) * seq_len * heads * D + h * D;
  }
  __device__ size_t out_row() const { return static_cast<size_t>(heads) * D; }
};

// q, k, v, out, g and dq, dk, dv: separate (B, H, S, Dh) tensors.
template <int D>
struct SplitHeads {
  static constexpr int kHeadDim = D;
  int seq_len, heads;
  __device__ size_t in_head(int b, int h) const {
    return (static_cast<size_t>(b) * heads + h) * seq_len * D;
  }
  __device__ size_t in_row() const { return D; }
  __device__ size_t out_head(int b, int h) const { return in_head(b, h); }
  __device__ size_t out_row() const { return D; }
};

// Rows [r0, r0 + kAttnTile) of the (S, Dh) slice that starts at `src` (row
// stride `stride` floats) into dst (kAttnTile, DH), times `scale`; rows past
// S are zero.
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int seq_len, size_t stride,
                                          float scale) {
  for (int e = threadIdx.x; e < kAttnTile * DH; e += blockDim.x) {
    const int r = e / DH;
    const int d = e - r * DH;
    dst[e] = r0 + r < seq_len
                 ? src[static_cast<size_t>(r0 + r) * stride + d] * scale
                 : 0.f;
  }
}

template <class Layout, bool DROPOUT>
__global__ void __launch_bounds__(kAttnRows)
    attention_tiled_fwd_kernel(Layout lay, const int* __restrict__ seed_ptr,
                               const float* __restrict__ q_in,
                               const float* __restrict__ k_in,
                               const float* __restrict__ v_in,
                               float* __restrict__ out, float q_scale,
                               uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  __shared__ __align__(16) float k_s[kAttnTile * DH];
  __shared__ __align__(16) float v_s[kAttnTile * DH];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int qi = blockIdx.x * kAttnRows + threadIdx.x;
  const bool valid = qi < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  float q[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = valid ? q_in[head + qi * row + d] * q_scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < seq_len; j0 += kAttnTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<DH>(k_s, k_in + head, j0, seq_len, row, 1.f);
    load_tile<DH>(v_s, v_in + head, j0, seq_len, row, 1.f);
    __syncthreads();
    if (!valid) continue;
    const int nk = min(kAttnTile, seq_len - j0);
    for (int t = 0; t < nk; t += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) bits = attention_dropout_bits(seed, b, h, qi, (j0 + t) >> 2);
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
          pd = philox_word(bits, jj) >= threshold ? p * keep_scale : 0.f;
        }
        const float* vj = v_s + (t + jj) * DH;
#pragma unroll
        for (int d = 0; d < DH; ++d) acc[d] = fmaf(pd, vj[d], acc[d]);
      }
    }
  }
  if (!valid) return;
  const float inv_l = 1.f / l;
  float* o = out + lay.out_head(b, h) + qi * lay.out_row();
#pragma unroll
  for (int d = 0; d < DH; ++d) o[d] = acc[d] * inv_l;
}

// Backward kernel 1: a thread per query -> dq (times q_scale), and
// (m, 1/l, D) of the row into stats (B, H, S, 3).
template <class Layout, bool DROPOUT>
__global__ void __launch_bounds__(kAttnRows)
    attention_tiled_dq_kernel(Layout lay, const int* __restrict__ seed_ptr,
                              const float* __restrict__ q_in,
                              const float* __restrict__ k_in,
                              const float* __restrict__ v_in,
                              const float* __restrict__ g,
                              float* __restrict__ dq_out,
                              float* __restrict__ stats, float q_scale,
                              uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  __shared__ __align__(16) float k_s[kAttnTile * DH];
  __shared__ __align__(16) float v_s[kAttnTile * DH];
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int qi = blockIdx.x * kAttnRows + threadIdx.x;
  const bool valid = qi < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  float q[DH], gi[DH];
  const float* g_row = g + lay.out_head(b, h) + qi * lay.out_row();
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = valid ? q_in[head + qi * row + d] * q_scale : 0.f;
    gi[d] = valid ? g_row[d] : 0.f;
  }

  // pass A: row max m, denominator l and dsum = sum_j exp(s_j - m) dP_j,
  // rescaled together whenever m grows
  float m = -INFINITY, l = 0.f, dsum = 0.f;
  for (int j0 = 0; j0 < seq_len; j0 += kAttnTile) {
    __syncthreads();
    load_tile<DH>(k_s, k_in + head, j0, seq_len, row, 1.f);
    load_tile<DH>(v_s, v_in + head, j0, seq_len, row, 1.f);
    __syncthreads();
    if (!valid) continue;
    const int nk = min(kAttnTile, seq_len - j0);
    for (int t = 0; t < nk; t += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) bits = attention_dropout_bits(seed, b, h, qi, (j0 + t) >> 2);
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
          dp = philox_word(bits, jj) >= threshold ? dpd * keep_scale : 0.f;
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
  for (int j0 = 0; j0 < seq_len; j0 += kAttnTile) {
    __syncthreads();
    load_tile<DH>(k_s, k_in + head, j0, seq_len, row, 1.f);
    load_tile<DH>(v_s, v_in + head, j0, seq_len, row, 1.f);
    __syncthreads();
    if (!valid) continue;
    const int nk = min(kAttnTile, seq_len - j0);
    for (int t = 0; t < nk; t += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) bits = attention_dropout_bits(seed, b, h, qi, (j0 + t) >> 2);
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
          dp = philox_word(bits, jj) >= threshold ? dpd * keep_scale : 0.f;
        }
        const float ds = expf(score - m) * inv_l * (dp - big_d);
#pragma unroll
        for (int d = 0; d < DH; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
      }
    }
  }
  if (!valid) return;
  float* dst = dq_out + head + qi * row;
#pragma unroll
  for (int d = 0; d < DH; ++d) dst[d] = dq[d] * q_scale;
  float* st =
      stats + ((static_cast<size_t>(b) * lay.heads + h) * seq_len + qi) * 3;
  st[0] = m;
  st[1] = inv_l;
  st[2] = big_d;
}

// Backward kernel 2: a thread per key -> dK and dV.
template <class Layout, bool DROPOUT>
__global__ void __launch_bounds__(kAttnRows)
    attention_tiled_dkv_kernel(Layout lay, const int* __restrict__ seed_ptr,
                               const float* __restrict__ q_in,
                               const float* __restrict__ k_in,
                               const float* __restrict__ v_in,
                               const float* __restrict__ g,
                               const float* __restrict__ stats,
                               float* __restrict__ dk_out,
                               float* __restrict__ dv_out, float q_scale,
                               uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  __shared__ __align__(16) float q_s[kAttnTile * DH];  // q rows * q_scale
  __shared__ __align__(16) float g_s[kAttnTile * DH];
  __shared__ float st_s[kAttnTile * 3];                // m, 1/l, D per query
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int kj = blockIdx.x * kAttnRows + threadIdx.x;
  const bool valid = kj < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const float* g_head = g + lay.out_head(b, h);
  const float* st_head =
      stats + (static_cast<size_t>(b) * lay.heads + h) * seq_len * 3;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  float k[DH], v[DH], dk[DH], dv[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    k[d] = valid ? k_in[head + kj * row + d] : 0.f;
    v[d] = valid ? v_in[head + kj * row + d] : 0.f;
    dk[d] = 0.f;
    dv[d] = 0.f;
  }
  const int quad = kj >> 2;
  const int sel = kj & 3;
  for (int i0 = 0; i0 < seq_len; i0 += kAttnTile) {
    __syncthreads();
    load_tile<DH>(q_s, q_in + head, i0, seq_len, row, q_scale);
    load_tile<DH>(g_s, g_head, i0, seq_len, lay.out_row(), 1.f);
    const int ni = min(kAttnTile, seq_len - i0);
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
            philox_word(attention_dropout_bits(seed, b, h, i0 + ii, quad),
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
  const size_t at = head + kj * row;
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    dk_out[at + d] = dk[d];
    dv_out[at + d] = dv[d];
  }
}

template <class Layout>
cudaError_t attention_tiled_fwd(Layout lay, int batch, const int* seed,
                                const float* q, const float* k,
                                const float* v, float* out, float q_scale,
                                uint32_t threshold, float keep_scale,
                                cudaStream_t stream) {
  const dim3 grid((lay.seq_len + kAttnRows - 1) / kAttnRows, lay.heads,
                  batch);
  if (threshold > 0) {
    attention_tiled_fwd_kernel<Layout, true><<<grid, kAttnRows, 0, stream>>>(
        lay, seed, q, k, v, out, q_scale, threshold, keep_scale);
  } else {
    attention_tiled_fwd_kernel<Layout, false><<<grid, kAttnRows, 0, stream>>>(
        lay, seed, q, k, v, out, q_scale, threshold, keep_scale);
  }
  return cudaGetLastError();
}

template <class Layout>
cudaError_t attention_tiled_bwd(Layout lay, int batch, const int* seed,
                                const float* q, const float* k,
                                const float* v, const float* g, float* dq,
                                float* dk, float* dv, float* stats,
                                float q_scale, uint32_t threshold,
                                float keep_scale, cudaStream_t stream) {
  const dim3 grid((lay.seq_len + kAttnRows - 1) / kAttnRows, lay.heads,
                  batch);
  if (threshold > 0) {
    attention_tiled_dq_kernel<Layout, true><<<grid, kAttnRows, 0, stream>>>(
        lay, seed, q, k, v, g, dq, stats, q_scale, threshold, keep_scale);
  } else {
    attention_tiled_dq_kernel<Layout, false><<<grid, kAttnRows, 0, stream>>>(
        lay, seed, q, k, v, g, dq, stats, q_scale, threshold, keep_scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (threshold > 0) {
    attention_tiled_dkv_kernel<Layout, true><<<grid, kAttnRows, 0, stream>>>(
        lay, seed, q, k, v, g, stats, dk, dv, q_scale, threshold, keep_scale);
  } else {
    attention_tiled_dkv_kernel<Layout, false><<<grid, kAttnRows, 0, stream>>>(
        lay, seed, q, k, v, g, stats, dk, dv, q_scale, threshold, keep_scale);
  }
  return cudaGetLastError();
}

// fn(Layout<D>{seq_len, heads}) for D = head_dim among the widths built
// (the wrappers' HEAD_DIMS); cudaErrorInvalidValue for any other.
template <template <int> class Layout, class Fn>
cudaError_t with_head_dim(int head_dim, int seq_len, int heads, Fn fn) {
  switch (head_dim) {
    case 4: return fn(Layout<4>{seq_len, heads});
    case 8: return fn(Layout<8>{seq_len, heads});
    case 16: return fn(Layout<16>{seq_len, heads});
    case 24: return fn(Layout<24>{seq_len, heads});
    case 32: return fn(Layout<32>{seq_len, heads});
    case 48: return fn(Layout<48>{seq_len, heads});
    case 64: return fn(Layout<64>{seq_len, heads});
    default: return cudaErrorInvalidValue;
  }
}

inline bool attention_args_ok(int batch, int seq_len, int heads,
                              int head_dim, int max_seq_len, const int* seed,
                              uint32_t threshold) {
  return batch > 0 && seq_len > 0 && seq_len <= max_seq_len && heads > 0 &&
         head_dim > 0 && batch <= 65535 && heads <= 65535 &&
         (threshold == 0 || seed != nullptr);
}

// out (B, S, C) from qkv (B, S, 3C) packed [k | v | q], q scaled by
// Dh^-1/2 as it is loaded.
inline int attention_packed_fwd(const int* seed, const float* qkv, float* out,
                                int batch, int seq_len, int channels,
                                int heads, int max_seq_len, uint32_t threshold,
                                float keep_scale, void* stream) {
  if (heads <= 0 || channels % heads != 0 ||
      !attention_args_ok(batch, seq_len, heads, channels / heads, max_seq_len,
                         seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh = channels / heads;
  const float q_scale = 1.f / sqrtf(static_cast<float>(dh));
  return static_cast<int>(with_head_dim<PackedQkv>(
      dh, seq_len, heads, [&](auto lay) {
        return attention_tiled_fwd(lay, batch, seed, qkv + 2 * channels, qkv,
                                   qkv + channels, out, q_scale, threshold,
                                   keep_scale,
                                   static_cast<cudaStream_t>(stream));
      }));
}

// dqkv (B, S, 3C) packed [dK | dV | dq * Dh^-1/2] from (seed, qkv, g);
// stats is the caller's (B, H, S, 3) scratch.
inline int attention_packed_bwd(const int* seed, const float* qkv,
                                const float* g, float* dqkv, float* stats,
                                int batch, int seq_len, int channels,
                                int heads, int max_seq_len, uint32_t threshold,
                                float keep_scale, void* stream) {
  if (heads <= 0 || channels % heads != 0 ||
      !attention_args_ok(batch, seq_len, heads, channels / heads, max_seq_len,
                         seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh = channels / heads;
  const float q_scale = 1.f / sqrtf(static_cast<float>(dh));
  return static_cast<int>(with_head_dim<PackedQkv>(
      dh, seq_len, heads, [&](auto lay) {
        return attention_tiled_bwd(lay, batch, seed, qkv + 2 * channels, qkv,
                                   qkv + channels, g, dqkv + 2 * channels,
                                   dqkv, dqkv + channels, stats, q_scale,
                                   threshold, keep_scale,
                                   static_cast<cudaStream_t>(stream));
      }));
}

}  // namespace gpnf
