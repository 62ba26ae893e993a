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
// Dh = 128 and 256 (the lane-split kernels below): a thread cannot hold
// q[Dh] and acc[Dh] (Dh = 64 already takes 255 registers and spills), so a
// row is held by Dh / 32 adjacent lanes of one warp, 32 dimensions each;
// the partial dot products are summed across those lanes by shuffles, and
// every lane runs the same online softmax. Same passes, same Philox calls
// (one a four keys, the same words), sums in key (or query) order, no
// atomics: two calls give the same bits. Dh <= 64 runs the thread-a-row
// kernels, unchanged.
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

// -- the lane-split kernels: Dh = 128 and 256 -----------------------------------
// Each query row (forward, dq) or key row (dK/dV) is held by kLanes =
// Dh / 32 adjacent lanes of one warp, each holding 32 of its dimensions:
// float4 chunk c (of 8) of lane p holds dimensions 4 (c kLanes + p) .. +3,
// so the kLanes lanes of a row read kLanes adjacent float4s of a
// shared-memory row at once (no bank conflict; the rows of a warp read the
// same key, a broadcast). A score's kLanes partial dot products are summed
// by __shfl_xor_sync across the row's lanes: a butterfly, whose every level
// adds the same two values in one order or the other, so every lane holds
// the same bits and runs the same online softmax and keep test. A block is
// 256 threads, 256 / kLanes rows (64 at Dh = 128, 32 at 256); its two tiles
// of 64 rows (K and V, or q and g) take 64 KB at Dh = 128 and 128 KB at
// 256, so they are dynamic shared memory. Every thread runs every loop (a
// row past S on zeros), so the shuffles always see whole warps.
constexpr int kMaxRowHeadDim = 64;  // above: the lane-split kernels
constexpr int kLaneDims = 32;       // dimensions a lane holds
constexpr int kLaneThreads = 256;   // threads a block

template <int DH>
struct Lanes {
  static constexpr int kLanes = DH / kLaneDims;  // lanes a row
  static constexpr int kChunks = kLaneDims / 4;  // float4s a lane
  static constexpr int kRows = kLaneThreads / kLanes;
  static constexpr size_t kTileBytes = sizeof(float) * kAttnTile * DH;
};

template <int LANES>
__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// The dimensions of row `src` that lane `part` holds, times `scale`; zeros
// where the row is past S.
template <int DH>
__device__ __forceinline__ void lane_load(float4* x, const float* src,
                                          int part, bool valid, float scale) {
#pragma unroll
  for (int c = 0; c < Lanes<DH>::kChunks; ++c) {
    const int d = 4 * (c * Lanes<DH>::kLanes + part);
    x[c] = valid ? make_float4(src[d] * scale, src[d + 1] * scale,
                               src[d + 2] * scale, src[d + 3] * scale)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int DH>
__device__ __forceinline__ void lane_store(float* dst, const float4* x,
                                           int part, float scale) {
#pragma unroll
  for (int c = 0; c < Lanes<DH>::kChunks; ++c) {
    const int d = 4 * (c * Lanes<DH>::kLanes + part);
    dst[d] = x[c].x * scale;
    dst[d + 1] = x[c].y * scale;
    dst[d + 2] = x[c].z * scale;
    dst[d + 3] = x[c].w * scale;
  }
}

// The lane's part of x . row, row a 16-byte aligned shared-memory row.
template <int DH>
__device__ __forceinline__ float lane_dot(const float4* x, const float* row,
                                          int part) {
  const float4* r = reinterpret_cast<const float4*>(row);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < Lanes<DH>::kChunks; ++c) {
    const float4 y = r[c * Lanes<DH>::kLanes + part];
    s = fmaf(x[c].x, y.x, s);
    s = fmaf(x[c].y, y.y, s);
    s = fmaf(x[c].z, y.z, s);
    s = fmaf(x[c].w, y.w, s);
  }
  return s;
}

// acc += a * (the lane's part of row)
template <int DH>
__device__ __forceinline__ void lane_axpy(float4* acc, float a,
                                          const float* row, int part) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < Lanes<DH>::kChunks; ++c) {
    const float4 y = r[c * Lanes<DH>::kLanes + part];
    acc[c].x = fmaf(a, y.x, acc[c].x);
    acc[c].y = fmaf(a, y.y, acc[c].y);
    acc[c].z = fmaf(a, y.z, acc[c].z);
    acc[c].w = fmaf(a, y.w, acc[c].w);
  }
}

template <int DH>
__device__ __forceinline__ void lane_fill(float4* x, float a) {
#pragma unroll
  for (int c = 0; c < Lanes<DH>::kChunks; ++c) x[c] = make_float4(a, a, a, a);
}

template <int DH>
__device__ __forceinline__ void lane_scale(float4* x, float a) {
#pragma unroll
  for (int c = 0; c < Lanes<DH>::kChunks; ++c) {
    x[c].x *= a;
    x[c].y *= a;
    x[c].z *= a;
    x[c].w *= a;
  }
}

// The forward: kLanes lanes a query row.
template <class Layout, bool DROPOUT>
__global__ void __launch_bounds__(kLaneThreads)
    attention_lanes_fwd_kernel(Layout lay, const int* __restrict__ seed_ptr,
                               const float* __restrict__ q_in,
                               const float* __restrict__ k_in,
                               const float* __restrict__ v_in,
                               float* __restrict__ out, float q_scale,
                               uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  constexpr int L = Lanes<DH>::kLanes;
  extern __shared__ float4 lanes_smem[];
  float* k_s = reinterpret_cast<float*>(lanes_smem);
  float* v_s = k_s + kAttnTile * DH;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int part = threadIdx.x % L;
  const int qi = blockIdx.x * Lanes<DH>::kRows + threadIdx.x / L;
  const bool valid = qi < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  float4 q[Lanes<DH>::kChunks], acc[Lanes<DH>::kChunks];
  lane_load<DH>(q, q_in + head + qi * row, part, valid, q_scale);
  lane_fill<DH>(acc, 0.f);
  float m = -INFINITY, l = 0.f;
  for (int j0 = 0; j0 < seq_len; j0 += kAttnTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<DH>(k_s, k_in + head, j0, seq_len, row, 1.f);
    load_tile<DH>(v_s, v_in + head, j0, seq_len, row, 1.f);
    __syncthreads();
    const int nk = min(kAttnTile, seq_len - j0);
    for (int t = 0; t < nk; t += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) bits = attention_dropout_bits(seed, b, h, qi, (j0 + t) >> 2);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (t + jj >= nk) break;
        const float score =
            lanes_sum<L>(lane_dot<DH>(q, k_s + (t + jj) * DH, part));
        if (score > m) {
          const float corr = expf(m - score);
          l *= corr;
          lane_scale<DH>(acc, corr);
          m = score;
        }
        const float p = expf(score - m);
        l += p;
        float pd = p;
        if (DROPOUT) {
          pd = philox_word(bits, jj) >= threshold ? p * keep_scale : 0.f;
        }
        lane_axpy<DH>(acc, pd, v_s + (t + jj) * DH, part);
      }
    }
  }
  if (!valid) return;
  lane_store<DH>(out + lay.out_head(b, h) + qi * lay.out_row(), acc, part,
                 1.f / l);
}

// Backward kernel 1: kLanes lanes a query row -> dq (times q_scale), and
// (m, 1/l, D) of the row into stats (B, H, S, 3).
template <class Layout, bool DROPOUT>
__global__ void __launch_bounds__(kLaneThreads)
    attention_lanes_dq_kernel(Layout lay, const int* __restrict__ seed_ptr,
                              const float* __restrict__ q_in,
                              const float* __restrict__ k_in,
                              const float* __restrict__ v_in,
                              const float* __restrict__ g,
                              float* __restrict__ dq_out,
                              float* __restrict__ stats, float q_scale,
                              uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  constexpr int L = Lanes<DH>::kLanes;
  extern __shared__ float4 lanes_smem[];
  float* k_s = reinterpret_cast<float*>(lanes_smem);
  float* v_s = k_s + kAttnTile * DH;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int part = threadIdx.x % L;
  const int qi = blockIdx.x * Lanes<DH>::kRows + threadIdx.x / L;
  const bool valid = qi < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  float4 q[Lanes<DH>::kChunks], gi[Lanes<DH>::kChunks];
  lane_load<DH>(q, q_in + head + qi * row, part, valid, q_scale);
  lane_load<DH>(gi, g + lay.out_head(b, h) + qi * lay.out_row(), part, valid,
                1.f);

  // pass A: m, l and dsum = sum_j exp(s_j - m) dP_j, rescaled together
  float m = -INFINITY, l = 0.f, dsum = 0.f;
  for (int j0 = 0; j0 < seq_len; j0 += kAttnTile) {
    __syncthreads();
    load_tile<DH>(k_s, k_in + head, j0, seq_len, row, 1.f);
    load_tile<DH>(v_s, v_in + head, j0, seq_len, row, 1.f);
    __syncthreads();
    const int nk = min(kAttnTile, seq_len - j0);
    for (int t = 0; t < nk; t += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) bits = attention_dropout_bits(seed, b, h, qi, (j0 + t) >> 2);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (t + jj >= nk) break;
        const float score =
            lanes_sum<L>(lane_dot<DH>(q, k_s + (t + jj) * DH, part));
        const float dpd =
            lanes_sum<L>(lane_dot<DH>(gi, v_s + (t + jj) * DH, part));
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
  const float inv_l = 1.f / l;
  const float big_d = dsum * inv_l;

  // pass B: dq_i = sum_j p_ij (dP_ij - D_i) k_j
  float4 dq[Lanes<DH>::kChunks];
  lane_fill<DH>(dq, 0.f);
  for (int j0 = 0; j0 < seq_len; j0 += kAttnTile) {
    __syncthreads();
    load_tile<DH>(k_s, k_in + head, j0, seq_len, row, 1.f);
    load_tile<DH>(v_s, v_in + head, j0, seq_len, row, 1.f);
    __syncthreads();
    const int nk = min(kAttnTile, seq_len - j0);
    for (int t = 0; t < nk; t += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) bits = attention_dropout_bits(seed, b, h, qi, (j0 + t) >> 2);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (t + jj >= nk) break;
        const float* kj = k_s + (t + jj) * DH;
        const float score = lanes_sum<L>(lane_dot<DH>(q, kj, part));
        const float dpd =
            lanes_sum<L>(lane_dot<DH>(gi, v_s + (t + jj) * DH, part));
        float dp = dpd;
        if (DROPOUT) {
          dp = philox_word(bits, jj) >= threshold ? dpd * keep_scale : 0.f;
        }
        const float ds = expf(score - m) * inv_l * (dp - big_d);
        lane_axpy<DH>(dq, ds, kj, part);
      }
    }
  }
  if (!valid) return;
  lane_store<DH>(dq_out + head + qi * row, dq, part, q_scale);
  if (part == 0) {
    float* st =
        stats + ((static_cast<size_t>(b) * lay.heads + h) * seq_len + qi) * 3;
    st[0] = m;
    st[1] = inv_l;
    st[2] = big_d;
  }
}

// Backward kernel 2: kLanes lanes a key row -> dK and dV.
template <class Layout, bool DROPOUT>
__global__ void __launch_bounds__(kLaneThreads)
    attention_lanes_dkv_kernel(Layout lay, const int* __restrict__ seed_ptr,
                               const float* __restrict__ q_in,
                               const float* __restrict__ k_in,
                               const float* __restrict__ v_in,
                               const float* __restrict__ g,
                               const float* __restrict__ stats,
                               float* __restrict__ dk_out,
                               float* __restrict__ dv_out, float q_scale,
                               uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  constexpr int L = Lanes<DH>::kLanes;
  extern __shared__ float4 lanes_smem[];
  float* q_s = reinterpret_cast<float*>(lanes_smem);  // q rows * q_scale
  float* g_s = q_s + kAttnTile * DH;
  float* st_s = g_s + kAttnTile * DH;  // m, 1/l, D per query
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int part = threadIdx.x % L;
  const int kj = blockIdx.x * Lanes<DH>::kRows + threadIdx.x / L;
  const bool valid = kj < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const float* g_head = g + lay.out_head(b, h);
  const float* st_head =
      stats + (static_cast<size_t>(b) * lay.heads + h) * seq_len * 3;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  float4 k[Lanes<DH>::kChunks], v[Lanes<DH>::kChunks];
  float4 dk[Lanes<DH>::kChunks], dv[Lanes<DH>::kChunks];
  lane_load<DH>(k, k_in + head + kj * row, part, valid, 1.f);
  lane_load<DH>(v, v_in + head + kj * row, part, valid, 1.f);
  lane_fill<DH>(dk, 0.f);
  lane_fill<DH>(dv, 0.f);
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
    for (int ii = 0; ii < ni; ++ii) {
      const float* qrow = q_s + ii * DH;
      const float* grow = g_s + ii * DH;
      const float score = lanes_sum<L>(lane_dot<DH>(k, qrow, part));
      const float dpd = lanes_sum<L>(lane_dot<DH>(v, grow, part));
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
      lane_axpy<DH>(dv, pd, grow, part);
      lane_axpy<DH>(dk, ds, qrow, part);
    }
  }
  if (!valid) return;
  lane_store<DH>(dk_out + head + kj * row, dk, part, 1.f);
  lane_store<DH>(dv_out + head + kj * row, dv, part, 1.f);
}

// Launch `kernel` on kLaneThreads threads a block with `bytes` of dynamic
// shared memory (above the 48 KB a static array may take).
template <class Kernel, class... Args>
cudaError_t launch_lanes(Kernel kernel, dim3 grid, size_t bytes,
                         cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kLaneThreads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

template <class Layout>
dim3 lanes_grid(Layout lay, int batch) {
  constexpr int rows = Lanes<Layout::kHeadDim>::kRows;
  return dim3((lay.seq_len + rows - 1) / rows, lay.heads, batch);
}

template <class Layout>
cudaError_t attention_lanes_fwd(Layout lay, int batch, const int* seed,
                                const float* q, const float* k,
                                const float* v, float* out, float q_scale,
                                uint32_t threshold, float keep_scale,
                                cudaStream_t stream) {
  const size_t bytes = 2 * Lanes<Layout::kHeadDim>::kTileBytes;
  auto* kernel = threshold > 0 ? &attention_lanes_fwd_kernel<Layout, true>
                               : &attention_lanes_fwd_kernel<Layout, false>;
  return launch_lanes(kernel, lanes_grid(lay, batch), bytes, stream, lay, seed,
                      q, k, v, out, q_scale, threshold, keep_scale);
}

template <class Layout>
cudaError_t attention_lanes_bwd(Layout lay, int batch, const int* seed,
                                const float* q, const float* k,
                                const float* v, const float* g, float* dq,
                                float* dk, float* dv, float* stats,
                                float q_scale, uint32_t threshold,
                                float keep_scale, cudaStream_t stream) {
  const size_t tiles = 2 * Lanes<Layout::kHeadDim>::kTileBytes;
  auto* dq_kernel = threshold > 0 ? &attention_lanes_dq_kernel<Layout, true>
                                  : &attention_lanes_dq_kernel<Layout, false>;
  cudaError_t err = launch_lanes(dq_kernel, lanes_grid(lay, batch), tiles,
                                 stream, lay, seed, q, k, v, g, dq, stats,
                                 q_scale, threshold, keep_scale);
  if (err != cudaSuccess) return err;
  auto* dkv_kernel = threshold > 0
                         ? &attention_lanes_dkv_kernel<Layout, true>
                         : &attention_lanes_dkv_kernel<Layout, false>;
  return launch_lanes(dkv_kernel, lanes_grid(lay, batch),
                      tiles + sizeof(float) * kAttnTile * 3, stream, lay, seed,
                      q, k, v, g, static_cast<const float*>(stats), dk, dv,
                      q_scale, threshold, keep_scale);
}

template <class Layout>
cudaError_t attention_rows_fwd(Layout lay, int batch, const int* seed,
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
cudaError_t attention_rows_bwd(Layout lay, int batch, const int* seed,
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

// The forward of one layout: a thread a query row up to Dh = 64, the
// lane-split kernels above.
template <class Layout>
cudaError_t attention_tiled_fwd(Layout lay, int batch, const int* seed,
                                const float* q, const float* k,
                                const float* v, float* out, float q_scale,
                                uint32_t threshold, float keep_scale,
                                cudaStream_t stream) {
  if constexpr (Layout::kHeadDim > kMaxRowHeadDim) {
    return attention_lanes_fwd(lay, batch, seed, q, k, v, out, q_scale,
                               threshold, keep_scale, stream);
  } else {
    return attention_rows_fwd(lay, batch, seed, q, k, v, out, q_scale,
                              threshold, keep_scale, stream);
  }
}

// The backward of one layout, as the forward is dispatched.
template <class Layout>
cudaError_t attention_tiled_bwd(Layout lay, int batch, const int* seed,
                                const float* q, const float* k,
                                const float* v, const float* g, float* dq,
                                float* dk, float* dv, float* stats,
                                float q_scale, uint32_t threshold,
                                float keep_scale, cudaStream_t stream) {
  if constexpr (Layout::kHeadDim > kMaxRowHeadDim) {
    return attention_lanes_bwd(lay, batch, seed, q, k, v, g, dq, dk, dv, stats,
                               q_scale, threshold, keep_scale, stream);
  } else {
    return attention_rows_bwd(lay, batch, seed, q, k, v, g, dq, dk, dv, stats,
                              q_scale, threshold, keep_scale, stream);
  }
}

// fn(Layout<D>{seq_len, heads}) for D = head_dim among the widths built
// (the wrappers' HEAD_DIMS: a thread a row up to 64, the lane-split kernels
// at 128 and 256); cudaErrorInvalidValue for any other.
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
    case 128: return fn(Layout<128>{seq_len, heads});
    case 256: return fn(Layout<256>{seq_len, heads});
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
// q_scale as it is loaded: Dh^-1/2, 1.f / sqrtf(Dh), or the true width's
// where the caller zero-padded the heads to a built width.
inline int attention_packed_fwd(const int* seed, const float* qkv, float* out,
                                int batch, int seq_len, int channels,
                                int heads, int max_seq_len, float q_scale,
                                uint32_t threshold, float keep_scale,
                                void* stream) {
  if (heads <= 0 || channels % heads != 0 ||
      !attention_args_ok(batch, seq_len, heads, channels / heads, max_seq_len,
                         seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh = channels / heads;
  return static_cast<int>(with_head_dim<PackedQkv>(
      dh, seq_len, heads, [&](auto lay) {
        return attention_tiled_fwd(lay, batch, seed, qkv + 2 * channels, qkv,
                                   qkv + channels, out, q_scale, threshold,
                                   keep_scale,
                                   static_cast<cudaStream_t>(stream));
      }));
}

// dqkv (B, S, 3C) packed [dK | dV | dq * q_scale] from (seed, qkv, g);
// stats is the caller's (B, H, S, 3) scratch.
inline int attention_packed_bwd(const int* seed, const float* qkv,
                                const float* g, float* dqkv, float* stats,
                                int batch, int seq_len, int channels,
                                int heads, int max_seq_len, float q_scale,
                                uint32_t threshold, float keep_scale,
                                void* stream) {
  if (heads <= 0 || channels % heads != 0 ||
      !attention_args_ok(batch, seq_len, heads, channels / heads, max_seq_len,
                         seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh = channels / heads;
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
