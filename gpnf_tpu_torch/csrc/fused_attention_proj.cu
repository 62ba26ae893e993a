// Multi-head self-attention with the qkv projection inside the kernel,
// forward with in-kernel dropout and backward, hand-written for Hopper
// (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py, `_fwd_kernel_proj`
// (launched by `_run_proj_fwd`) and `_bwd_kernel_proj` (launched by
// `_run_proj_bwd`), both from `fused_attention_proj`.
//
// For every batch row b and head h, with w (3C, C) packed [k | v | q]:
//   k = seq[b] @ w[h*Dh : (h+1)*Dh]^T            (S, Dh)
//   v = seq[b] @ w[C + h*Dh : C + (h+1)*Dh]^T
//   q = seq[b] @ w[2C + h*Dh : 2C + (h+1)*Dh]^T * Dh^-1/2
//   P = softmax(q k^T);  Pd = keep * P / (1 - rate)
//   out[b, :, h*Dh : (h+1)*Dh] = Pd v
// The keep bit of score (b, h, i, j) is `bits >= threshold`, bits from
// philox.cuh as a pure function of (seed, b, h, i, j); threshold =
// rate * 2^32, as the Pallas kernels' `_dropout_keep`. The seed is read on
// the device (a (1,) int32 tensor), so drawing one costs no host sync.
//
// Backward (the JAX module's docstring), with g = d out:
//   dV = Pd^T g;  dPd = g V^T;  dP = keep * dPd / (1 - rate)
//   dS = P * (dP - D),  D_i = sum_j dP_ij P_ij = g_i . out_i
//   dq = dS K * Dh^-1/2;  dK = dS^T q;  dqkv = [dK | dV | dq]
//   dseq = dqkv @ w;  dW = sum over (b, s) of dqkv^T seq
// All arithmetic is fp32; nothing of shape (S, S) reaches device memory.
//
// What bounds it on the H100: operations. At the flagship's level 0
// (B=64, S=256, C=96, 4 heads) the forward is ~2.5 GFLOP (projection 0.9,
// q k^T 0.8, p v 0.8) against ~12.6 MB of traffic: >= ~38 us at the fp32
// rate outside the tensor cores (67 TFLOP/s). The backward is ~6.7 GFLOP
// (projection recompute 0.9, five S x S x Dh products 4.0, dseq 0.9, dW
// 0.9): >= ~0.1 ms. The bytes alone need ~4 us and ~6 us.
//
// Design (simple and exact first; tensor cores and TMA are later work):
//   - one block per (batch, head): K, V and the scaled Q of that head are
//     computed once from seq and the head's 3*Dh weight rows and kept in
//     shared memory (weights and staged seq rows with a padded stride C+1,
//     so that a warp reading 32 rows at one column hits 32 banks);
//   - forward: a thread per query, q and the output accumulator in
//     registers (Dh is a template parameter, 24 on the flagship), keys and
//     values read from shared memory as warp-wide broadcasts, the online
//     softmax (the denominator sums every exp(s - m); the accumulator adds
//     only the kept ones, scaled), one Philox call per four keys;
//   - backward, kernel 1 (per (b, h)): pass A, a thread per query, finds
//     m_i, l_i and D_i (the forward's loop again, then g_i . out_i) and
//     dq_i; pass B, a thread per key, recomputes p_ij from the stored m, l
//     and D and accumulates dV_j and dK_j. No atomics: each dqkv element is
//     written once, into a (B, S, 3C) scratch in device memory. G sits in
//     shared memory while it fits (S <= 256 at C=96); above that pass B
//     reads g_i rows from global memory (broadcast through L1);
//   - backward, kernels 2-4: dseq = dqkv @ w and dW = dqkv^T seq are the
//     products the Pallas kernel computes in its own body, here a tiled
//     fp32 GEMM (64 x 64 tiles, 4 x 4 outputs a thread). dW splits the
//     B*S reduction into fixed chunks whose partial (3C, C) sums a last
//     kernel adds in chunk order, so dW is deterministic, bit for bit.
// Shared memory: forward 4 * (3*Dh*(C+1) + kRows*(C+1) + 3*S*Dh) bytes,
// 114 KB at S=256, C=96, Dh=24; backward adds 3*S floats of m, l, D and
// S*Dh of G: 142 KB (194 KB at S=512 with G left in global memory).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90

__host__ __device__ inline size_t fwd_shared_floats(int seq_len, int channels,
                                                    int dh) {
  const size_t cp = static_cast<size_t>(channels) + 1;
  return 3 * dh * cp + kRows * cp + 3 * static_cast<size_t>(seq_len) * dh;
}

__host__ __device__ inline size_t bwd_shared_floats(int seq_len, int channels,
                                                    int dh, bool g_shared) {
  return fwd_shared_floats(seq_len, channels, dh) + 3 * seq_len +
         (g_shared ? static_cast<size_t>(seq_len) * dh : 0);
}

// K, V and the scaled Q of head h of batch row b into k_s, v_s, q_s (each
// (S, DH)); w_s and x_s are the weight and staging regions. Ends with a
// __syncthreads().
template <int DH>
__device__ void project_head(const float* __restrict__ seq,
                             const float* __restrict__ w, float* w_s,
                             float* x_s, float* k_s, float* v_s, float* q_s,
                             int b, int h, int seq_len, int channels,
                             float q_scale) {
  const int cp = channels + 1;
  for (int i = threadIdx.x; i < 3 * DH * channels; i += blockDim.x) {
    const int r = i / channels;
    const int c = i - r * channels;
    const int part = r / DH;  // 0: k, 1: v, 2: q
    const int d = r - part * DH;
    w_s[r * cp + c] =
        w[static_cast<size_t>(part * channels + h * DH + d) * channels + c];
  }
  const float* xb = seq + static_cast<size_t>(b) * seq_len * channels;
  for (int s0 = 0; s0 < seq_len; s0 += kRows) {
    const int rows = min(kRows, seq_len - s0);
    __syncthreads();  // w_s written; previous chunk of x_s consumed
    for (int i = threadIdx.x; i < rows * channels; i += blockDim.x) {
      const int r = i / channels;
      const int c = i - r * channels;
      x_s[r * cp + c] = xb[static_cast<size_t>(s0 + r) * channels + c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * 3 * DH; i += blockDim.x) {
      const int r = i / (3 * DH);
      const int o = i - r * 3 * DH;
      const float* xr = x_s + r * cp;
      const float* wr = w_s + o * cp;
      float acc = 0.f;
      for (int c = 0; c < channels; ++c) acc = fmaf(xr[c], wr[c], acc);
      const int part = o / DH;
      const int d = o - part * DH;
      if (part == 0) {
        k_s[(s0 + r) * DH + d] = acc;
      } else if (part == 1) {
        v_s[(s0 + r) * DH + d] = acc;
      } else {
        q_s[(s0 + r) * DH + d] = acc * q_scale;
      }
    }
  }
  __syncthreads();
}

// Row max m, denominator l and the unnormalised output acc (kept scores
// only, scaled) of query qi: the online softmax the forward runs.
template <int DH, bool DROPOUT>
__device__ __forceinline__ void online_row(const float (&q)[DH],
                                           const float* k_s, const float* v_s,
                                           int seq_len, uint32_t seed, int b,
                                           int h, int qi, uint32_t threshold,
                                           float keep_scale, float& m,
                                           float& l, float (&acc)[DH]) {
  m = -INFINITY;
  l = 0.f;
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  for (int j0 = 0; j0 < seq_len; j0 += 4) {
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
    if (DROPOUT) bits = gpnf::attention_dropout_bits(seed, b, h, qi, j0 >> 2);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + jj;
      if (j >= seq_len) break;
      const float* kj = k_s + j * DH;
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
      const float* vj = v_s + j * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(pd, vj[d], acc[d]);
    }
  }
}

template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    attention_proj_fwd_kernel(const int* __restrict__ seed_ptr,
                              const float* __restrict__ seq,
                              const float* __restrict__ w,
                              float* __restrict__ out, int seq_len,
                              int channels, int heads, float q_scale,
                              uint32_t threshold, float keep_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int cp = channels + 1;
  float* w_s = smem;                 // (3*DH, cp): rows k, v, q of head h
  float* x_s = w_s + 3 * DH * cp;    // (kRows, cp): staged seq rows
  float* k_s = x_s + kRows * cp;     // (S, DH)
  float* v_s = k_s + seq_len * DH;   // (S, DH)
  float* q_s = v_s + seq_len * DH;   // (S, DH), already scaled
  project_head<DH>(seq, w, w_s, x_s, k_s, v_s, q_s, b, h, seq_len, channels,
                   q_scale);
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  for (int qi = threadIdx.x; qi < seq_len; qi += blockDim.x) {
    float q[DH];
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = q_s[qi * DH + d];
    float m, l;
    online_row<DH, DROPOUT>(q, k_s, v_s, seq_len, seed, b, h, qi, threshold,
                            keep_scale, m, l, acc);
    const float inv_l = 1.f / l;
    float* o = out + (static_cast<size_t>(b) * seq_len + qi) * channels + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = acc[d] * inv_l;
  }
}

template <int DH, bool DROPOUT>
__global__ void __launch_bounds__(kThreads)
    attention_proj_bwd_kernel(const int* __restrict__ seed_ptr,
                              const float* __restrict__ seq,
                              const float* __restrict__ w,
                              const float* __restrict__ g,
                              float* __restrict__ dqkv, int seq_len,
                              int channels, int heads, float q_scale,
                              uint32_t threshold, float keep_scale,
                              int g_shared) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int cp = channels + 1;
  float* w_s = smem;
  float* x_s = w_s + 3 * DH * cp;
  float* k_s = x_s + kRows * cp;
  float* v_s = k_s + seq_len * DH;
  float* q_s = v_s + seq_len * DH;
  float* m_s = q_s + seq_len * DH;   // (S): row max
  float* il_s = m_s + seq_len;       // (S): 1 / row sum
  float* d_s = il_s + seq_len;       // (S): D_i
  float* g_s = d_s + seq_len;        // (S, DH) when g_shared
  project_head<DH>(seq, w, w_s, x_s, k_s, v_s, q_s, b, h, seq_len, channels,
                   q_scale);
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;
  const float* g_head =
      g + static_cast<size_t>(b) * seq_len * channels + h * DH;
  if (g_shared) {
    for (int i = threadIdx.x; i < seq_len * DH; i += blockDim.x) {
      const int r = i / DH;
      g_s[i] = g_head[static_cast<size_t>(r) * channels + (i - r * DH)];
    }
  }
  const float* g_rows = g_shared ? g_s : g_head;
  const int g_stride = g_shared ? DH : channels;
  const size_t c3 = 3 * static_cast<size_t>(channels);
  float* dqkv_b = dqkv + static_cast<size_t>(b) * seq_len * c3;

  // pass A: a thread per query -> m_i, 1/l_i, D_i, dq_i
  for (int qi = threadIdx.x; qi < seq_len; qi += blockDim.x) {
    float q[DH], gi[DH], acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      q[d] = q_s[qi * DH + d];
      gi[d] = g_head[static_cast<size_t>(qi) * channels + d];
    }
    float m, l;
    online_row<DH, DROPOUT>(q, k_s, v_s, seq_len, seed, b, h, qi, threshold,
                            keep_scale, m, l, acc);
    const float inv_l = 1.f / l;
    float big_d = 0.f;
#pragma unroll
    for (int d = 0; d < DH; ++d) big_d = fmaf(gi[d], acc[d] * inv_l, big_d);
    m_s[qi] = m;
    il_s[qi] = inv_l;
    d_s[qi] = big_d;
    float dq[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[d] = 0.f;
    for (int j0 = 0; j0 < seq_len; j0 += 4) {
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) bits = gpnf::attention_dropout_bits(seed, b, h, qi, j0 >> 2);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj;
        if (j >= seq_len) break;
        const float* kj = k_s + j * DH;
        const float* vj = v_s + j * DH;
        float score = 0.f, dpd = 0.f;
#pragma unroll
        for (int d = 0; d < DH; ++d) {
          score = fmaf(q[d], kj[d], score);
          dpd = fmaf(gi[d], vj[d], dpd);
        }
        const float p = expf(score - m) * inv_l;
        float dp = dpd;
        if (DROPOUT) {
          dp = gpnf::philox_word(bits, jj) >= threshold ? dpd * keep_scale
                                                        : 0.f;
        }
        const float ds = p * (dp - big_d);
#pragma unroll
        for (int d = 0; d < DH; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
      }
    }
    float* row = dqkv_b + static_cast<size_t>(qi) * c3 + 2 * channels + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) row[d] = dq[d] * q_scale;
  }
  __syncthreads();

  // pass B: a thread per key -> dV_j, dK_j
  for (int kj = threadIdx.x; kj < seq_len; kj += blockDim.x) {
    float k[DH], v[DH], dk[DH], dv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      k[d] = k_s[kj * DH + d];
      v[d] = v_s[kj * DH + d];
      dk[d] = 0.f;
      dv[d] = 0.f;
    }
    const int quad = kj >> 2;
    const int sel = kj & 3;
    for (int i = 0; i < seq_len; ++i) {
      const float* qrow = q_s + i * DH;
      const float* grow = g_rows + static_cast<size_t>(i) * g_stride;
      float score = 0.f, dpd = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        score = fmaf(qrow[d], k[d], score);
        dpd = fmaf(grow[d], v[d], dpd);
      }
      const float p = expf(score - m_s[i]) * il_s[i];
      float pd = p, dp = dpd;
      if (DROPOUT) {
        const bool keep =
            gpnf::philox_word(gpnf::attention_dropout_bits(seed, b, h, i, quad),
                              sel) >= threshold;
        pd = keep ? p * keep_scale : 0.f;
        dp = keep ? dpd * keep_scale : 0.f;
      }
      const float ds = p * (dp - d_s[i]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dv[d] = fmaf(pd, grow[d], dv[d]);
        dk[d] = fmaf(ds, qrow[d], dk[d]);
      }
    }
    float* row = dqkv_b + static_cast<size_t>(kj) * c3 + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      row[d] = dk[d];
      row[channels + d] = dv[d];
    }
  }
}

// C[z] (M, N) = sum over k in chunk z of A[m*sam + k*sak] * B[k*sbk + n*sbn]:
// a plain tiled fp32 GEMM (64 x 64 output tile, 16-deep k tiles, 256
// threads of 4 x 4 outputs each) with strided operands, so that one kernel
// computes dseq = dqkv @ w and the split-k partials of dW = dqkv^T seq.
constexpr int kBM = 64, kBN = 64, kBK = 16;

__global__ void __launch_bounds__(256)
    gemm_strided_kernel(const float* __restrict__ a, const float* __restrict__ bmat,
                        float* __restrict__ c, int m_size, int n_size, int k_size,
                        int sam, int sak, int sbk, int sbn, int k_chunk) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN + 4];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(k_size, kbeg + k_chunk);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += blockDim.x) {
      // neighbouring threads on the operand's unit-stride axis
      const int mm = sak == 1 ? e / kBK : e % kBM;
      const int kk = sak == 1 ? e % kBK : e / kBM;
      const int gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] = (gm < m_size && gk < kend)
                       ? a[static_cast<size_t>(gm) * sam +
                           static_cast<size_t>(gk) * sak]
                       : 0.f;
    }
    for (int e = threadIdx.x; e < kBN * kBK; e += blockDim.x) {
      const int nn = sbn == 1 ? e % kBN : e / kBK;
      const int kk = sbn == 1 ? e / kBN : e % kBK;
      const int gn = n0 + nn, gk = k0 + kk;
      bs[kk][nn] = (gn < n_size && gk < kend)
                       ? bmat[static_cast<size_t>(gk) * sbk +
                              static_cast<size_t>(gn) * sbn]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* cz = c + static_cast<size_t>(blockIdx.z) * m_size * n_size;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m_size) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n_size) cz[static_cast<size_t>(gm) * n_size + gn] = acc[i][j];
    }
  }
}

// out[i] = sum over z of partial[z][i], z in order: a deterministic dW.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n, int parts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = partial[i];
  for (int z = 1; z < parts; ++z) acc += partial[static_cast<size_t>(z) * n + i];
  out[i] = acc;
}

template <typename Kernel>
cudaError_t set_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DH>
cudaError_t launch_fwd(const int* seed, const float* seq, const float* w,
                       float* out, int batch, int seq_len, int channels,
                       int heads, uint32_t threshold, float keep_scale,
                       cudaStream_t stream) {
  const size_t bytes = fwd_shared_floats(seq_len, channels, DH) * sizeof(float);
  const float q_scale = 1.f / sqrtf(static_cast<float>(DH));
  cudaError_t err;
  if (threshold > 0) {
    err = set_shared(attention_proj_fwd_kernel<DH, true>, bytes);
    if (err != cudaSuccess) return err;
    attention_proj_fwd_kernel<DH, true><<<batch * heads, kThreads, bytes, stream>>>(
        seed, seq, w, out, seq_len, channels, heads, q_scale, threshold,
        keep_scale);
  } else {
    err = set_shared(attention_proj_fwd_kernel<DH, false>, bytes);
    if (err != cudaSuccess) return err;
    attention_proj_fwd_kernel<DH, false><<<batch * heads, kThreads, bytes, stream>>>(
        seed, seq, w, out, seq_len, channels, heads, q_scale, threshold,
        keep_scale);
  }
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const int* seed, const float* seq, const float* w,
                       const float* g, float* dqkv, int batch, int seq_len,
                       int channels, int heads, uint32_t threshold,
                       float keep_scale, cudaStream_t stream) {
  const bool g_shared = bwd_shared_floats(seq_len, channels, DH, true) *
                            sizeof(float) <= kMaxSharedBytes;
  const size_t bytes =
      bwd_shared_floats(seq_len, channels, DH, g_shared) * sizeof(float);
  if (bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  const float q_scale = 1.f / sqrtf(static_cast<float>(DH));
  cudaError_t err;
  if (threshold > 0) {
    err = set_shared(attention_proj_bwd_kernel<DH, true>, bytes);
    if (err != cudaSuccess) return err;
    attention_proj_bwd_kernel<DH, true><<<batch * heads, kThreads, bytes, stream>>>(
        seed, seq, w, g, dqkv, seq_len, channels, heads, q_scale, threshold,
        keep_scale, g_shared ? 1 : 0);
  } else {
    err = set_shared(attention_proj_bwd_kernel<DH, false>, bytes);
    if (err != cudaSuccess) return err;
    attention_proj_bwd_kernel<DH, false><<<batch * heads, kThreads, bytes, stream>>>(
        seed, seq, w, g, dqkv, seq_len, channels, heads, q_scale, threshold,
        keep_scale, g_shared ? 1 : 0);
  }
  return cudaGetLastError();
}

bool valid_shape(int batch, int seq_len, int channels, int heads) {
  return batch > 0 && seq_len > 0 && heads > 0 && channels % heads == 0;
}

}  // namespace

extern "C" int gpnf_attention_proj_fwd(const int* seed, const float* seq,
                                       const float* w, float* out, int batch,
                                       int seq_len, int channels, int heads,
                                       uint32_t threshold, float keep_scale,
                                       void* stream) {
  if (!valid_shape(batch, seq_len, channels, heads) ||
      (threshold > 0 && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh = channels / heads;
  if (fwd_shared_floats(seq_len, channels, dh) * sizeof(float) > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPNF_FWD(D)                                                        \
  launch_fwd<D>(seed, seq, w, out, batch, seq_len, channels, heads,        \
                threshold, keep_scale, s)
  cudaError_t err;
  switch (dh) {
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

// dseq (B, S, C) and dW (3C, C) from (seed, seq, w, g). Scratch from the
// caller: dqkv (B, S, 3C) and dw_partial (ceil(B*S / k_chunk), 3C, C).
extern "C" int gpnf_attention_proj_bwd(const int* seed, const float* seq,
                                       const float* w, const float* g,
                                       float* dqkv, float* dw_partial,
                                       float* dseq, float* dw, int batch,
                                       int seq_len, int channels, int heads,
                                       uint32_t threshold, float keep_scale,
                                       int k_chunk, void* stream) {
  if (!valid_shape(batch, seq_len, channels, heads) || k_chunk <= 0 ||
      k_chunk % kBK != 0 || (threshold > 0 && seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh = channels / heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPNF_BWD(D)                                                        \
  launch_bwd<D>(seed, seq, w, g, dqkv, batch, seq_len, channels, heads,    \
                threshold, keep_scale, s)
  cudaError_t err;
  switch (dh) {
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
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows = batch * seq_len;  // the flattened (b, s) axis
  const int c3 = 3 * channels;
  // dseq = dqkv (rows, 3C) @ w (3C, C)
  dim3 grid_seq((channels + kBN - 1) / kBN, (rows + kBM - 1) / kBM, 1);
  gemm_strided_kernel<<<grid_seq, 256, 0, s>>>(dqkv, w, dseq, rows, channels,
                                              c3, c3, 1, channels, 1, c3);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dW partials: dqkv^T (3C, rows) @ seq (rows, C), k split into chunks
  const int parts = (rows + k_chunk - 1) / k_chunk;
  dim3 grid_w((channels + kBN - 1) / kBN, (c3 + kBM - 1) / kBM, parts);
  gemm_strided_kernel<<<grid_w, 256, 0, s>>>(dqkv, seq, dw_partial, c3,
                                            channels, rows, 1, c3, channels, 1,
                                            k_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = c3 * channels;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, s>>>(dw_partial, dw, n, parts);
  return static_cast<int>(cudaGetLastError());
}
