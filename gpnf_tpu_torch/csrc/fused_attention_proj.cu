// Multi-head self-attention with the qkv projection inside the kernel,
// forward with in-kernel dropout, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py, `_fwd_kernel_proj`
// (launched by `_run_proj_fwd`) from `fused_attention_proj`. Its backward,
// `_bwd_kernel_proj`, is three stages in ops/kernels/fused_attention.py
// (`fused_attention_proj_bwd`): the projection recomputed by
// attention_gemm.cu, dqkv by the key-tiled kernels of
// fused_attention_long.cu (the same mask and the same q scale as here),
// then dseq and dW by attention_gemm.cu with a split K.
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
// All arithmetic is fp32; nothing of shape (S, S) reaches device memory.
//
// What bounds it on the H100: operations. At the flagship's level 0
// (B=64, S=256, C=96, 4 heads) the forward is ~2.5 GFLOP (projection 0.9,
// q k^T 0.8, p v 0.8) against ~12.6 MB of traffic: >= ~38 us at the fp32
// rate outside the tensor cores (67 TFLOP/s). The bytes alone need ~4 us.
//
// Design (simple and exact first; tensor cores and TMA are later work):
//   - one block per (batch, head): K, V and the scaled Q of that head are
//     computed once from seq and the head's 3*Dh weight rows and kept in
//     shared memory (weights and staged seq rows with a padded stride C+1,
//     so that a warp reading 32 rows at one column hits 32 banks);
//   - a thread per query, q and the output accumulator in registers (Dh is
//     a template parameter, 24 on the flagship), keys and values read from
//     shared memory as warp-wide broadcasts, the online softmax (the
//     denominator sums every exp(s - m); the accumulator adds only the kept
//     ones, scaled), one Philox call per four keys.
// Shared memory: 4 * (3*Dh*(C+1) + kRows*(C+1) + 3*S*Dh) bytes, 114 KB at
// S=256, C=96, Dh=24 (`attention_route` mirrors the formula).
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
