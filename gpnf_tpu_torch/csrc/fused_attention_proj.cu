// Multi-head self-attention with the qkv projection inside the kernel
// (forward, dropout rate 0), hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py, `_fwd_kernel_proj`
// (launched by `_run_proj_fwd` from `fused_attention_proj`).
//
// For every batch row b and head h, with w (3C, C) packed [k | v | q]:
//   k = seq[b] @ w[h*Dh : (h+1)*Dh]^T            (S, Dh)
//   v = seq[b] @ w[C + h*Dh : C + (h+1)*Dh]^T
//   q = seq[b] @ w[2C + h*Dh : 2C + (h+1)*Dh]^T * Dh^-1/2
//   out[b, :, h*Dh : (h+1)*Dh] = softmax(q k^T) v
// All arithmetic is fp32; nothing of shape (S, S) or (S, 3C) reaches
// device memory.
//
// What bounds it on the H100: operations. At the flagship's level 0
// (B=64, S=256, C=96, 4 heads) one call is ~2.5 GFLOP (projection 0.9,
// q k^T 0.8, p v 0.8) against ~12.6 MB of traffic, so at the fp32 rate
// outside the tensor cores (67 TFLOP/s) it needs >= ~38 us, while the
// bytes alone need ~4 us.
//
// Design (simple and exact first; tensor cores are later work):
//   - one block per (batch, head): K and V of that head are computed once
//     and kept in shared memory for every query of the row;
//   - the head's 3*Dh weight rows sit in shared memory with a padded
//     stride (C+1) so that the 32 lanes of a warp, which read 32 different
//     rows at the same column, hit 32 different banks;
//   - seq rows are staged kRows at a time (also padded) and every thread
//     computes whole dot products over C in fp32 FMAs;
//   - each thread then owns one query row at a time: q and the output
//     accumulator live in registers (Dh is a template parameter, 24 on the
//     flagship), keys and values are read from shared memory as warp-wide
//     broadcasts, and the softmax is the online (running max, running sum)
//     form, so the scores are never stored.
// Shared memory: 4 * (3*Dh*(C+1) + kRows*(C+1) + 3*S*Dh) bytes, 114 KB at
// S=256, C=96, Dh=24 (above 48 KB, hence cudaFuncSetAttribute).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90

__host__ __device__ inline size_t shared_floats(int seq_len, int channels,
                                                int dh) {
  const size_t cp = static_cast<size_t>(channels) + 1;
  return 3 * dh * cp + kRows * cp + 3 * static_cast<size_t>(seq_len) * dh;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
    attention_proj_fwd_kernel(const float* __restrict__ seq,
                              const float* __restrict__ w,
                              float* __restrict__ out, int seq_len,
                              int channels, int heads, float q_scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int cp = channels + 1;
  float* w_s = smem;                 // (3*DH, cp): rows k, v, q of head h
  float* x_s = w_s + 3 * DH * cp;    // (kRows, cp): staged seq rows
  float* k_s = x_s + kRows * cp;     // (S, DH)
  float* v_s = k_s + seq_len * DH;   // (S, DH)
  float* q_s = v_s + seq_len * DH;   // (S, DH), already scaled

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

  for (int qi = threadIdx.x; qi < seq_len; qi += blockDim.x) {
    float q[DH];
    float acc[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      q[d] = q_s[qi * DH + d];
      acc[d] = 0.f;
    }
    float m = -INFINITY;
    float l = 0.f;
    for (int j = 0; j < seq_len; ++j) {
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
      const float* vj = v_s + j * DH;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vj[d], acc[d]);
    }
    const float inv_l = 1.f / l;
    float* o = out + (static_cast<size_t>(b) * seq_len + qi) * channels + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = acc[d] * inv_l;
  }
}

template <int DH>
cudaError_t launch(const float* seq, const float* w, float* out, int batch,
                   int seq_len, int channels, int heads, cudaStream_t stream) {
  const size_t bytes = shared_floats(seq_len, channels, DH) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_proj_fwd_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const float q_scale = 1.f / sqrtf(static_cast<float>(DH));
  attention_proj_fwd_kernel<DH><<<batch * heads, kThreads, bytes, stream>>>(
      seq, w, out, seq_len, channels, heads, q_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gpnf_attention_proj_fwd(const float* seq, const float* w,
                                       float* out, int batch, int seq_len,
                                       int channels, int heads, void* stream) {
  if (batch <= 0 || seq_len <= 0 || heads <= 0 || channels % heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh = channels / heads;
  if (shared_floats(seq_len, channels, dh) * sizeof(float) > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 4: err = launch<4>(seq, w, out, batch, seq_len, channels, heads, s); break;
    case 8: err = launch<8>(seq, w, out, batch, seq_len, channels, heads, s); break;
    case 16: err = launch<16>(seq, w, out, batch, seq_len, channels, heads, s); break;
    case 24: err = launch<24>(seq, w, out, batch, seq_len, channels, heads, s); break;
    case 32: err = launch<32>(seq, w, out, batch, seq_len, channels, heads, s); break;
    case 48: err = launch<48>(seq, w, out, batch, seq_len, channels, heads, s); break;
    case 64: err = launch<64>(seq, w, out, batch, seq_len, channels, heads, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
