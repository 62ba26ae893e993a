// Multi-head softmax attention on separate q, k, v or on a packed qkv, at
// every S the long entry takes (the JAX kernels' S <= 512 and, where the
// JAX package computes its jnp reference, above), forward with in-kernel
// dropout and backward, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py,
//   - `_fwd_kernel` and `_bwd_kernel` (launched by `_run_fwd` and
//     `_run_bwd`), from `fused_attention`: q, k, v (B, H, S, Dh), q already
//     scaled; the backward gives dq, dk, dv (B, H, S, Dh);
//   - `_fwd_kernel_qkv` and `_bwd_kernel_qkv` (launched by `_run_qkv`), from
//     `fused_attention_qkv`: qkv (B, S, 3C) packed [k | v | q], heads split
//     in the kernel, q scaled by q_scale (the wrapper's Dh^-1/2) as it is
//     loaded; out (B, S, C); the backward gives dqkv (B, S, 3C) packed
//     [dK | dV | dq * q_scale].
// Head widths: 4, 8, 16, 24, 32, 48, 64, 128, 256 (the wrappers pad any
// other up to 256 to the next of them). The forward and the
// backward run on the tensor cores at every width (attention_tiled.cuh).
// These are the float32 kernels; fused_attention_bf16.cu holds the same
// four entries on bf16 operands.
// For every batch row b and head h:
//   P = softmax(q k^T);  Pd = keep * P / (1 - rate);  out = Pd v
// and the backward of the JAX module's docstring:
//   dV = Pd^T g;  dPd = g V^T;  dP = keep * dPd / (1 - rate)
//   dS = P * (dP - rowsum(dP * P));  dQ = dS K;  dK = dS^T Q
// The keep bit of score (b, h, i, j) is word (j & 3) of Philox at counter
// (j >> 2, i, h, b), key (seed, 0) (philox.cuh), as in the long kernels:
// at one seed every attention entry drops the same scores.
// The Pallas kernels draw theirs from the TPU's generator, which no other
// device reproduces.
//
// What bounds it on the H100: operations. At the flagship's level 0 (B=64,
// S=256, 4 heads of Dh=24) the forward does two S x S x Dh products of 0.81
// GFLOP each plus ~0.08 GOP of softmax, the backward five such products,
// all on the tensor cores in 3xTF32 (495 / 3 TFLOP/s): >= ~10 and ~25 us
// (~25 and ~61 at the fp32 rate off them, 67 TFLOP/s). The bytes (q, k, v,
// g, out, dq, dk, dv: 25-50 MB) need 8-15 us.
//
// Design: the key-tiled kernels of attention_tiled.cuh, shared with
// fused_attention_long.cu, instantiated for both layouts (SplitHeads with
// q_scale 1, PackedQkv with q_scale Dh^-1/2): the forward a block per
// (queries, head, batch row) with an online softmax; the backward a dq
// kernel that writes (m, 1/l, D) to a (B, H, S, 3) scratch, then a dK/dV
// kernel, no atomics, so it repeats bit for bit. A head's K and V whole in
// shared memory would not cover the range: at S = 512, Dh = 64 they take
// 256 KB, over a block's 227 KB.
#include "attention_tiled.cuh"

namespace {
// the long entry's range (the wrappers' MAX_S_LONG): the same key-tiled
// kernels, whose largest S holds its indices in an int
constexpr int kMaxSeqLen = 2147483647 / 3;
}  // namespace

// out (B, H, S, Dh) from q, k, v (B, H, S, Dh), q already scaled; seed is a
// device (1,) int32, read only when threshold > 0.
extern "C" int gpnf_attention_fwd(const int* seed, const float* q,
                                  const float* k, const float* v, float* out,
                                  int batch, int heads, int seq_len,
                                  int head_dim, uint32_t threshold,
                                  float keep_scale, void* stream) {
  if (!gpnf::attention_args_ok(batch, seq_len, heads, head_dim, kMaxSeqLen,
                               seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(gpnf::with_head_dim<gpnf::SplitHeads>(
      head_dim, seq_len, heads, [&](auto lay) {
        return gpnf::attention_tiled_fwd(lay, batch, seed, q, k, v, out, 1.f,
                                         threshold, keep_scale,
                                         static_cast<cudaStream_t>(stream));
      }));
}

// dq, dk, dv (B, H, S, Dh) from (seed, q, k, v, g); stats is the caller's
// (B, H, S, 3) scratch.
extern "C" int gpnf_attention_bwd(const int* seed, const float* q,
                                  const float* k, const float* v,
                                  const float* g, float* dq, float* dk,
                                  float* dv, float* stats, int batch,
                                  int heads, int seq_len, int head_dim,
                                  uint32_t threshold, float keep_scale,
                                  void* stream) {
  if (!gpnf::attention_args_ok(batch, seq_len, heads, head_dim, kMaxSeqLen,
                               seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(gpnf::with_head_dim<gpnf::SplitHeads>(
      head_dim, seq_len, heads, [&](auto lay) {
        return gpnf::attention_tiled_bwd(lay, batch, seed, q, k, v, g, dq, dk,
                                         dv, stats, 1.f, threshold,
                                         keep_scale,
                                         static_cast<cudaStream_t>(stream));
      }));
}

// out (B, S, C) from qkv (B, S, 3C) packed [k | v | q], q scaled by
// q_scale.
extern "C" int gpnf_attention_qkv_fwd(const int* seed, const float* qkv,
                                      float* out, int batch, int seq_len,
                                      int channels, int heads, float q_scale,
                                      uint32_t threshold, float keep_scale,
                                      void* stream) {
  return gpnf::attention_packed_fwd(seed, qkv, out, batch, seq_len, channels,
                                    heads, kMaxSeqLen, q_scale, threshold,
                                    keep_scale, stream);
}

// dqkv (B, S, 3C) packed [dK | dV | dq * q_scale] from (seed, qkv, g);
// stats is the caller's (B, H, S, 3) scratch.
extern "C" int gpnf_attention_qkv_bwd(const int* seed, const float* qkv,
                                      const float* g, float* dqkv,
                                      float* stats, int batch, int seq_len,
                                      int channels, int heads, float q_scale,
                                      uint32_t threshold, float keep_scale,
                                      void* stream) {
  return gpnf::attention_packed_bwd(seed, qkv, g, dqkv, stats, batch, seq_len,
                                    channels, heads, kMaxSeqLen, q_scale,
                                    threshold, keep_scale, stream);
}
