// Multi-head self-attention for long sequences (512 < S), for GatedAttn's
// wide route at any S (ops/kernels/fused_attention.py,
// `attention_route`; there, at S <= 512, the projection and dseq / dW
// around these kernels are attention_gemm.cu's), and for the proj route
// (`fused_attention_proj` and its backward: these kernels after and between
// attention_gemm.cu's products): forward with in-kernel dropout and
// backward, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py, `_fwd_kernel_bh` and
// `_bwd_kernel_bh` (both launched by `_run_bh`), from
// `fused_attention_long`. As there, the projection qkv = seq @ w^T and the
// backward's dseq = dqkv @ w and dW = dqkv^T seq are plain matrix products
// outside these kernels (torch.matmul in ops/kernels/fused_attention.py).
//
// For every batch row b and head h, with qkv (B, S, 3C) packed [k | v | q]:
//   k = qkv[b, :, h*Dh : (h+1)*Dh],  v = qkv[b, :, C + h*Dh : ...]
//   q = qkv[b, :, 2C + h*Dh : ...] * q_scale
// q_scale is Dh^-1/2 (1.f / sqrtf(Dh)), or the true width's where the
// wrapper zero-padded the heads to a width the kernels are built for (Dh in
// 4, 8, 16, 24, 32, 48, 64, and 128, 256 by the Dh = 128 / 256 kernels).
//   P = softmax(q k^T);  Pd = keep * P / (1 - rate)
//   out[b, :, h*Dh : (h+1)*Dh] = Pd v
// The keep bit of score (b, h, i, j) comes from philox.cuh, a pure function
// of (seed, b, h, i, j), so at one seed every entry drops the same scores.
//
// Backward, with g = d out:
//   dV = Pd^T g;  dPd = g V^T;  dP = keep * dPd / (1 - rate)
//   dS = P * (dP - D),  D_i = sum_j dP_ij P_ij
//   dq = dS K * q_scale;  dK = dS^T q;  dqkv = [dK | dV | dq]
//
// What bounds it on the H100: operations. At the 64-px row's level 0
// (B=64, S=1024, C=96, 4 heads of Dh=24) the forward does two S x S x Dh
// products of 12.9 GFLOP each plus ~1.3 GOP of softmax, the backward five
// such products (the scores again, dPd, dV, dq, dK), ~64 GFLOP, all on the
// tensor cores in 3xTF32 (495 / 3 TFLOP/s): >= ~0.16 and ~0.40 ms (~0.40
// and ~0.96 at the fp32 rate off them, 67 TFLOP/s). The bytes (qkv, g,
// out, dqkv: 100-180 MB) need 30-53 us. At
// the CLIs' default width (C=512, Dh=128) and the 32-px level 0 (B=16,
// S=256) the forward's two products are 2.1 GFLOP and the backward's five
// 5.4 GFLOP, both on the tensor cores: >= ~13 and ~33 us.
//
// Design: attention_tiled.cuh, whose key-tiled kernels this file
// instantiates for the packed layout (PackedQkv), as fused_attention.cu
// does for `fused_attention_qkv` and `fused_attention`: a block
// per (queries, head, batch row) with an online softmax forward; a dq
// kernel that writes (m, 1/l, D) to a (B, H, S, 3) scratch and a dK/dV
// kernel, no atomics. Both read packed qkv and write packed dqkv
// (B, S, 3C) directly, so no head split or merge copies. The forward and
// the backward run at every width as the header's tensor-core kernels
// (3xTF32 mma.sync, mma_tf32.cuh), the tiles in dynamic shared memory. In
// bf16 the forward is attention_wgmma.cuh's TMA + wgmma kernel and the
// backward the header's bf16 mma.sync pair.
#include "attention_tiled.cuh"
#include "attention_wgmma.cuh"

namespace {
// the wrappers' MAX_S_LONG: the largest S whose indices the kernels hold in
// an int (3 S, the float32 dK/dV kernel's statistics); the grids, the keep
// bits' scratch and every other index take more
constexpr int kMaxSeqLen = 2147483647 / 3;
}  // namespace

// out (B, S, C) from qkv (B, S, 3C), q scaled by q_scale; seed is a device
// (1,) int32, read only when threshold > 0.
extern "C" int gpnf_attention_long_fwd(const int* seed, const float* qkv,
                                       float* out, int batch, int seq_len,
                                       int channels, int heads, float q_scale,
                                       uint32_t threshold, float keep_scale,
                                       void* stream) {
  return gpnf::attention_packed_fwd(seed, qkv, out, batch, seq_len, channels,
                                    heads, kMaxSeqLen, q_scale, threshold,
                                    keep_scale, stream);
}

// The same in bf16 (qkv and out bf16), q * q_scale rounded to bf16:
// attention_wgmma.cuh's `attention_wgmma_fwd_kernel` (TMA and wgmma), at
// the head widths built in bf16, 24, 128 and 256 (the wrappers'
// BF16_HEAD_DIMS, which pad every other width to one of them);
// cudaErrorInvalidValue at any other.
// With stats (a float32 (B, H, S, 2), or null) the kernel also stores each
// query row's (m, 1/l), the residuals of the bf16 backward; out's bits are
// the same either way.
extern "C" int gpnf_attention_long_fwd_bf16(const int* seed, const void* qkv,
                                            void* out, float* stats,
                                            int batch, int seq_len,
                                            int channels, int heads,
                                            float q_scale, uint32_t threshold,
                                            float keep_scale, void* stream) {
  return gpnf::attention_packed_fwd_bf16(seed, qkv, out, stats, batch,
                                         seq_len, channels, heads, kMaxSeqLen,
                                         q_scale, threshold, keep_scale,
                                         stream);
}

// The backward in bf16: dqkv (B, S, 3C, bf16) packed [dK | dV | dq] from
// (seed, qkv, g), all bf16, q scaled by the bf16 constant q_scale as the
// forward scales it, and the forward's stats (float32 (B, H, S, 2), its
// (m, 1/l)); dsum is the caller's float32 (B, H, S) scratch of D and keep,
// read only when threshold > 0, its int32 scratch of the keep bits, B H Sp^2
// / 32 words (Sp = S rounded up to 64). dq leaves
// as dS K times dq_scale rounded once, or, with dq_round_first, rounded
// first and then times dq_scale (the bf16 constant) and rounded again:
// attention_tiled.cuh's `attention_bf16_dq_kernel` and
// `attention_bf16_dkv_kernel`, at the widths built in bf16 (24, 128, 256);
// cudaErrorInvalidValue at any other.
extern "C" int gpnf_attention_long_bwd_bf16(
    const int* seed, const void* qkv, const void* g, const float* stats,
    float* dsum, void* keep, void* dqkv, int batch, int seq_len, int channels,
    int heads,
    float q_scale, float dq_scale, int dq_round_first, uint32_t threshold,
    float keep_scale, void* stream) {
  return gpnf::attention_packed_bwd_bf16(
      seed, qkv, g, stats, dsum, keep, dqkv, batch, seq_len, channels, heads,
      kMaxSeqLen, q_scale, dq_scale, dq_round_first, threshold, keep_scale,
      stream);
}

// dqkv (B, S, 3C) from (seed, qkv, g); stats is the caller's (B, H, S, 3)
// scratch.
extern "C" int gpnf_attention_long_bwd(const int* seed, const float* qkv,
                                       const float* g, float* dqkv,
                                       float* stats, int batch, int seq_len,
                                       int channels, int heads, float q_scale,
                                       uint32_t threshold, float keep_scale,
                                       void* stream) {
  return gpnf::attention_packed_bwd(seed, qkv, g, dqkv, stats, batch, seq_len,
                                    channels, heads, kMaxSeqLen, q_scale,
                                    threshold, keep_scale, stream);
}
