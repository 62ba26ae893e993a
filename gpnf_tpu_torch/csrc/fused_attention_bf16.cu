// Multi-head softmax attention on bf16 operands at every S the long entry
// takes, separate q, k, v or a packed qkv, forward with in-kernel dropout
// and backward, hand-written for Hopper (sm_90a): the bf16 instantiations
// of the core entries, whose float32 ones are fused_attention.cu's (a
// source of their own so that the two build in parallel: in one file they
// took one nvcc of 173 s, 66 s past the next longest source).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py on bf16 operands,
//   - `_fwd_kernel` :43 (`_run_fwd`), from `fused_attention`: q (already
//     scaled), k, v (B, H, S, Dh); scores, softmax and dropout in float32,
//     P rounded to bf16 for P V, summed in float32, out rounded once;
//   - `_bwd_kernel` :62 (`_run_bwd`): q, k, v and g widened to float32,
//     every product in float32 from unrounded P, Pd, dP and dS, only dq, dk
//     and dv rounded to bf16;
//   - `_fwd_kernel_qkv` :230 and `_bwd_kernel_qkv` :257 (`_run_qkv`), from
//     `fused_attention_qkv`: packed qkv (B, S, 3C) [k | v | q], q *
//     Dh^-1/2 rounded to bf16 (the scale a bf16 constant), P and dS rounded
//     for their products, dq scaled in float32 and rounded once.
// The keep bit of score (b, h, i, j) is philox.cuh's, as in every attention
// kernel of the port: at one seed every entry drops the same scores.
//
// Design. Each entry runs kernels that exist for other entries:
//   - the split forward is attention_wgmma.cuh's TMA + wgmma forward on
//     `SplitHeadsTma`: three tensor maps (dh, S, H, B), one each for q, k and
//     v, in tiles 32, 128 or 256 wide whatever dh (a multiple of 8 up to
//     them; the maps zero-fill the columns past dh, so no copy), q taken as
//     it comes (scaled by exactly 1), no statistics kept;
//   - the split backward is attention_tiled.cuh's 3xTF32 dq and dK/dV pair,
//     the float32 entry's, templated on its operand type: the bf16 tiles
//     stay bf16 in shared memory (cp.async of 16-byte chunks, so dh is a
//     multiple of 8: the wrapper pads Dh 4 to 8) and are widened as each
//     fragment is read, so no float32 copy of q, k, v or g reaches device
//     memory; a widened value has lo = 0, so q K^T and g V^T take one TF32
//     pass and dS K, Pd^T g and dS^T q two, where float32 takes three;
//   - the packed pair is the long entry's bf16 forward and bf16 mma.sync dq
//     and dK/dV pair (attention_wgmma.cuh's `attention_packed_fwd_bf16` and
//     `attention_packed_bwd_bf16`), at the widths 24, 128 and 256 that the
//     wrapper pads every other width to, the forward keeping each row's
//     (m, 1/l) when a backward is to come.
// Sums run in a fixed order and each output is written once: two calls give
// the same bits.
//
// What bounds it on the H100: at the flagship's level 0 (B 64, S 256, 4
// heads of Dh 24) the forward's bytes (q, k, v, out: 12.6 MB, 3.8 us)
// against its two S x S x Dh products at the dense bf16 rate (1.6 us) and
// one ex2 a score (16.8 M, 4.3 us at ~3.9e12/s): the exponentials. The
// split backward's two bf16 products (1.6 us) and three of a float32
// intermediate by a bf16 value (at a third of that rate, a float32 value
// being three bf16 parts: 7.3 us), 9.0 us, against 22 MB of bytes (6.6
// us): operations. The packed backward's five products in bf16 (4.1 us) against
// its bytes (6.6 us).
#include "attention_tiled.cuh"
#include "attention_wgmma.cuh"

namespace {
// the long entry's range (the wrappers' MAX_S_LONG): the same key-tiled
// kernels, whose largest S holds its indices in an int
constexpr int kMaxSeqLen = 2147483647 / 3;

// out (B, H, S, dh, bf16) from q (already scaled), k and v (B, H, S, dh),
// all bf16, on split heads: tiles 32 wide up to dh 32, 128 up to 128, 256
// up to 256, dh a multiple of 8 (the wrapper pads Dh 4 to 8); q is scaled
// by exactly 1.
int split_fwd(const int* seed, const void* q, const void* k, const void* v,
              void* out, int batch, int heads, int seq_len, int head_dim,
              uint32_t threshold, float keep_scale, void* stream) {
  if (head_dim % 8 != 0 ||
      !gpnf::attention_args_ok(batch, seq_len, heads, head_dim, kMaxSeqLen,
                               seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using gpnf::bf16;
  auto run = [&](auto lay) {
    return static_cast<int>(gpnf::attention_wgmma_fwd(
        lay, batch, seed, static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), nullptr, 1.f, threshold, keep_scale,
        static_cast<cudaStream_t>(stream)));
  };
  if (head_dim <= 32) {
    return run(gpnf::SplitHeadsTma<32>{seq_len, heads, head_dim});
  }
  if (head_dim <= 128) {
    return run(gpnf::SplitHeadsTma<128>{seq_len, heads, head_dim});
  }
  if (head_dim <= 256) {
    return run(gpnf::SplitHeadsTma<256>{seq_len, heads, head_dim});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The forward in bf16: out (B, H, S, dh) from q (already scaled), k, v, all
// bf16, dh a multiple of 8 (the wrapper pads Dh 4 to 8).
extern "C" int gpnf_attention_fwd_bf16(const int* seed, const void* q,
                                       const void* k, const void* v,
                                       void* out, int batch, int heads,
                                       int seq_len, int head_dim,
                                       uint32_t threshold, float keep_scale,
                                       void* stream) {
  return split_fwd(seed, q, k, v, out, batch, heads, seq_len, head_dim,
                   threshold, keep_scale, stream);
}

// The backward in bf16: dq, dk, dv (B, H, S, dh, bf16) from bf16 (seed, q,
// k, v, g), dh a multiple of 8; stats is the caller's float32 (B, H, S, 3)
// scratch.
extern "C" int gpnf_attention_bwd_bf16(const int* seed, const void* q,
                                       const void* k, const void* v,
                                       const void* g, void* dq, void* dk,
                                       void* dv, float* stats, int batch,
                                       int heads, int seq_len, int head_dim,
                                       uint32_t threshold, float keep_scale,
                                       void* stream) {
  using gpnf::bf16;
  if (!gpnf::attention_args_ok(batch, seq_len, heads, head_dim, kMaxSeqLen,
                               seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(gpnf::with_head_dim<gpnf::SplitHeads, false>(
      head_dim, seq_len, heads, [&](auto lay) {
        return gpnf::attention_tiled_bwd(
            lay, batch, seed, static_cast<const bf16*>(q),
            static_cast<const bf16*>(k), static_cast<const bf16*>(v),
            static_cast<const bf16*>(g), static_cast<bf16*>(dq),
            static_cast<bf16*>(dk), static_cast<bf16*>(dv), stats, 1.f,
            threshold, keep_scale, static_cast<cudaStream_t>(stream));
      }));
}

// The packed forward in bf16: out (B, S, C) from bf16 qkv (B, S, 3C), q *
// q_scale rounded to bf16 (q_scale the bf16 constant Dh^-1/2), at the
// widths 24, 128 and 256; with stats (float32 (B, H, S, 2), or null) each
// query row's (m, 1/l) for the backward.
extern "C" int gpnf_attention_qkv_fwd_bf16(const int* seed, const void* qkv,
                                           void* out, float* stats, int batch,
                                           int seq_len, int channels,
                                           int heads, float q_scale,
                                           uint32_t threshold,
                                           float keep_scale, void* stream) {
  return gpnf::attention_packed_fwd_bf16(seed, qkv, out, stats, batch,
                                         seq_len, channels, heads, kMaxSeqLen,
                                         q_scale, threshold, keep_scale,
                                         stream);
}

// The packed backward in bf16: dqkv (B, S, 3C, bf16) from bf16 (seed, qkv,
// g) and the forward's stats, dq by the recipe dq_scale and dq_round_first
// name (the wrapper's: times Dh^-1/2 in float32, rounded once); dsum and
// keep are the caller's scratch (attention_wgmma.cuh's
// `attention_packed_bwd_bf16`).
extern "C" int gpnf_attention_qkv_bwd_bf16(
    const int* seed, const void* qkv, const void* g, const float* stats,
    float* dsum, void* keep, void* dqkv, int batch, int seq_len, int channels,
    int heads, float q_scale, float dq_scale, int dq_round_first,
    uint32_t threshold, float keep_scale, void* stream) {
  return gpnf::attention_packed_bwd_bf16(
      seed, qkv, g, stats, dsum, keep, dqkv, batch, seq_len, channels, heads,
      kMaxSeqLen, q_scale, dq_scale, dq_round_first, threshold, keep_scale,
      stream);
}
