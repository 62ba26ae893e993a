// Philox4x32-10 counter-based generator (Salmon et al., "Parallel random
// numbers: as easy as 1, 2, 3", SC'11), the dropout bits of the port's
// attention and gated-conv kernels.
//
// Replaces: the TPU's in-kernel PRNG (`pltpu.prng_seed` /
// `pltpu.prng_random_bits`) of gpnf_tpu/ops/pallas/fused_attention.py and
// gpnf_tpu/ops/pallas/fused_gated_conv.py.
//
// A stateless function of (counter, key): the keep bit of attention score
// (b, h, i, j) is word (j & 3) of
//     philox4x32_10({j >> 2, i, h, b}, {seed, 0}),
// and the Dropout2d keep bit of channel j (of 2C) of batch row b in the
// gated conv is word (j & 3) of
//     philox4x32_10({j >> 2, b, 0, 0}, {seed, 1}),
// the key's second word keeping the two streams apart. Every thread, block
// and pass that touches a score or a channel regenerates the same bit in
// any order. The forward and the backward kernels rely on it;
// `dropout_keep_plain` in ops/kernels/fused_attention.py and
// `gated_conv_keep_plain` in ops/kernels/fused_gated_conv.py compute the
// same words in torch integer arithmetic.
#pragma once
#include <stdint.h>

namespace gpnf {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;  // golden ratio
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;  // sqrt(3) - 1

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c0;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0);
    const uint32_t lo1 = kPhiloxM1 * c2;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t philox_word(uint4 r, int sel) {
  return sel == 0 ? r.x : sel == 1 ? r.y : sel == 2 ? r.z : r.w;
}

// The four keep bits' words of scores (b, h, i, 4q .. 4q+3).
__device__ __forceinline__ uint4 attention_dropout_bits(uint32_t seed, int b,
                                                        int h, int i, int q) {
  return philox4x32_10(static_cast<uint32_t>(q), static_cast<uint32_t>(i),
                       static_cast<uint32_t>(h), static_cast<uint32_t>(b),
                       seed, 0u);
}

// The four Dropout2d keep bits' words of channels 4q .. 4q+3 of batch row b
// in the gated conv.
__device__ __forceinline__ uint4 gated_conv_dropout_bits(uint32_t seed, int b,
                                                         int q) {
  return philox4x32_10(static_cast<uint32_t>(q), static_cast<uint32_t>(b), 0u,
                       0u, seed, 1u);
}

}  // namespace gpnf
