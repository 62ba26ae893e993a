// bf16 tensor-core products and the shared-memory fragment loads of the
// bf16 kernels: the GEMM of the projection and of dseq and dW
// (attention_gemm.cu) and the attention forward, dq and dK/dV kernels
// (attention_tiled.cuh), which serve and train the flagship under
// MarScfConfig(compute_dtype="bfloat16").
//
// The product is mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16
// operands, an fp32 accumulator. Fragments (PTX ISA, "Matrix fragments for
// mma.m16n8k16", .bf16), lane = 4 gr + tg, each 32-bit register two bf16
// values, the lower index in the low half:
//   A (16 x 16, row-major): r0 (gr, 2 tg .. 2 tg + 1), r1 (gr + 8, 2 tg ..),
//                           r2 (gr, 2 tg + 8 ..),     r3 (gr + 8, 2 tg + 8 ..)
//   B (16 x 8, k x n):      r0 (k 2 tg .. 2 tg + 1, n gr), r1 (k 2 tg + 8 .., gr)
//   C (16 x 8, fp32):       c0 (gr, 2 tg), c1 (gr, 2 tg + 1), c2 (gr + 8, 2 tg),
//                           c3 (gr + 8, 2 tg + 1)
// So the C fragments of two neighbouring n8 tiles are, rounded and paired,
// the A fragment of a k16 step over their 16 columns, as they stand
// (`pack_bf16`): the attention forward's P goes from its score accumulators
// straight into P V.
//
// Tiles live in shared memory as rows of W bf16 values padded to LD = W + 8
// (16 bytes more), W a multiple of 16. `ldmatrix` reads four 8 x 8 blocks
// in four phases of 8 row addresses, 16 bytes each; a row starts at 2 LD r
// bytes, and 2 LD / 16 = W / 8 + 1 is odd for every W that is a multiple of
// 16 (W = 32, 64, 128, 256: LD 40, 72, 136, 264), so the 8 rows of a phase
// fall in 8 distinct 16-byte groups of the 32 banks: no fragment load
// conflicts (tests/test_torch_bf16_mma.py counts the banks of every load).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gpnf {

using bf16 = __nv_bfloat16;

constexpr int kBf16Pad = 8;  // bf16 values after each W-value row of a tile

// (lo, hi) rounded to nearest even bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 blocks; lane l gives the address of row l & 7 of block
// l >> 3, and gets in r[j] row gr, columns 2 tg, 2 tg + 1 of block j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The same blocks transposed: r[j] holds rows 2 tg, 2 tg + 1 of column gr
// of block j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 15 of a tile of
// LD-value rows (blocks: rows 0-7 / 8-15 of columns c0, then c0 + 8).
template <int LD>
__device__ __forceinline__ void frag_a_bf16(uint32_t (&a)[4], const bf16* tile,
                                            int r0, int c0, int lane) {
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * LD + c0 + ((lane >> 4) << 3));
}

// The A fragment of rows m0 .. m0 + 15, columns k0 .. k0 + 15 of A read
// from a tile that holds A transposed, rows along k and columns along m, by
// ldmatrix.trans (blocks: k0 .. k0 + 7 of columns m0, then m0 + 8, then
// k0 + 8 .. k0 + 15 of each).
template <int LD>
__device__ __forceinline__ void frag_a_bf16_trans(uint32_t (&a)[4],
                                                  const bf16* tile, int k0,
                                                  int m0, int lane) {
  ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                           m0 + (((lane >> 3) & 1) << 3));
}

// The B fragments of two n8 tiles read from rows n0 .. n0 + 15 (n) and
// columns c0 .. c0 + 15 (k) of a tile whose rows run along k: b[0], b[1]
// the fragment of rows n0 .. n0 + 7, b[2], b[3] that of n0 + 8 .. n0 + 15.
template <int LD>
__device__ __forceinline__ void frag_b_bf16_pair(uint32_t (&b)[4],
                                                 const bf16* tile, int n0,
                                                 int c0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 +
                     (((lane >> 3) & 1) << 3));
}

// The B fragments of two n8 tiles read from a tile whose rows run along k:
// rows k0 .. k0 + 15 (k), columns c0 .. c0 + 15 (n), by ldmatrix.trans:
// b[0], b[1] columns c0 .. c0 + 7, b[2], b[3] columns c0 + 8 .. c0 + 15.
template <int LD>
__device__ __forceinline__ void frag_b_bf16_trans_pair(uint32_t (&b)[4],
                                                       const bf16* tile,
                                                       int k0, int c0,
                                                       int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                               LD + c0 + ((lane >> 4) << 3));
}

// 16 bytes (8 bf16 values) from global src to shared dst, or 16 zero bytes
// where !valid (src is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16_bf16(bf16* dst, const bf16* src,
                                                bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// Rows [r0, r0 + ROWS) of the (S, W) bf16 slice at `src` (row stride
// `stride` values, 16-byte aligned) into dst, rows of LD values (columns W
// .. LD - 1 not written), by all `threads` threads of the block; rows past
// S are zero. Asynchronous: the caller commits and waits.
template <int W, int ROWS, int LD>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src,
                                               int r0, int seq_len,
                                               size_t stride, int threads) {
  static_assert(W % 8 == 0, "whole 16-byte chunks of a row");
  constexpr int kChunks = W / 8;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += threads) {
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    const bool valid = r0 + r < seq_len;
    const bf16* from =
        src + static_cast<size_t>(valid ? r0 + r : 0) * stride + 8 * c;
    cp_async16_bf16(dst + r * LD + 8 * c, from, valid);
  }
}

}  // namespace gpnf
