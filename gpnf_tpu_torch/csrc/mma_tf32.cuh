// 3xTF32 tensor-core products at about fp32 accuracy, and cp.async copies
// into padded shared-memory tiles: the building blocks of the attention
// tensor-core kernels (attention_tiled.cuh: the forward and the backward at
// every built width, 4 to 256) and of the projection GEMMs
// (attention_gemm.cu).
//
// The arithmetic is that of the yardstick, PyTorch's float32 memory-efficient
// attention on sm_80 and later (CUTLASS's OpMultiplyAddFastF32): each fp32
// operand x is split as hi = tf32(x), lo = tf32(x - hi) (tf32: round to
// nearest, ties away from zero, the low 13 mantissa bits cleared, as
// cvt.rna.tf32.f32 rounds; hi + lo is x within 2^-22 |x|), and each step of a
// product is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 run three times
// into one fp32 accumulator: lo*hi, hi*lo, then hi*hi. The dropped lo*lo term
// is below 2^-22 |a||b|, so a sum over K terms is within ~(K + 16) 2^-24 sum
// |a||b| of exact, as an fp32 sum is. tests/test_torch_attention_mma.py
// emulates this arithmetic on the CPU.
//
// Fragments of m16n8k8 (PTX ISA, "Matrix fragments for mma.m16n8k8", .tf32),
// with lane = 4 gr + tg:
//   A (16 x 8, row-major): a0 (gr, tg), a1 (gr + 8, tg), a2 (gr, tg + 4),
//                          a3 (gr + 8, tg + 4)
//   B (8 x 8, k x n):      b0 (tg, gr), b1 (tg + 4, gr)
//   C (16 x 8):            c0 (gr, 2 tg), c1 (gr, 2 tg + 1), c2 (gr + 8, 2 tg),
//                          c3 (gr + 8, 2 tg + 1)
// The k order inside a step is free as long as A and B agree: taking k = tg
// for column 2 tg and k = tg + 4 for column 2 tg + 1 makes an accumulator
// (c0, c2, c1, c3) an A fragment as it stands, with no trip through shared
// memory (`frag_a_from_c`).
//
// Tiles: rows of W floats (W a multiple of 8: 8, 16, 24, ..., 256) padded
// to W + 4, so float c of row r sits at r (W + 4) + c, and W + 4 is 4 times
// an odd number mod 32. A fragment read as A or B^T (rows r0 + gr, columns
// c0 + tg) touches banks (W + 4) gr + tg + const: the 8 rows fall 4 (odd)
// gr mod 32 apart, 8 distinct multiples of 4, each with its 4 columns. One
// read as B (rows r0 + 2 tg or r0 + 2 tg + 1, columns c0 + gr) touches 2 (W
// + 4) tg + gr + const, and 2 (W + 4) is 8 or 24 mod 32: the 4 rows 8 apart
// in some order, each with its 8 columns. 32 distinct banks either way at
// every such W (tests/test_torch_attention_mma.py counts them), so no
// fragment load conflicts, and every address is a thread's base plus a
// constant. (An XOR
// swizzle is conflict-free too but needs arithmetic at every load; the
// padded kernels ran 7-14% faster, bench_attention --kernel lanes_bwd.)
// A k-major tile (rows along k, columns along m or n: the GEMM's A of dW
// and B of dseq and dW) is read in the natural k order by
// `frag_a_kmajor` and `frag_b_kmajor`: rows k0 + tg, k0 + tg + 4, columns
// c0 + gr (and c0 + gr + 8), banks LD tg + gr + const. At a row stride LD
// = 8 mod 32 (attention_gemm.cu pads 64- and 128-float rows by 8) the 4
// rows fall 8 apart, 32 distinct banks for every load
// (tests/test_torch_gemm_mma.py counts them, with the GEMM's KC + 4 tiles
// read by `tile_frag_a` and `tile_frag_bt`).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace gpnf {

// x rounded to tf32 as cvt.rna.tf32.f32 rounds it (nearest, ties away
// from zero), low 13 bits cleared: half of the dropped part added to the
// magnitude's bits, a carry rounding up. The same bits for every finite x
// in two integer operations; ptxas expands cvt.rna.tf32 into a compare, a
// select and more (the kernels ran 20% slower with it, NVIDIA H100 80GB
// HBM3 at 700 W, bench_attention --kernel lanes_bwd).
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

// An accumulator c (16 x 8, columns = k) as the A fragment of the next
// product, in the permuted k order of the header.
__device__ __forceinline__ FragA frag_a_from_c(const float (&c)[4]) {
  return frag_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the two small terms first, then the large one.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// -- padded tiles and cp.async ------------------------------------------------
constexpr int kTilePad = 4;  // floats after each W-float row of a tile

// The index of float c of row r in a tile of W-float rows.
template <int W>
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * (W + kTilePad) + c;
}

// The A fragment of a tile's rows r .. r + 8 and columns c .. c + 4 (r the
// lane's row r0 + gr, c its column c0 + tg).
template <int W>
__device__ __forceinline__ FragA tile_frag_a(const float* tile, int r, int c) {
  return frag_a(tile[tile_at<W>(r, c)], tile[tile_at<W>(r + 8, c)],
                tile[tile_at<W>(r, c + 4)], tile[tile_at<W>(r + 8, c + 4)]);
}

// The B fragment of a tile read as B^T: row r (n = gr), columns c, c + 4
// (k = tg, tg + 4).
template <int W>
__device__ __forceinline__ FragB tile_frag_bt(const float* tile, int r,
                                              int c) {
  return frag_b(tile[tile_at<W>(r, c)], tile[tile_at<W>(r, c + 4)]);
}

// The B fragment of a tile read as B in the permuted k order: rows r, r + 1
// (k = tg, tg + 4 for rows r0 + 2 tg, r0 + 2 tg + 1), column c (n = gr).
template <int W>
__device__ __forceinline__ FragB tile_frag_b(const float* tile, int r, int c) {
  return frag_b(tile[tile_at<W>(r, c)], tile[tile_at<W>(r + 1, c)]);
}

// The A fragment of a k-major tile of LD-float rows: rows k, k + 4 (k =
// k0 + tg), columns r, r + 8 (m = r0 + gr).
template <int LD>
__device__ __forceinline__ FragA frag_a_kmajor(const float* tile, int k,
                                               int r) {
  return frag_a(tile[k * LD + r], tile[k * LD + r + 8],
                tile[(k + 4) * LD + r], tile[(k + 4) * LD + r + 8]);
}

// The B fragment of a k-major tile of LD-float rows: rows k, k + 4 (k =
// k0 + tg), column c (n = c0 + gr).
template <int LD>
__device__ __forceinline__ FragB frag_b_kmajor(const float* tile, int k,
                                               int c) {
  return frag_b(tile[k * LD + c], tile[(k + 4) * LD + c]);
}

// 16 bytes from global src to shared dst, or 16 zero bytes where !valid
// (src is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes from global src to shared dst, or a zero where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of the (S, W) slice at `src` (row stride `stride`
// floats, 16-byte aligned) into the padded tile dst (ROWS, TW) of TW-float
// rows, TW >= W (columns W .. TW - 1 are not written), by all `threads`
// threads of the block; rows past S are zero. Asynchronous: the caller
// commits and waits.
template <int W, int ROWS, int TW = W>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                int r0, int seq_len,
                                                size_t stride, int threads) {
  static_assert(W % 4 == 0 && TW >= W, "whole 16-byte chunks of a row");
  constexpr int kChunks = W / 4;
  for (int e = threadIdx.x; e < ROWS * kChunks; e += threads) {
    const int r = e / kChunks;
    const int c = e - r * kChunks;
    const bool valid = r0 + r < seq_len;
    const float* from =
        src + static_cast<size_t>(valid ? r0 + r : 0) * stride + 4 * c;
    cp_async16(dst + tile_at<TW>(r, 4 * c), from, valid);
  }
}

}  // namespace gpnf
