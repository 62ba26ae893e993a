// The PixelCNN++ gated residual conv of the coupling networks, forward with
// in-kernel Dropout2d and backward, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_gated_conv.py, `_fwd_kernel` and
// `_bwd_kernel` (both launched by `_run`, from `fused_gated_conv`).
//
// Per pixel of x (B, H, W, C), channel-last, with w1 (3, 3, 2C, C) the 3x3
// taps input-major and wg (2C, 2C) the 1x1 gate input-major:
//   h1 = concat_elu(x) = elu([x, -x]),  elu(z) = z > 0 ? z : exp(z) - 1
//   h  = conv3x3_same(h1, w1) + b1                       (C)
//   h2 = concat_elu(h) * s,  s[b, j] = keep ? 1 / (1 - rate) : 0   (2C)
//   [a | g] = h2 @ wg + bg;  out = a * sigmoid(g) + x
// The keep bit of channel j of batch row b is `bits >= threshold`, bits
// from philox.cuh as a pure function of (seed, b, j), one per (b, channel)
// and constant over space, as torch's Dropout2d; the seed is read on the
// device. Backward (the Pallas `_bwd_kernel`), with G = d out:
//   da = G sig;  dg = G a sig (1 - sig);  dG2 = [da | dg]
//   dwg = sum over pixels of h2^T dG2;  dbg = sum of dG2
//   dh2 = (dG2 @ wg^T) * s;  dh = dh2[:C] elu'(h) - dh2[C:] elu'(-h)
//   db1 = sum of dh;  dw1[ky, kx] = sum over pixels of h1(shifted)^T dh
//   dh1 = conv3x3_transposed(dh, w1);  dx = dh1[:C] elu'(x) - dh1[C:] elu'(-x) + G
//
// What bounds it on the H100: operations. The forward is 2 * (9 * 2C * C +
// 2C * 2C) FLOP a pixel (405,504 at C = 96: the conv 331,776, the gate
// 73,728); the backward three times that (the conv and the gate again, dh2
// and dwg, dh1 and dw1). At batch 64 and C = 96 the forward is 6.6 GFLOP
// at the 32-px level 0 (16 x 16): 40.3 us at 3xTF32's 165 TFLOP/s on the
// tensor cores, against 3.8 us for the bytes of x and out.
//
// Design: every product of the block is one GEMM on the tensor cores, in
// 3xTF32 (mma_tf32.cuh: each operand split hi + lo, three mma.sync.m16n8k8
// a k step, about fp32 accurate), C a run-time value. One kernel template,
// `gated_conv_mma_kernel`, instantiated once a product: a block computes a
// BM x BN tile of c = A B with warps of WM x WN; K runs in chunks of KC
// through a ring of kStages shared-memory stages filled by cp.async (the
// chunk kStages - 1 ahead in flight while one is multiplied); each chunk
// is summed into fresh accumulators and added to the block's sums in fp32,
// as attention_gemm.cu does (the tensor cores' accumulation truncates).
// Shared memory does not depend on C (55-111 KB by tile). The products,
// with P = B H W pixels:
//   conv  (P x C,   K = 9 x 2C): A = im2col(concat_elu(x)), B = w1 as (18C, C)
//   gate  (P x 2C,  K = 2C):     A = h2,                    B = wg
//   dh    (P x 2C,  K = 2C):     A = dG2,                   B = wg^T
//   dx    (P x 2C,  K = 9 x C):  A = im2col(dh) at the flipped taps,
//                                B(tap C + o, i) = w1[tap][i][o]
//   dwg   (2C + 1 x 2C, K = P):  A = [h2 | 1]^T,            B = dG2
//   dw1   (18C + 1 x C, K = P):  A = [im2col(concat_elu(x)) | 1]^T, B = dh
// A gathered operand is copied by cp.async from x (or dh) at each row's
// neighbour, zeros outside the image, and the concat-ELU is applied in
// shared memory once a staged element, by the thread that copied it,
// before the chunk's barrier: a staged x value v gives elu(v) and elu(-v),
// one of them v or -v and the other exp(-|v|) - 1, so one expf serves the
// pair. The conv's chunk is KC / 2 channels of x at one tap and its KC k
// rows are their elu(v) and elu(-v) (B's rows of both halves of w1[tap]);
// dw1's blocks are one tap's BM / 2 channels and their negatives, and one
// block more holds the ones row. So a chunk never crosses a tap, and a
// ragged one is zeros. The gate, dh and dx tiles pair their columns: a
// block's BN columns are o0 .. o0 + BN/2 - 1 and C + o0 .. C + o0 + BN/2 -
// 1, and fragment j and j + NI/2 of a warp hold the same o, so a thread
// holds a(o) and g(o) (or dh1[i] and dh1[C + i]) together and the GLU, the
// dG2, the dh and the dx epilogues run in registers. The forward is the
// conv and the gate with h2 (P x 2C) in device memory between them (and a
// launch that fills the (B, 2C) table of dropout scales at rate > 0); the
// backward recomputes the forward from (x, weights, seed), as the JAX
// custom VJP does, then runs dh (which overwrites h in place: an element
// is read and written by one thread), dx, dwg and dw1.
//
// Split K: the weight gradients sum over every pixel (K = P up to 65,536)
// on few output tiles (dwg at C = 96 has 12), and at the small levels the
// conv and dx walk a long K (9 x 2C) on few tiles (the 32-px level 2 has
// 16 rows of blocks). So a product whose tiles make fewer blocks than its
// threshold (kSplitBlocks for the weight gradients, kSplitBelowTiles for
// the others) splits K over `splits` blocks (blockIdx.z), a pure function
// of the shape (`product_splits`: aimed at kSplitBlocks blocks, each split
// whole chunks, the pixel products' at least kMinSplitChunks); each split
// writes its partial and `sum_splits_kernel` adds them in split order and
// runs the product's epilogue. A row of ones under A gives the bias
// gradients in the same sums. No atomics: two calls give the same bits.
//
// Tiles, from the shape alone (`pick_tile`): 128 x 128 with 8 warps of 64
// x 32 where they cover the output with no ragged edge (C a multiple of
// 64) in kLargeMinTiles blocks; for unpaired columns in (64, 128] one
// block across them, 64 x 96 (4 warps of 32 x 48) up to 96 and 64 x 128
// (8 warps of 32 x 32) above, so the gathered, ELU'd A is staged once a
// row of blocks; else 64 x 64 with 4 warps of 32 x 32. Operands: the
// 16-byte cp.async path where C is a multiple of 4 and every operand starts
// on a 16-byte boundary, else the same kernels copy 4 bytes at a time on
// 64 x 64 tiles (any C >= 1). Pixel indices go through a float reciprocal
// (exact below 2^24 pixels, kMaxPixels; the entries refuse more).
//
// Chosen on the card (NVIDIA H100 80GB HBM3, 700 W; bench_gated_conv, refs
// in turns; PERF.md §6): the paired ELU staging took the conv's loop
// body on 64 x 64 tiles from 1,022 to 765 SASS instructions a chunk; the
// 64 x 96 tile beat 64 x 128 at C = 96 (level 0 forward 0.2219 -> 0.1762
// ms); split K took the 32-px level 2 forward from 0.106 to 0.036 ms; a
// paired 64 x 96 tile for the gate, dh and dx (1-10% slower), a split
// target of 132 blocks (up to 14% slower), 4 stages (up to 10% slower)
// and <= 128 registers (spills, 12-45% slower) were not kept.
//
// ptxas (sm_90a): 128-229 registers by tile and product, no spills but
// dwg's 64 x 96 instantiation (8 bytes); shared memory 55,296 (64 x 64),
// 67,584 (64 x 96), 79,872 (64 x 128) and 104,448-110,592 bytes (128 x
// 128), plus the gathers' row table of 1 or 2 KB.
//
// bf16 (MarScfConfig(compute_dtype="bfloat16", fused_gated_conv=True)):
// the same six products on bf16 operands with fp32 sums, as the Pallas
// kernels compute them on bf16 x and weights (`gpnf_gated_conv_fwd_bf16`,
// `gpnf_gated_conv_bwd_bf16`). The kernel template is the float32 one
// with another operand policy (`OpBf16`: bf16 staging, rows padded by 8
// values, ldmatrix fragment loads, one mma.sync.m16n8k16 a k16 step from
// mma_bf16.cuh, two steps a 32-deep chunk summed into fresh fp32
// accumulators; `OpF32` is the 3xTF32 policy above), the same tiles,
// chunks, splits and launches; bf16 epilogues round where the Pallas
// `_forward_math` and `_bwd_kernel` round:
//   h1 = bf16(elu) of each staged x value (the concat-ELU in shared memory)
//   h  = bf16(bf16(conv) + b1);  h2 = bf16(bf16(elu(+-h)) * s), s in bf16
//   [a | g] = bf16(bf16(h2 @ wg) + bg);  out = bf16(a sigmoid(g) + x), fp32
//   dG2 = bf16([G sig | G a sig (1 - sig)]);  dh2 = bf16((dG2 wg^T) s)
//   dh = dh2[:C] elu'(h) - dh2[C:] elu'(-h) in fp32, bf16(dh) for dx, dw1
//   db1 = the fp32 column sums of the unrounded dh (their own two launches,
//   rows in a fixed order), dx = bf16(dh1[:C] elu'(x) - dh1[C:] elu'(-x) + G)
//   dwg, dbg (the ones row under A: sums of the rounded dG2), dw1 in fp32
// (dw1 has no ones row in bf16). The 16-byte copies need C a multiple of
// 8; else one value at a time by plain loads (any C >= 1). Bound: the
// bf16 tensor cores' 989 TFLOP/s, 2 (18 C^2 + 4 C^2) FLOP a pixel forward
// (6.72 us at the 32-px level 0, batch 64, C 96), three times that
// backward. Measured (NVIDIA H100 80GB HBM3, 700 W; bench_gated_conv
// --dtype bfloat16, in turns with the float32 kernels): the level-0
// forward 0.0940 ms (float32 0.1735), the backward 0.3188 (0.5719); C 512
// at batch 16, 16 x 16: 0.3877 (0.9280), 1.1409 (3.1478). ptxas: 96-233
// registers; dw1's 64 x 64 and 128 x 128 instantiations spill 8 and 4
// bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"

namespace {

using gpnf::bf16;
using gpnf::FragA;
using gpnf::FragB;

constexpr int KC = 32;  // k rows a stage holds; a chunk never crosses a tap
constexpr int kLargeMinTiles = 128;  // 128 x 128 tiles from this many up
constexpr int kSplitBlocks = 2 * 132;  // the blocks a split product aims at
constexpr int kSplitBelowTiles = 128;  // pixel products split below this
constexpr int kMinSplitChunks = 8;  // chunks a split pixel product sums
constexpr int kSumThreads = 256;
constexpr int kMaxPixels = 1 << 24;  // pixel indices exact in a float
constexpr int kColSplits = 256;  // row ranges of the bf16 db1 column sums

template <int BM_, int BN_, int WM_, int WN_, int STAGES>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kStages = STAGES;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int MI = WM / 16;  // m16 rows of accumulators a warp
  static constexpr int NI = WN / 8;   // n8 columns, NI / 2 in each half
};
using Large = Tile<128, 128, 64, 32, 3>;
using Wide = Tile<64, 128, 32, 32, 3>;
using Mid = Tile<64, 96, 32, 48, 3>;
using Small = Tile<64, 64, 32, 32, 3>;

// How a product's A operand is read.
constexpr int kARows = 0;   // A (m, kt) row-major: h2 (gate), dG2 (dh)
constexpr int kAConv = 1;   // im2col of concat_elu(x), K = 9 x 2C: the conv
constexpr int kADx = 2;     // im2col of dh at the flipped taps, K = 9 x C
constexpr int kACols = 3;   // A^T with a row of ones: [h2 | 1]^T (dwg | dbg)
constexpr int kAConvT = 4;  // the conv's im2col^T (dw1), the ones row in fp32

__host__ __device__ constexpr bool trans_a(int mode) { return mode >= kACols; }
__host__ __device__ constexpr bool gathers(int mode) {
  return mode == kAConv || mode == kADx;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
template <class E>
__device__ __forceinline__ E from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the nearest bf16, as a float.
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The B fragments of the n8 tiles at columns lo .. lo + 7 (b[0], b[1]) and
// hi .. hi + 7 (b[2], b[3]), k0 .. k0 + 15, of a tile whose rows run along
// n (B^T, rows of LD values), by one ldmatrix.x4: a paired tile's two
// halves in one load.
template <int LD>
__device__ __forceinline__ void frag_b_bf16_rows2(uint32_t (&b)[4],
                                                  const bf16* tile, int lo,
                                                  int hi, int k0, int lane) {
  gpnf::ldmatrix_x4(b, tile + ((lane >> 4) ? hi : lo) * LD +
                           (lane & 7) * LD + k0 + (((lane >> 3) & 1) << 3));
}

// The same from a tile whose rows run along k (KC rows of LD values), by
// ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void frag_b_bf16_cols2(uint32_t (&b)[4],
                                                  const bf16* tile, int k0,
                                                  int lo, int hi, int lane) {
  gpnf::ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) +
                                     (((lane >> 3) & 1) << 3)) * LD +
                                 ((lane >> 4) ? hi : lo));
}

// The operand policies: what a stage holds, how a chunk's product runs.
// float32: 3xTF32 (mma_tf32.cuh), k steps of 8, scalar fragment loads.
struct OpF32 {
  using E = float;
  static constexpr int kKPad = gpnf::kTilePad;  // after each KC-float row
  static constexpr int kOuterPad = 8;  // floats after each BM- or BN-float row
  static constexpr int kPer = 4;  // values a 16-byte copy

  // part += the chunk's product (KC deep) of the warp's tiles.
  template <class T, bool TRANS_A, bool TRANS_B, int LDA, int LDB>
  static __device__ __forceinline__ void product(
      float (&part)[T::MI][T::NI][4], const float* as, const float* bs,
      int wm, int wn, int lane) {
    constexpr int MI = T::MI, NI = T::NI, HB = T::BN / 2;
    const int gr = lane >> 2;
    const int tg = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      FragB fb[NI];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int nl = (j < NI / 2 ? 0 : HB) + wn + 8 * (j % (NI / 2)) + gr;
        fb[j] = TRANS_B ? gpnf::tile_frag_bt<KC>(bs, nl, kk + tg)
                        : gpnf::frag_b_kmajor<LDB>(bs, kk + tg, nl);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = wm + 16 * i + gr;
        const FragA fa = TRANS_A
                             ? gpnf::frag_a_kmajor<LDA>(as, kk + tg, row)
                             : gpnf::tile_frag_a<KC>(as, row, kk + tg);
#pragma unroll
        for (int j = 0; j < NI; ++j) gpnf::mma_3xtf32(part[i][j], fa, fb[j]);
      }
    }
  }
};

// bf16: mma.sync.m16n8k16 (mma_bf16.cuh), k steps of 16, ldmatrix loads;
// rows padded by 8 values (odd multiples of 16 bytes: conflict-free).
struct OpBf16 {
  using E = bf16;
  static constexpr int kKPad = gpnf::kBf16Pad;
  static constexpr int kOuterPad = gpnf::kBf16Pad;
  static constexpr int kPer = 8;

  template <class T, bool TRANS_A, bool TRANS_B, int LDA, int LDB>
  static __device__ __forceinline__ void product(
      float (&part)[T::MI][T::NI][4], const bf16* as, const bf16* bs,
      int wm, int wn, int lane) {
    constexpr int MI = T::MI, NI = T::NI, HB = T::BN / 2;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t fb[NI][2];
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {  // fragment j and j + NI / 2
        uint32_t r[4];
        if (TRANS_B) {
          frag_b_bf16_rows2<LDB>(r, bs, wn + 8 * j, HB + wn + 8 * j, kk,
                                 lane);
        } else {
          frag_b_bf16_cols2<LDB>(r, bs, kk, wn + 8 * j, HB + wn + 8 * j,
                                 lane);
        }
        fb[j][0] = r[0];
        fb[j][1] = r[1];
        fb[j + NI / 2][0] = r[2];
        fb[j + NI / 2][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t fa[4];
        if (TRANS_A) {
          gpnf::frag_a_bf16_trans<LDA>(fa, as, kk, wm + 16 * i, lane);
        } else {
          gpnf::frag_a_bf16<LDA>(fa, as, wm + 16 * i, kk, lane);
        }
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          gpnf::mma_bf16(part[i][j], fa, fb[j][0], fb[j][1]);
        }
      }
    }
  }
};

// The shared memory of one stage: A's tile, then B's, in Op's values.
template <class Op, class T, bool TRANS_A, bool TRANS_B>
struct Stage {
  static constexpr int kLda =
      TRANS_A ? T::BM + Op::kOuterPad : KC + Op::kKPad;
  static constexpr int kLdb =
      TRANS_B ? KC + Op::kKPad : T::BN + Op::kOuterPad;
  static constexpr int kA = TRANS_A ? KC * kLda : T::BM * kLda;
  static constexpr int kB = TRANS_B ? T::BN * kLdb : KC * kLdb;
  static constexpr int kVals = kA + kB;
  static constexpr size_t kBytes =
      sizeof(typename Op::E) * T::kStages * kVals;
};

// One product c (m x n) = A B, K = taps x kt summed tap by tap.
struct Problem {
  const void* a;      // x, h2, dG2 or dh (as the A mode reads it)
  const void* b;      // w1, wg, dG2 or dh
  int m, n;           // c's rows and columns (n = 2C where paired)
  int kt, taps;       // K of one tap, and taps (9 for the 3 x 3 gathers)
  int split_chunks;   // chunks of KC a split sums
  int half;           // paired: C, the column that pairs with column 0
  int ones;           // dw1: 1 where A has the row of ones (float32)
  int channels, height, width, hw;
  float inv_width, inv_hw;
};

__device__ __forceinline__ float elu(float z) {
  return z > 0.f ? z : expf(z) - 1.f;
}

__device__ __forceinline__ float delu(float z) {
  return z > 0.f ? 1.f : expf(z);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// p / d for 0 <= p < kMaxPixels, inv = 1 / d: the float quotient is off by
// at most one, which the remainder corrects.
__device__ __forceinline__ int div_index(int p, int d, float inv) {
  int q = __float2int_rz(__int2float_rn(p) * inv);
  const int r = p - q * d;
  if (r < 0) {
    --q;
  } else if (r >= d) {
    ++q;
  }
  return q;
}

// (y, x) of pixel p.
__device__ __forceinline__ int2 pixel_yx(int p, const Problem& pr) {
  const int rem = p - div_index(p, pr.hw, pr.inv_hw) * pr.hw;
  const int y = div_index(rem, pr.width, pr.inv_width);
  return make_int2(y, rem - y * pr.width);
}

// The neighbour of tap (0 .. 8) of a pixel: (dy, dx), or its flip (the
// transposed conv of dx).
template <bool FLIP>
__device__ __forceinline__ int2 tap_offset(int tap) {
  const int dy = tap / 3 - 1, dx = tap - 3 * (tap / 3) - 1;
  return FLIP ? make_int2(-dy, -dx) : make_int2(dy, dx);
}

// The global column of a tile's column nl (and whether it is in c): paired,
// nl < BN/2 is o0 + nl and nl >= BN/2 is C + o0 + nl - BN/2.
template <bool PAIRED, int HB>
__device__ __forceinline__ int column(const Problem& pr, int n0, int nl,
                                      bool& ok) {
  if (PAIRED) {
    const int o = n0 + (nl < HB ? nl : nl - HB);
    ok = o < pr.half;
    return nl < HB ? o : pr.half + o;
  }
  ok = n0 + nl < pr.n;
  return n0 + nl;
}

template <bool VEC>
__device__ __forceinline__ void copy(float* dst, const float* src,
                                     bool valid) {
  if (VEC) {
    gpnf::cp_async16(dst, src, valid);
  } else {
    gpnf::cp_async4(dst, src, valid);
  }
}

// bf16: 16 bytes by cp.async, or one value by a plain load and store (the
// barrier before the stage's use orders it).
template <bool VEC>
__device__ __forceinline__ void copy(bf16* dst, const bf16* src,
                                     bool valid) {
  if (VEC) {
    gpnf::cp_async16_bf16(dst, src, valid);
  } else {
    *dst = valid ? *src : __float2bfloat16_rn(0.f);
  }
}

// The block's place in c: its first row m0 (kAConvT: its tap, its first
// channel pair c0, or the ones row's block), its first column n0 (o0 where
// paired).
struct Block {
  int m0, n0, tap, c0;
  bool ones;
};

// Copy e of a stage's `kTotal` (e = threadIdx.x + it kThreads): the loops
// that copy and those that apply the concat-ELU take the same e, so each
// thread transforms its own copies. kIters rounds up; a ragged last pass
// (bf16's 16-byte copies on 256-thread tiles) stops at kTotal.
template <class T, int kTotal>
struct Copies {
  static constexpr int kIters = (kTotal + T::kThreads - 1) / T::kThreads;
  static __device__ __forceinline__ bool past(int e) {
    return kTotal % T::kThreads != 0 && e >= kTotal;
  }
};

// A's tile of chunk (tap, k0) into as.
//   kARows: rows m0 .. of a (m, kt), columns k0 .. k0 + KC.
//   kAConv: x's channels k0 .. k0 + KC/2 at each row's neighbour at the tap
//     (rows_s: the rows' pixels), into columns 0 .. KC/2; `elu_a` puts
//     elu(v) there and elu(-v) KC/2 columns on.
//   kADx: dh's channels k0 .. k0 + KC at the flipped neighbour.
//   kACols: A^T of a (kt, m - 1) and the ones row m - 1.
//   kAConvT: pixels k0 .. k0 + KC of x's channels c0 .. c0 + BM/2 at the
//     block's tap, into columns 0 .. BM/2 (`elu_a` puts elu(-v) BM/2 on);
//     the ones row's block writes its ones and zeros itself.
template <class Op, class T, int AM, bool VEC>
__device__ __forceinline__ void load_a(typename Op::E* as, const Problem& pr,
                                       const Block& blk, int tap, int k0,
                                       const int4* rows_s) {
  using E = typename Op::E;
  using S = Stage<Op, T, trans_a(AM), false>;
  constexpr int kPer = VEC ? Op::kPer : 1;
  const E* a = static_cast<const E*>(pr.a);
  if constexpr (!trans_a(AM)) {  // BM rows of KC (kAConv: KC / 2 copied)
    constexpr int kRow = (AM == kAConv ? KC / 2 : KC) / kPer;
    using C = Copies<T, T::BM * kRow>;
#pragma unroll
    for (int it = 0; it < C::kIters; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if (C::past(e)) break;
      const int r = e / kRow;
      const int cc = kPer * (e - r * kRow);
      const int k = k0 + cc;
      bool valid;
      const E* src;
      if constexpr (AM == kARows) {
        valid = blk.m0 + r < pr.m && k < pr.kt;
        src = a + static_cast<long long>(blk.m0 + r) * pr.kt + k;
      } else {
        const int4 g = rows_s[r];
        const int2 d = tap_offset<AM == kADx>(tap);
        const int y = g.y + d.x, x = g.z + d.y;
        valid = k < pr.kt && y >= 0 && y < pr.height && x >= 0 &&
                x < pr.width;
        src = a +
              static_cast<long long>(g.x + d.x * pr.width + d.y) *
                  pr.channels + k;
      }
      copy<VEC>(as + r * S::kLda + cc, valid ? src : a, valid);
    }
  } else {  // KC rows (k = pixels) of BM (m)
    constexpr int kCols = AM == kAConvT ? T::BM / 2 : T::BM;
    constexpr int kRow = kCols / kPer;
    using C = Copies<T, KC * kRow>;
    const int rows = pr.m - 1;  // the row of ones
#pragma unroll
    for (int it = 0; it < C::kIters; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if (C::past(e)) break;
      const int kk = e / kRow;
      const int cc = kPer * (e - kk * kRow);
      const int k = k0 + kk;
      E* dst = as + kk * S::kLda + cc;
      if constexpr (AM == kACols) {
        const int mcol = blk.m0 + cc;
        if (mcol < rows) {  // all kPer columns are data (VEC: 2C % kPer == 0)
          const bool valid = k < pr.kt;
          const E* src = a + static_cast<long long>(k) * rows + mcol;
          copy<VEC>(dst, valid ? src : a, valid);
        } else {  // the ones row (the bias gradient), zeros past it
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            dst[q] = from_float<E>((mcol + q == rows && k < pr.kt) ? 1.f
                                                                   : 0.f);
          }
        }
      } else if (blk.ones) {  // the ones row is the block's row 0
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          dst[q] = from_float<E>((cc + q == 0 && k < pr.kt) ? 1.f : 0.f);
          dst[q + kCols] = from_float<E>(0.f);
        }
      } else {
        const int ch = blk.c0 + cc;
        bool valid = k < pr.kt && ch < pr.channels;
        const int2 yx = pixel_yx(valid ? k : 0, pr);
        const int2 d = tap_offset<false>(blk.tap);
        const int y = yx.x + d.x, x = yx.y + d.y;
        valid = valid && y >= 0 && y < pr.height && x >= 0 && x < pr.width;
        const E* src =
            a + static_cast<long long>(k + d.x * pr.width + d.y) *
                    pr.channels + ch;
        copy<VEC>(dst, valid ? src : a, valid);
      }
    }
  }
}

// concat_elu of this thread's own copies, in place: a staged v becomes
// elu(v), and elu(-v) goes HALF columns on (one expf for the two: one of
// them is v or -v), each rounded to the staging type. Zeros (outside the
// image, past C) give zeros.
template <int HALF, class E>
__device__ __forceinline__ void concat_elu_at(E* at) {
  const float v = to_float(*at);
  const float e = expf(-fabsf(v)) - 1.f;
  at[0] = from_float<E>(v > 0.f ? v : e);
  at[HALF] = from_float<E>(v < 0.f ? -v : e);
}

template <class Op, class T, int AM, bool VEC>
__device__ __forceinline__ void elu_a(typename Op::E* as, const Block& blk) {
  using S = Stage<Op, T, trans_a(AM), false>;
  constexpr int kPer = VEC ? Op::kPer : 1;
  if constexpr (AM == kAConv) {
    constexpr int kRow = KC / 2 / kPer;
    using C = Copies<T, T::BM * kRow>;
#pragma unroll
    for (int it = 0; it < C::kIters; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if (C::past(e)) break;
      const int r = e / kRow;
      const int cc = kPer * (e - r * kRow);
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        concat_elu_at<KC / 2>(as + r * S::kLda + cc + q);
      }
    }
  } else if constexpr (AM == kAConvT) {
    constexpr int kRow = T::BM / 2 / kPer;
    using C = Copies<T, KC * kRow>;
    if (blk.ones) return;
#pragma unroll
    for (int it = 0; it < C::kIters; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if (C::past(e)) break;
      const int kk = e / kRow;
      const int cc = kPer * (e - kk * kRow);
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        concat_elu_at<T::BM / 2>(as + kk * S::kLda + cc + q);
      }
    }
  }
}

// B's tile of chunk (tap, k0) into bs: KC rows of BN (B (taps kt, n)
// row-major), or, TRANS_B, BN rows of KC (B^T (taps n, kt) row-major).
// KPAIR (the conv): rows k0 .. k0 + KC/2 and kt + k0 .. kt + k0 + KC/2 of
// the tap's 2 kt, the rows that multiply elu(v) and elu(-v).
template <class Op, class T, bool TRANS_B, bool PAIRED, bool KPAIR, bool VEC>
__device__ __forceinline__ void load_b(typename Op::E* bs, const Problem& pr,
                                       int n0, int tap, int k0) {
  using E = typename Op::E;
  using S = Stage<Op, T, false, TRANS_B>;
  constexpr int kPer = VEC ? Op::kPer : 1;
  constexpr int HB = T::BN / 2;
  const E* b = static_cast<const E*>(pr.b);
  if constexpr (!TRANS_B) {
    constexpr int kRow = T::BN / kPer;
    using C = Copies<T, KC * kRow>;
#pragma unroll
    for (int it = 0; it < C::kIters; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if (C::past(e)) break;
      const int kk = e / kRow;
      const int nl = kPer * (e - kk * kRow);
      bool ok;
      const int col = column<PAIRED, HB>(pr, n0, nl, ok);
      long long row;
      if constexpr (KPAIR) {
        const int q = kk % (KC / 2);
        ok = ok && k0 + q < pr.kt;
        row = 2LL * tap * pr.kt + (kk < KC / 2 ? 0 : pr.kt) + k0 + q;
      } else {
        ok = ok && k0 + kk < pr.kt;
        row = static_cast<long long>(tap) * pr.kt + k0 + kk;
      }
      const E* src = b + row * pr.n + col;
      copy<VEC>(bs + kk * S::kLdb + nl, ok ? src : b, ok);
    }
  } else {
    constexpr int kRow = KC / kPer;
    using C = Copies<T, T::BN * kRow>;
#pragma unroll
    for (int it = 0; it < C::kIters; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      if (C::past(e)) break;
      const int r = e / kRow;
      const int cc = kPer * (e - r * kRow);
      bool ok;
      const int col = column<PAIRED, HB>(pr, n0, r, ok);
      const bool valid = ok && k0 + cc < pr.kt;
      const E* src =
          b + (static_cast<long long>(tap) * pr.n + col) * pr.kt + k0 + cc;
      copy<VEC>(bs + r * S::kLdb + cc, valid ? src : b, valid);
    }
  }
}

// Split z = blockIdx.z of c = A B over the chunks [z split_chunks, ...),
// then epi on every entry of the tile: epi(row, o, c[o], c[half + o]) where
// PAIRED, else epi(row, col, c[col]). Op: the operands' type and product.
template <class Op, class T, int AM, bool TRANS_B, bool PAIRED, bool VEC,
          class Epi>
__global__ void __launch_bounds__(T::kThreads)
    gated_conv_mma_kernel(const Problem pr, const Epi epi) {
  using E = typename Op::E;
  constexpr bool TRANS_A = trans_a(AM);
  using S = Stage<Op, T, TRANS_A, TRANS_B>;
  constexpr int MI = T::MI, NI = T::NI, HB = T::BN / 2, HM = T::BM / 2;
  constexpr int KSTEP = AM == kAConv ? KC / 2 : KC;  // channels a chunk
  static_assert(NI % 2 == 0, "fragments j and j + NI / 2 pair");
  extern __shared__ float4 gconv_smem[];
  E* smem = reinterpret_cast<E*>(gconv_smem);
  int4* rows_s = reinterpret_cast<int4*>(smem + T::kStages * S::kVals);
  Block blk{static_cast<int>(blockIdx.x) * T::BM,
            static_cast<int>(blockIdx.y) * (PAIRED ? HB : T::BN), 0, 0,
            false};
  if constexpr (AM == kAConvT) {  // 9 taps of ceil(C / HM) blocks, the ones
    const int per_tap = (pr.channels + HM - 1) / HM;
    blk.tap = blockIdx.x / per_tap;
    blk.ones = blk.tap == 9;
    blk.c0 = (blockIdx.x - blk.tap * per_tap) * HM;
  }
  const int cpt = (pr.kt + KSTEP - 1) / KSTEP;  // chunks a tap
  const int c_begin = blockIdx.z * pr.split_chunks;
  const int nk = min(pr.taps * cpt, c_begin + pr.split_chunks) - c_begin;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int wm = (warp / T::kWarpsN) * T::WM;
  const int wn = (warp % T::kWarpsN) * (T::WN / 2);  // within each half

  if constexpr (gathers(AM)) {  // each row's pixel, once a block
    for (int r = threadIdx.x; r < T::BM; r += T::kThreads) {
      const int p = blk.m0 + r;
      int4 g = make_int4(0, -4, -4, 0);  // past P: every tap is outside
      if (p < pr.m) {
        const int2 yx = pixel_yx(p, pr);
        g = make_int4(p, yx.x, yx.y, 1);
      }
      rows_s[r] = g;
    }
    __syncthreads();
  }

  auto load_stage = [&](int stage, int c) {
    E* as = smem + stage * S::kVals;
    const int tap = c / cpt;
    const int k0 = (c - tap * cpt) * KSTEP;
    load_a<Op, T, AM, VEC>(as, pr, blk, tap, k0, rows_s);
    load_b<Op, T, TRANS_B, PAIRED, AM == kAConv, VEC>(as + S::kA, pr,
                                                      blk.n0, tap, k0);
  };

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < nk) load_stage(s, c_begin + s);
    gpnf::cp_async_commit();
  }
  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    }
  }
  for (int t = 0; t < nk; ++t) {
    gpnf::cp_async_wait<T::kStages - 2>();  // this thread's copies of t
    E* as = smem + (t % T::kStages) * S::kVals;
    elu_a<Op, T, AM, VEC>(as, blk);
    __syncthreads();  // chunk t is in; every warp is done with chunk t - 1
    const int ahead = t + T::kStages - 1;  // into the stage chunk t - 1 held
    if (ahead < nk) load_stage(ahead % T::kStages, c_begin + ahead);
    gpnf::cp_async_commit();
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
      }
    }
    Op::template product<T, TRANS_A, TRANS_B, S::kLda, S::kLdb>(
        part, as, as + S::kA, wm, wn, lane);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      }
    }
  }
  // c0 (gr, 2 tg), c1 (gr, 2 tg + 1), c2 (gr + 8, 2 tg), c3 (gr + 8, 2 tg + 1)
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = wm + 16 * i + gr + 8 * h;
      int row = blk.m0 + mm;
      if constexpr (AM == kAConvT) {  // the tap's channel pairs, or the ones
        const int ch = blk.c0 + (mm < HM ? mm : mm - HM);
        if (blk.ones ? mm != 0 : ch >= pr.channels) continue;
        row = blk.ones ? pr.m - 1
                       : 2 * pr.channels * blk.tap + (mm < HM ? 0 : pr.channels)
                             + ch;
      } else if (row >= pr.m) {
        continue;
      }
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nl = wn + 8 * j + 2 * tg + e;
          const float lo = acc[i][j][2 * h + e];
          const float hi = acc[i][j + NI / 2][2 * h + e];
          if constexpr (PAIRED) {
            if (blk.n0 + nl < pr.half) epi(row, blk.n0 + nl, lo, hi);
          } else {
            if (blk.n0 + nl < pr.n) epi(row, blk.n0 + nl, lo);
            if (blk.n0 + HB + nl < pr.n) epi(row, blk.n0 + HB + nl, hi);
          }
        }
      }
    }
  }
}

// -- epilogues -----------------------------------------------------------------
// The conv: h = c + b1, h2 = concat_elu(h) * s; h too where h_out is given
// (the backward's recompute).
struct ConvOut {
  const float* b1;
  const float* s;  // (B, 2C) dropout scales, or null at rate 0
  float* h_out;
  float* h2;
  int c, hw;
  __device__ __forceinline__ void operator()(int row, int o, float v) const {
    const float h = v + b1[o];
    const size_t i = static_cast<size_t>(row) * 2 * c;
    const float* sb = s ? s + static_cast<size_t>(row / hw) * 2 * c : nullptr;
    if (h_out) h_out[static_cast<size_t>(row) * c + o] = h;
    h2[i + o] = elu(h) * (sb ? sb[o] : 1.f);
    h2[i + c + o] = elu(-h) * (sb ? sb[c + o] : 1.f);
  }
};

// The gate, paired: out = (a + bg[o]) sigmoid(g + bg[C + o]) + x.
struct GateOut {
  const float* bg;
  const float* x;
  float* out;
  int c;
  __device__ __forceinline__ void operator()(int row, int o, float a,
                                             float g) const {
    const size_t i = static_cast<size_t>(row) * c + o;
    out[i] = (a + bg[o]) * sigmoid(g + bg[c + o]) + x[i];
  }
};

// The gate again in the backward, paired: dG2 = [G sig | G a sig (1 - sig)].
struct GateGrad {
  const float* bg;
  const float* gout;
  float* dg2;
  int c;
  __device__ __forceinline__ void operator()(int row, int o, float a,
                                             float g) const {
    const float av = a + bg[o];
    const float sig = sigmoid(g + bg[c + o]);
    const float go = gout[static_cast<size_t>(row) * c + o];
    const size_t i = static_cast<size_t>(row) * 2 * c;
    dg2[i + o] = go * sig;
    dg2[i + c + o] = go * av * sig * (1.f - sig);
  }
};

// dh2 = dG2 wg^T, paired: dh = s[o] dh2[o] elu'(h) - s[C+o] dh2[C+o] elu'(-h),
// written over h (this thread's element only).
struct DhOut {
  const float* s;
  float* hdh;
  int c, hw;
  __device__ __forceinline__ void operator()(int row, int o, float lo,
                                             float hi) const {
    const size_t i = static_cast<size_t>(row) * c + o;
    const float h = hdh[i];
    const float* sb = s ? s + static_cast<size_t>(row / hw) * 2 * c : nullptr;
    hdh[i] = (sb ? sb[o] : 1.f) * lo * delu(h) -
             (sb ? sb[c + o] : 1.f) * hi * delu(-h);
  }
};

// dh1 from the transposed conv, paired: dx = dh1[i] elu'(x) - dh1[C+i]
// elu'(-x) + G.
struct DxOut {
  const float* x;
  const float* gout;
  float* dx;
  int c;
  __device__ __forceinline__ void operator()(int row, int o, float lo,
                                             float hi) const {
    const size_t i = static_cast<size_t>(row) * c + o;
    const float xv = x[i];
    dx[i] = lo * delu(xv) - hi * delu(-xv) + gout[i];
  }
};

// -- bf16 epilogues: the same, rounded where the Pallas kernels round --------
// h = bf16(bf16(c) + b1) (`.astype(dt) + b1`), h2 = bf16(bf16(elu(+-h)) s)
// (the bf16 concat-ELU, then the bf16 product with the bf16 scale).
struct ConvOutBf16 {
  const bf16* b1;
  const float* s;  // (B, 2C) dropout scales (bf16 values), or null
  bf16* h_out;
  bf16* h2;
  int c, hw;
  __device__ __forceinline__ void operator()(int row, int o, float v) const {
    const float h = rnd(rnd(v) + __bfloat162float(b1[o]));
    const size_t i = static_cast<size_t>(row) * 2 * c;
    const float* sb = s ? s + static_cast<size_t>(row / hw) * 2 * c : nullptr;
    if (h_out) h_out[static_cast<size_t>(row) * c + o] = __float2bfloat16_rn(h);
    const float e0 = rnd(elu(h)), e1 = rnd(elu(-h));
    h2[i + o] = __float2bfloat16_rn(sb ? e0 * sb[o] : e0);
    h2[i + c + o] = __float2bfloat16_rn(sb ? e1 * sb[c + o] : e1);
  }
};

// a and g rounded twice (`.astype(dt) + bg`), the GLU and + x in fp32,
// rounded once.
struct GateOutBf16 {
  const bf16* bg;
  const bf16* x;
  bf16* out;
  int c;
  __device__ __forceinline__ void operator()(int row, int o, float a,
                                             float g) const {
    const size_t i = static_cast<size_t>(row) * c + o;
    const float av = rnd(rnd(a) + __bfloat162float(bg[o]));
    const float sig = sigmoid(rnd(rnd(g) + __bfloat162float(bg[c + o])));
    out[i] = __float2bfloat16_rn(av * sig + __bfloat162float(x[i]));
  }
};

// dG2 in fp32 from the bf16 a and g and G, rounded to bf16.
struct GateGradBf16 {
  const bf16* bg;
  const bf16* gout;
  bf16* dg2;
  int c;
  __device__ __forceinline__ void operator()(int row, int o, float a,
                                             float g) const {
    const float av = rnd(rnd(a) + __bfloat162float(bg[o]));
    const float sig = sigmoid(rnd(rnd(g) + __bfloat162float(bg[c + o])));
    const float go = __bfloat162float(gout[static_cast<size_t>(row) * c + o]);
    const size_t i = static_cast<size_t>(row) * 2 * c;
    dg2[i + o] = __float2bfloat16_rn(go * sig);
    dg2[i + c + o] = __float2bfloat16_rn(go * av * sig * (1.f - sig));
  }
};

// dh2 = bf16((dG2 wg^T) s), dh in fp32 from dh2 and the bf16 h: dh into
// dh32 (db1's sums), bf16(dh) over h (dx's and dw1's operand).
struct DhOutBf16 {
  const float* s;
  bf16* hdh;
  float* dh32;
  int c, hw;
  __device__ __forceinline__ void operator()(int row, int o, float lo,
                                             float hi) const {
    const size_t i = static_cast<size_t>(row) * c + o;
    const float h = __bfloat162float(hdh[i]);
    const float* sb = s ? s + static_cast<size_t>(row / hw) * 2 * c : nullptr;
    const float d_lo = rnd(sb ? lo * sb[o] : lo);
    const float d_hi = rnd(sb ? hi * sb[c + o] : hi);
    const float dh = d_lo * delu(h) - d_hi * delu(-h);
    dh32[i] = dh;
    hdh[i] = __float2bfloat16_rn(dh);
  }
};

// dx = bf16(dh1[i] elu'(x) - dh1[C+i] elu'(-x) + G), the sum in fp32.
struct DxOutBf16 {
  const bf16* x;
  const bf16* gout;
  bf16* dx;
  int c;
  __device__ __forceinline__ void operator()(int row, int o, float lo,
                                             float hi) const {
    const size_t i = static_cast<size_t>(row) * c + o;
    const float xv = __bfloat162float(x[i]);
    dx[i] = __float2bfloat16_rn(lo * delu(xv) - hi * delu(-xv) +
                                __bfloat162float(gout[i]));
  }
};

// A weight gradient: rows < `rows` into w (rows x n), the ones row into b.
struct WgradOut {
  float* w;
  float* b;
  int rows, n;
  __device__ __forceinline__ void operator()(int row, int col, float v) const {
    if (row < rows) {
      w[static_cast<long long>(row) * n + col] = v;
    } else {
      b[col] = v;
    }
  }
};

// Split z's partial of c (m x n) at z m n, as it stands: where K is split,
// the product's own epilogue runs after the sum (`sum_splits_kernel`).
struct PartialOut {
  float* partial;
  int m, n, half;
  __device__ __forceinline__ float* at(int row, int col) const {
    return partial + (static_cast<long long>(blockIdx.z) * m + row) * n + col;
  }
  __device__ __forceinline__ void operator()(int row, int col, float v) const {
    *at(row, col) = v;
  }
  __device__ __forceinline__ void operator()(int row, int o, float a,
                                             float g) const {
    *at(row, o) = a;
    *at(row, half + o) = g;
  }
};

// s[b][j] = the Dropout2d scale of channel j (of 2C) of batch row b.
__global__ void __launch_bounds__(kSumThreads)
    drop_scale_kernel(const int* __restrict__ seed_ptr, float* __restrict__ s,
                      int count, int c2, uint32_t threshold,
                      float keep_scale) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= count) return;
  const int b = i / c2, j = i - b * c2;
  const uint4 r = gpnf::gated_conv_dropout_bits(
      static_cast<uint32_t>(*seed_ptr), b, j >> 2);
  s[i] = gpnf::philox_word(r, j & 3) >= threshold ? keep_scale : 0.f;
}

// The splits' partials of c (m x n) summed over z in order, then the
// product's epilogue: epi(row, col, c) for each entry, or, PAIRED, epi(row,
// o, c[o], c[half + o]) for each o < half.
template <bool PAIRED, class Epi>
__global__ void __launch_bounds__(kSumThreads)
    sum_splits_kernel(const float* __restrict__ partial, int m, int n,
                      int half, int splits, const Epi epi) {
  const int cols = PAIRED ? half : n;
  const long long i =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= static_cast<long long>(m) * cols) return;
  const int row = static_cast<int>(i / cols);
  const int col = static_cast<int>(i - static_cast<long long>(row) * cols);
  const long long count = static_cast<long long>(m) * n;
  const float* p = partial + static_cast<long long>(row) * n + col;
  float lo = p[0], hi = PAIRED ? p[half] : 0.f;
  for (int z = 1; z < splits; ++z) {
    lo += p[z * count];
    if (PAIRED) hi += p[z * count + half];
  }
  if constexpr (PAIRED) {
    epi(row, col, lo, hi);
  } else {
    epi(row, col, lo);
  }
}

// bf16 db1, first pass: partial[z][col] = the sum of column col of dh
// (rows x cols, fp32) over rows [z per, min(rows, (z + 1) per)), in row
// order; `sum_splits_kernel` then adds the partials in z order.
__global__ void __launch_bounds__(kSumThreads)
    col_sums_kernel(const float* __restrict__ dh, float* __restrict__ partial,
                    int rows, int cols, int per, int count) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= count) return;
  const int z = i / cols, col = i - z * cols;
  const int end = min(rows, (z + 1) * per);
  float acc = 0.f;
  for (int r = z * per; r < end; ++r) {
    acc += dh[static_cast<long long>(r) * cols + col];
  }
  partial[i] = acc;
}

// -- launches -----------------------------------------------------------------
struct Geometry {
  int batch, height, width, channels, pixels;
  bool bf16;  // dw1 without the ones row; db1 from its own column sums
};

// The product c (m x n) = A B, K = taps kt: kt is C for the conv (its 2C
// halves pair in each chunk) and dx, 2C for the gate and dh, P for the
// weight gradients.
Problem problem(const Geometry& g, const void* a, const void* b, int m,
                int n, int kt, int taps, int half) {
  Problem pr;
  pr.a = a;
  pr.b = b;
  pr.m = m;
  pr.n = n;
  pr.kt = kt;
  pr.taps = taps;
  pr.split_chunks = 0;  // `run` sets it
  pr.half = half;
  pr.ones = 0;
  pr.channels = g.channels;
  pr.height = g.height;
  pr.width = g.width;
  pr.hw = g.height * g.width;
  pr.inv_width = 1.f / static_cast<float>(g.width);
  pr.inv_hw = 1.f / static_cast<float>(pr.hw);
  return pr;
}

enum TileKind { kSmall, kMid, kWide, kLarge };

constexpr int tile_rows(TileKind t) {
  return t == kLarge ? Large::BM
         : t == kWide ? Wide::BM
         : t == kMid  ? Mid::BM
                      : Small::BM;
}

constexpr int tile_cols(TileKind t) {
  return t == kLarge ? Large::BN
         : t == kWide ? Wide::BN
         : t == kMid  ? Mid::BN
                      : Small::BN;
}

// The blocks along m at BM rows: dw1's are 9 taps of ceil(C / (BM / 2))
// channel pairs, and one for the ones row where it has one.
long long m_blocks(int am, const Problem& pr, int bm) {
  return am == kAConvT
             ? 9LL * ((pr.channels + bm / 2 - 1) / (bm / 2)) + pr.ones
             : (pr.m + bm - 1) / bm;
}

// The tiles of a product, from its shape alone: 128 x 128 where those tiles cover the
// output with no ragged edge (dw1: whole channel pairs) and make
// kLargeMinTiles blocks; else, for unpaired columns in (64, 128], one
// block's worth of them, 64 x 96 up to 96 (the conv and dw1 at C = 96) and
// 64 x 128 above (A, which carries the gather and the ELU, staged once a
// row of blocks); else 64 x 64. On the narrow path 64 x 64.
TileKind pick_tile(int am, const Problem& pr, bool vec) {
  if (!vec) return kSmall;
  const bool paired = pr.half != 0;
  const bool even = am == kAConvT ? pr.channels % (Large::BM / 2) == 0
                                  : pr.m % Large::BM == 0;
  if (am != kACols && even && pr.n % Large::BN == 0 &&
      m_blocks(am, pr, Large::BM) * (pr.n / Large::BN) >= kLargeMinTiles) {
    return kLarge;
  }
  if (!paired && pr.n > Small::BN && pr.n <= Mid::BN) return kMid;
  if (!paired && pr.n > Mid::BN && pr.n <= Wide::BN) return kWide;
  return kSmall;
}

// The splits of a product's K: one where its tiles make `below` blocks,
// else enough that tiles x splits reaches kSplitBlocks, each split at least
// `min_chunks` chunks (at most all of them) and none empty. The weight
// gradients (K = P) split below kSplitBlocks tiles, a chunk a split at
// least; the pixel products below kSplitBelowTiles, kMinSplitChunks a split
// at least (the conv and dx of the small levels: a long K on few tiles).
int product_splits(int am, const Problem& pr, TileKind t) {
  const bool wgrad = trans_a(am);
  const long long tiles =
      m_blocks(am, pr, tile_rows(t)) *
      (pr.half ? (pr.half + tile_cols(t) / 2 - 1) / (tile_cols(t) / 2)
               : (pr.n + tile_cols(t) - 1) / tile_cols(t));
  const int kstep = am == kAConv ? KC / 2 : KC;
  const int chunks = pr.taps * ((pr.kt + kstep - 1) / kstep);
  if (tiles >= (wgrad ? kSplitBlocks : kSplitBelowTiles)) return 1;
  const int want = static_cast<int>((kSplitBlocks + tiles - 1) / tiles);
  const int per = std::max((chunks + want - 1) / want,
                           wgrad ? 1 : kMinSplitChunks);  // chunks a split
  return (chunks + per - 1) / per;
}

// The splits of a product (mode, problem; paired where it has a half) on
// the tiles `pick_tile` names for it.
int splits_of(int am, const Problem& pr, bool vec) {
  return product_splits(am, pr, pick_tile(am, pr, vec));
}

template <class Op, class T, int AM, bool TRANS_B, bool PAIRED, bool VEC,
          class Epi>
cudaError_t launch_tiles(Problem pr, const Epi& epi, int splits,
                         cudaStream_t stream) {
  using S = Stage<Op, T, trans_a(AM), TRANS_B>;
  const int kstep = AM == kAConv ? KC / 2 : KC;
  const int chunks = pr.taps * ((pr.kt + kstep - 1) / kstep);
  pr.split_chunks = (chunks + splits - 1) / splits;
  const size_t bytes = S::kBytes + (gathers(AM) ? T::BM * sizeof(int4) : 0);
  const auto kernel =
      gated_conv_mma_kernel<Op, T, AM, TRANS_B, PAIRED, VEC, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int cols = PAIRED ? (pr.half + T::BN / 2 - 1) / (T::BN / 2)
                          : (pr.n + T::BN - 1) / T::BN;
  const dim3 grid(static_cast<unsigned>(m_blocks(AM, pr, T::BM)), cols,
                  splits);
  kernel<<<grid, T::kThreads, bytes, stream>>>(pr, epi);
  return cudaGetLastError();
}

template <class Op, int AM, bool TRANS_B, bool PAIRED, class Epi>
cudaError_t launch_kind(TileKind t, bool vec, const Problem& pr,
                        const Epi& epi, int splits, cudaStream_t stream) {
  if constexpr (AM != kACols) {
    if (t == kLarge) {
      return launch_tiles<Op, Large, AM, TRANS_B, PAIRED, true>(pr, epi,
                                                                splits,
                                                                stream);
    }
  }
  if constexpr (!PAIRED) {
    if (t == kWide) {
      return launch_tiles<Op, Wide, AM, TRANS_B, PAIRED, true>(pr, epi,
                                                               splits, stream);
    }
    if (t == kMid) {
      return launch_tiles<Op, Mid, AM, TRANS_B, PAIRED, true>(pr, epi,
                                                              splits, stream);
    }
  }
  return vec ? launch_tiles<Op, Small, AM, TRANS_B, PAIRED, true>(
                   pr, epi, splits, stream)
             : launch_tiles<Op, Small, AM, TRANS_B, PAIRED, false>(
                   pr, epi, splits, stream);
}

// One product on the tiles `pick_tile` names; with K split (`product_splits`)
// each split writes its partial into `work` and `sum_splits_kernel` adds
// them in split order and runs the epilogue.
template <class Op, int AM, bool TRANS_B, bool PAIRED, class Epi>
cudaError_t run(const Problem& pr, const Epi& epi, bool vec, float* work,
                cudaStream_t stream) {
  const TileKind t = pick_tile(AM, pr, vec);
  const int splits = splits_of(AM, pr, vec);
  if (splits == 1) {
    return launch_kind<Op, AM, TRANS_B, PAIRED>(t, vec, pr, epi, 1, stream);
  }
  cudaError_t err = launch_kind<Op, AM, TRANS_B, PAIRED>(
      t, vec, pr, PartialOut{work, pr.m, pr.n, pr.half}, splits, stream);
  if (err != cudaSuccess) return err;
  const long long count =
      static_cast<long long>(pr.m) * (PAIRED ? pr.half : pr.n);
  sum_splits_kernel<PAIRED><<<static_cast<unsigned>((count + kSumThreads - 1) /
                                                    kSumThreads),
                              kSumThreads, 0, stream>>>(
      work, pr.m, pr.n, pr.half, splits, epi);
  return cudaGetLastError();
}

cudaError_t drop_scales(const int* seed, float* s, const Geometry& g,
                        uint32_t threshold, float keep_scale,
                        cudaStream_t stream) {
  const int count = g.batch * 2 * g.channels;
  drop_scale_kernel<<<(count + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                      stream>>>(seed, s, count, 2 * g.channels, threshold,
                                keep_scale);
  return cudaGetLastError();
}

// The row ranges of db1's column sums (bf16): kColSplits of them at most,
// none empty.
int col_splits(const Geometry& g, int* per) {
  const int rows = (g.pixels + kColSplits - 1) / kColSplits;
  *per = rows;
  return (g.pixels + rows - 1) / rows;
}

// db1 = the column sums of dh32 (P x C), in a fixed order: the row ranges
// into work, then their sum in range order.
cudaError_t bias_sums(const float* dh32, float* db1, float* work,
                      const Geometry& g, cudaStream_t stream) {
  int per;
  const int splits = col_splits(g, &per);
  const int count = splits * g.channels;
  col_sums_kernel<<<(count + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                    stream>>>(dh32, work, g.pixels, g.channels, per, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_splits_kernel<false><<<(g.channels + kSumThreads - 1) / kSumThreads,
                             kSumThreads, 0, stream>>>(
      work, 1, g.channels, 0, splits, WgradOut{nullptr, db1, 0, g.channels});
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool valid_shape(int batch, int height, int width, int channels) {
  return batch > 0 && height > 0 && width > 0 && channels > 0 &&
         static_cast<long long>(batch) * height * width < kMaxPixels;
}

// The products of the chain: c (m x n) = A B, K = taps kt (kt: C for the
// conv, whose 2C halves pair in each chunk, and dx; 2C for the gate and
// dh; P for the weight gradients).
Problem conv_problem(const Geometry& g, const void* x, const void* w1) {
  return problem(g, x, w1, g.pixels, g.channels, g.channels, 9, 0);
}

Problem gate_problem(const Geometry& g, const void* a, const void* wg) {
  const int c = g.channels;
  return problem(g, a, wg, g.pixels, 2 * c, 2 * c, 1, c);
}

Problem dx_problem(const Geometry& g, const void* dh, const void* w1) {
  const int c = g.channels;
  return problem(g, dh, w1, g.pixels, 2 * c, c, 9, c);
}

Problem dwg_problem(const Geometry& g, const void* h2, const void* dg) {
  const int c = g.channels;
  return problem(g, h2, dg, 2 * c + 1, 2 * c, g.pixels, 1, 0);
}

// float32: db1 from the row of ones under A; bf16: no ones row (db1 sums
// the unrounded dh, `bias_sums`).
Problem dw1_problem(const Geometry& g, const void* x, const void* dh) {
  const int c = g.channels;
  const int ones = g.bf16 ? 0 : 1;
  Problem pr = problem(g, x, dh, 18 * c + ones, c, g.pixels, 1, 0);
  pr.ones = ones;
  return pr;
}

// The products a call runs, (mode, problem) in launch order: the conv and
// the gate; in the backward then dh (the gate's shape), dx, dwg and dw1.
struct Chain {
  std::pair<int, Problem> products[6];
  int count;
};

Chain chain(const Geometry& g, bool backward) {
  const Problem gate = gate_problem(g, nullptr, nullptr);
  Chain ch{{{kAConv, conv_problem(g, nullptr, nullptr)}, {kARows, gate}},
           2};
  if (backward) {
    ch.products[2] = {kARows, gate};
    ch.products[3] = {kADx, dx_problem(g, nullptr, nullptr)};
    ch.products[4] = {kACols, dwg_problem(g, nullptr, nullptr)};
    ch.products[5] = {kAConvT, dw1_problem(g, nullptr, nullptr)};
    ch.count = 6;
  }
  return ch;
}

// Floats of the split products' partials (the most any one product of the
// call needs, and in a bf16 backward db1's row-range sums), and the call's
// device launches: each product, a sum of each one whose K is split, the
// table of dropout scales with a seed, and db1's two launches in bf16.
long long work_floats(const Geometry& g, bool backward, bool vec,
                      bool dropout, int* launches) {
  const Chain ch = chain(g, backward);
  long long need = 0;
  int n = dropout ? 1 : 0;
  for (int i = 0; i < ch.count; ++i) {
    const auto& [am, pr] = ch.products[i];
    const int splits = splits_of(am, pr, vec);
    n += splits > 1 ? 2 : 1;
    if (splits > 1) {
      need = std::max(need, splits * static_cast<long long>(pr.m) * pr.n);
    }
  }
  if (backward && g.bf16) {
    int per;
    need = std::max(need, static_cast<long long>(col_splits(g, &per)) *
                              g.channels);
    n += 2;
  }
  if (launches) *launches = n;
  return need;
}

// Each operand policy's epilogues: the bf16 ones round where the Pallas
// kernels round, and dh also goes unrounded into dh32 (db1's sums).
template <class Op>
struct Epilogues;

template <>
struct Epilogues<OpF32> {
  using Conv = ConvOut;
  using Gate = GateOut;
  using GateG = GateGrad;
  using Dx = DxOut;
  static DhOut dh(const float* s, float* hdh, float*, int c, int hw) {
    return DhOut{s, hdh, c, hw};
  }
};

template <>
struct Epilogues<OpBf16> {
  using Conv = ConvOutBf16;
  using Gate = GateOutBf16;
  using GateG = GateGradBf16;
  using Dx = DxOutBf16;
  static DhOutBf16 dh(const float* s, bf16* hdh, float* dh32, int c, int hw) {
    return DhOutBf16{s, hdh, dh32, c, hw};
  }
};

// out (B, H, W, C) from x and the weights, every tensor of the policy's
// element type E; seed null means no dropout. scratch, scratch_floats 4-byte
// words long: h2 (B H W 2C values of E), the dropout scales (B 2C floats,
// with a seed; in bf16 keep_scale is a bf16 value), then the split
// products' fp32 partials (`gpnf_gated_conv_plan`).
template <class Op>
int gated_conv_forward(const int* seed, const void* x, const void* w1,
                       const void* b1, const void* wg, const void* bg,
                       void* out, float* scratch, int batch, int height,
                       int width, int channels, uint32_t threshold,
                       float keep_scale, long long scratch_floats,
                       void* stream) {
  using E = typename Op::E;
  using Conv = typename Epilogues<Op>::Conv;
  using Gate = typename Epilogues<Op>::Gate;
  if (!valid_shape(batch, height, width, channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{batch, height, width, channels, batch * height * width,
                   sizeof(E) == 2};
  const int c = channels;
  E* h2 = reinterpret_cast<E*>(scratch);
  float* scales = scratch + static_cast<long long>(g.pixels) * 2 * c *
                                sizeof(E) / sizeof(float);
  float* work = scales + (seed ? 2LL * batch * c : 0);
  // the 16-byte copies: C a multiple of 4 floats or 8 bf16 values
  const bool vec = c % (16 / sizeof(E)) == 0 && aligned16(x) &&
                   aligned16(w1) && aligned16(wg) && aligned16(h2);
  if (scratch_floats < (work - scratch) + work_floats(g, false, vec, false,
                                                      nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (!seed) scales = nullptr;
  cudaError_t err = cudaSuccess;
  if (seed) err = drop_scales(seed, scales, g, threshold, keep_scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run<Op, kAConv, false, false>(
      conv_problem(g, x, w1),
      Conv{static_cast<const E*>(b1), scales, nullptr, h2, c, height * width},
      vec, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run<Op, kARows, false, true>(
      gate_problem(g, h2, wg),
      Gate{static_cast<const E*>(bg), static_cast<const E*>(x),
           static_cast<E*>(out), c},
      vec, work, s);
  return static_cast<int>(err);
}

// dx (B, H, W, C) of E, dw1 (3, 3, 2C, C), db1 (C), dwg (2C, 2C), dbg (2C)
// in fp32 (the Pallas `_bwd_kernel`'s outputs) from the forward's inputs
// and the cotangent g, of E. Scratch from the caller: hdh (B, H, W, C of E:
// h, then dh over it, in bf16 bf16(dh)), in bf16 dh32 (B, H, W, C floats:
// the unrounded dh that db1 sums; null in float32), dg and h2 (B, H, W, 2C
// of E), and partial, partial_floats long: the dropout scales (B 2C, with a
// seed), then the split products' partials and in bf16 db1's row-range
// sums (`gpnf_gated_conv_plan`).
template <class Op>
int gated_conv_backward(const int* seed, const void* x, const void* w1,
                        const void* b1, const void* wg, const void* bg,
                        const void* g, void* dx, float* dw1, float* db1,
                        float* dwg, float* dbg, void* hdh, float* dh32,
                        void* dg, void* h2, float* partial, int batch,
                        int height, int width, int channels,
                        uint32_t threshold, float keep_scale,
                        long long partial_floats, void* stream) {
  using E = typename Op::E;
  using Epi = Epilogues<Op>;
  using Conv = typename Epi::Conv;
  using GateG = typename Epi::GateG;
  using Dx = typename Epi::Dx;
  constexpr bool kBf16 = sizeof(E) == 2;
  if (!valid_shape(batch, height, width, channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry geo{batch, height, width, channels, batch * height * width,
                     kBf16};
  const int c = channels, hw = height * width;
  const bool vec = c % (16 / sizeof(E)) == 0 && aligned16(x) &&
                   aligned16(w1) && aligned16(wg) && aligned16(hdh) &&
                   aligned16(dg) && aligned16(h2);
  float* scales = seed ? partial : nullptr;
  float* work = partial + (seed ? 2LL * batch * c : 0);
  if (partial_floats <
      (work - partial) + work_floats(geo, true, vec, false, nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xe = static_cast<const E*>(x);
  const auto* ge = static_cast<const E*>(g);
  auto* he = static_cast<E*>(hdh);
  auto* dge = static_cast<E*>(dg);
  auto* h2e = static_cast<E*>(h2);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (seed) err = drop_scales(seed, scales, geo, threshold, keep_scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1. the conv again: h and h2
  err = run<Op, kAConv, false, false>(
      conv_problem(geo, x, w1),
      Conv{static_cast<const E*>(b1), scales, he, h2e, c, hw}, vec, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 2. the gate again: dG2
  err = run<Op, kARows, false, true>(
      gate_problem(geo, h2, wg),
      GateG{static_cast<const E*>(bg), ge, dge, c}, vec, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 3. dh2 = dG2 wg^T, then dh over h (bf16: bf16(dh), and dh into dh32)
  err = run<Op, kARows, true, true>(gate_problem(geo, dg, wg),
                                    Epi::dh(scales, he, dh32, c, hw), vec,
                                    work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 4. dh1 = the transposed conv of dh, then dx
  err = run<Op, kADx, true, true>(dx_problem(geo, hdh, w1),
                                  Dx{xe, ge, static_cast<E*>(dx), c}, vec,
                                  work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 5. dwg | dbg = [h2 | 1]^T dG2
  err = run<Op, kACols, false, false>(dwg_problem(geo, h2, dg),
                                      WgradOut{dwg, dbg, 2 * c, 2 * c}, vec,
                                      work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 6. dw1 | db1 = [im2col(concat_elu(x)) | 1]^T dh; bf16: dw1 alone
  err = run<Op, kAConvT, false, false>(
      dw1_problem(geo, x, hdh),
      WgradOut{dw1, kBf16 ? nullptr : db1, 18 * c, c}, vec, work, s);
  if constexpr (kBf16) {
    // 7. db1 = the column sums of the unrounded dh
    if (err == cudaSuccess) err = bias_sums(dh32, db1, work, geo, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// The scratch floats (4-byte words) a call takes and the device launches
// it makes, from its shape alone (dropout: a seed is passed; vec: C a
// multiple of 4 (bf16: 8) and x, w1 and wg on 16-byte boundaries; bf16: the
// bf16 entries). The forward's scratch is h2 (B H W 2C values: floats, or
// bf16 in B H W C words), the dropout scales (B 2C floats, with a seed),
// then the split products' partials; the backward's `partial` the scales,
// then the partials (at least one float).
extern "C" int gpnf_gated_conv_plan(int batch, int height, int width,
                                    int channels, int dropout, int vec,
                                    int backward, int bf16,
                                    long long* scratch_floats,
                                    int* launches) {
  if (!valid_shape(batch, height, width, channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{batch, height, width, channels, batch * height * width,
                   bf16 != 0};
  const long long scales = dropout ? 2LL * batch * channels : 0;
  const long long work =
      work_floats(g, backward != 0, vec != 0, dropout != 0, launches);
  const long long h2 = (bf16 ? 1LL : 2LL) * g.pixels * channels;
  *scratch_floats = backward ? std::max(1LL, scales + work)
                             : h2 + scales + work;
  return 0;
}

// The entries: the float32 chain (3xTF32) and the bf16 one (x, the weights,
// out, g and dx bf16 values behind void pointers), as `gated_conv_forward`
// and `gated_conv_backward` describe them.
extern "C" int gpnf_gated_conv_fwd(const int* seed, const float* x,
                                   const float* w1, const float* b1,
                                   const float* wg, const float* bg,
                                   float* out, float* scratch, int batch,
                                   int height, int width, int channels,
                                   uint32_t threshold, float keep_scale,
                                   long long scratch_floats, void* stream) {
  return gated_conv_forward<OpF32>(seed, x, w1, b1, wg, bg, out, scratch,
                                   batch, height, width, channels, threshold,
                                   keep_scale, scratch_floats, stream);
}

extern "C" int gpnf_gated_conv_fwd_bf16(const int* seed, const void* x,
                                        const void* w1, const void* b1,
                                        const void* wg, const void* bg,
                                        void* out, float* scratch, int batch,
                                        int height, int width, int channels,
                                        uint32_t threshold, float keep_scale,
                                        long long scratch_floats,
                                        void* stream) {
  return gated_conv_forward<OpBf16>(seed, x, w1, b1, wg, bg, out, scratch,
                                    batch, height, width, channels, threshold,
                                    keep_scale, scratch_floats, stream);
}

extern "C" int gpnf_gated_conv_bwd(const int* seed, const float* x,
                                   const float* w1, const float* b1,
                                   const float* wg, const float* bg,
                                   const float* g, float* dx, float* dw1,
                                   float* db1, float* dwg, float* dbg,
                                   float* hdh, float* dg, float* h2,
                                   float* partial, int batch, int height,
                                   int width, int channels, uint32_t threshold,
                                   float keep_scale, long long partial_floats,
                                   void* stream) {
  return gated_conv_backward<OpF32>(
      seed, x, w1, b1, wg, bg, g, dx, dw1, db1, dwg, dbg, hdh, nullptr, dg,
      h2, partial, batch, height, width, channels, threshold, keep_scale,
      partial_floats, stream);
}

extern "C" int gpnf_gated_conv_bwd_bf16(
    const int* seed, const void* x, const void* w1, const void* b1,
    const void* wg, const void* bg, const void* g, void* dx, float* dw1,
    float* db1, float* dwg, float* dbg, void* hdh, float* dh32, void* dg,
    void* h2, float* partial, int batch, int height, int width, int channels,
    uint32_t threshold, float keep_scale, long long partial_floats,
    void* stream) {
  return gated_conv_backward<OpBf16>(
      seed, x, w1, b1, wg, bg, g, dx, dw1, db1, dwg, dbg, hdh, dh32, dg, h2,
      partial, batch, height, width, channels, threshold, keep_scale,
      partial_floats, stream);
}
