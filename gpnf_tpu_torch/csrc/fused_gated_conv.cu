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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <utility>

#include "mma_tf32.cuh"
#include "philox.cuh"

namespace {

using gpnf::FragA;
using gpnf::FragB;

constexpr int KC = 32;  // k rows a stage holds; a chunk never crosses a tap
constexpr int kKPad = gpnf::kTilePad;  // floats after each KC-float row
constexpr int kOuterPad = 8;  // floats after each BM- or BN-float row
constexpr int kLargeMinTiles = 128;  // 128 x 128 tiles from this many up
constexpr int kSplitBlocks = 2 * 132;  // the blocks a split product aims at
constexpr int kSplitBelowTiles = 128;  // pixel products split below this
constexpr int kMinSplitChunks = 8;  // chunks a split pixel product sums
constexpr int kSumThreads = 256;
constexpr int kMaxPixels = 1 << 24;  // pixel indices exact in a float

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
constexpr int kAConvT = 4;  // the conv's im2col^T with a row of ones (dw1)

__host__ __device__ constexpr bool trans_a(int mode) { return mode >= kACols; }
__host__ __device__ constexpr bool gathers(int mode) {
  return mode == kAConv || mode == kADx;
}

// The shared memory of one stage: A's tile, then B's.
template <class T, bool TRANS_A, bool TRANS_B>
struct Stage {
  static constexpr int kLda = TRANS_A ? T::BM + kOuterPad : KC + kKPad;
  static constexpr int kLdb = TRANS_B ? KC + kKPad : T::BN + kOuterPad;
  static constexpr int kA = TRANS_A ? KC * kLda : T::BM * kLda;
  static constexpr int kB = TRANS_B ? T::BN * kLdb : KC * kLdb;
  static constexpr int kFloats = kA + kB;
  static constexpr size_t kBytes = sizeof(float) * T::kStages * kFloats;
};

// One product c (m x n) = A B, K = taps x kt summed tap by tap.
struct Problem {
  const float* a;     // x, h2, dG2 or dh (as the A mode reads it)
  const float* b;     // w1, wg, dG2 or dh
  int m, n;           // c's rows and columns (n = 2C where paired)
  int kt, taps;       // K of one tap, and taps (9 for the 3 x 3 gathers)
  int split_chunks;   // chunks of KC a split sums
  int half;           // paired: C, the column that pairs with column 0
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

// The block's place in c: its first row m0 (kAConvT: its tap, its first
// channel pair c0, or the ones row's block), its first column n0 (o0 where
// paired).
struct Block {
  int m0, n0, tap, c0;
  bool ones;
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
template <class T, int AM, bool VEC>
__device__ __forceinline__ void load_a(float* as, const Problem& pr,
                                       const Block& blk, int tap, int k0,
                                       const int4* rows_s) {
  using S = Stage<T, trans_a(AM), false>;
  constexpr int kPer = VEC ? 4 : 1;
  if constexpr (!trans_a(AM)) {  // BM rows of KC (kAConv: KC / 2 copied)
    constexpr int kRow = (AM == kAConv ? KC / 2 : KC) / kPer;
    static_assert((T::BM * kRow) % T::kThreads == 0, "whole copies");
#pragma unroll
    for (int it = 0; it < T::BM * kRow / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      const int r = e / kRow;
      const int cc = kPer * (e - r * kRow);
      const int k = k0 + cc;
      bool valid;
      const float* src;
      if constexpr (AM == kARows) {
        valid = blk.m0 + r < pr.m && k < pr.kt;
        src = pr.a + static_cast<long long>(blk.m0 + r) * pr.kt + k;
      } else {
        const int4 g = rows_s[r];
        const int2 d = tap_offset<AM == kADx>(tap);
        const int y = g.y + d.x, x = g.z + d.y;
        valid = k < pr.kt && y >= 0 && y < pr.height && x >= 0 &&
                x < pr.width;
        src = pr.a +
              static_cast<long long>(g.x + d.x * pr.width + d.y) *
                  pr.channels + k;
      }
      copy<VEC>(as + r * S::kLda + cc, valid ? src : pr.a, valid);
    }
  } else {  // KC rows (k = pixels) of BM (m)
    constexpr int kCols = AM == kAConvT ? T::BM / 2 : T::BM;
    constexpr int kRow = kCols / kPer;
    static_assert((KC * kRow) % T::kThreads == 0, "whole copies");
    const int rows = pr.m - 1;  // the row of ones
#pragma unroll
    for (int it = 0; it < KC * kRow / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      const int kk = e / kRow;
      const int cc = kPer * (e - kk * kRow);
      const int k = k0 + kk;
      float* dst = as + kk * S::kLda + cc;
      if constexpr (AM == kACols) {
        const int mcol = blk.m0 + cc;
        if (mcol < rows) {  // all kPer columns are data (C % 4 == 0 for VEC)
          const bool valid = k < pr.kt;
          const float* src = pr.a + static_cast<long long>(k) * rows + mcol;
          copy<VEC>(dst, valid ? src : pr.a, valid);
        } else {  // the ones row (the bias gradient), zeros past it
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            dst[q] = (mcol + q == rows && k < pr.kt) ? 1.f : 0.f;
          }
        }
      } else if (blk.ones) {  // the ones row is the block's row 0
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          dst[q] = (cc + q == 0 && k < pr.kt) ? 1.f : 0.f;
          dst[q + kCols] = 0.f;
        }
      } else {
        const int ch = blk.c0 + cc;
        bool valid = k < pr.kt && ch < pr.channels;
        const int2 yx = pixel_yx(valid ? k : 0, pr);
        const int2 d = tap_offset<false>(blk.tap);
        const int y = yx.x + d.x, x = yx.y + d.y;
        valid = valid && y >= 0 && y < pr.height && x >= 0 && x < pr.width;
        const float* src =
            pr.a + static_cast<long long>(k + d.x * pr.width + d.y) *
                       pr.channels + ch;
        copy<VEC>(dst, valid ? src : pr.a, valid);
      }
    }
  }
}

// concat_elu of this thread's own copies, in place: a staged v becomes
// elu(v), and elu(-v) goes HALF columns on (one expf for the two: one of
// them is v or -v). Zeros (outside the image, past C) give zeros.
template <int HALF>
__device__ __forceinline__ void concat_elu_at(float* at) {
  const float v = *at;
  const float e = expf(-fabsf(v)) - 1.f;
  at[0] = v > 0.f ? v : e;
  at[HALF] = v < 0.f ? -v : e;
}

template <class T, int AM, bool VEC>
__device__ __forceinline__ void elu_a(float* as, const Block& blk) {
  using S = Stage<T, trans_a(AM), false>;
  constexpr int kPer = VEC ? 4 : 1;
  if constexpr (AM == kAConv) {
    constexpr int kRow = KC / 2 / kPer;
#pragma unroll
    for (int it = 0; it < T::BM * kRow / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      const int r = e / kRow;
      const int cc = kPer * (e - r * kRow);
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        concat_elu_at<KC / 2>(as + r * S::kLda + cc + q);
      }
    }
  } else if constexpr (AM == kAConvT) {
    constexpr int kRow = T::BM / 2 / kPer;
    if (blk.ones) return;
#pragma unroll
    for (int it = 0; it < KC * kRow / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
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
template <class T, bool TRANS_B, bool PAIRED, bool KPAIR, bool VEC>
__device__ __forceinline__ void load_b(float* bs, const Problem& pr, int n0,
                                       int tap, int k0) {
  using S = Stage<T, false, TRANS_B>;
  constexpr int kPer = VEC ? 4 : 1;
  constexpr int HB = T::BN / 2;
  if constexpr (!TRANS_B) {
    constexpr int kRow = T::BN / kPer;
    static_assert((KC * kRow) % T::kThreads == 0, "whole copies");
#pragma unroll
    for (int it = 0; it < KC * kRow / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
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
      const float* src = pr.b + row * pr.n + col;
      copy<VEC>(bs + kk * S::kLdb + nl, ok ? src : pr.b, ok);
    }
  } else {
    constexpr int kRow = KC / kPer;
    static_assert((T::BN * kRow) % T::kThreads == 0, "whole copies");
#pragma unroll
    for (int it = 0; it < T::BN * kRow / T::kThreads; ++it) {
      const int e = threadIdx.x + it * T::kThreads;
      const int r = e / kRow;
      const int cc = kPer * (e - r * kRow);
      bool ok;
      const int col = column<PAIRED, HB>(pr, n0, r, ok);
      const bool valid = ok && k0 + cc < pr.kt;
      const float* src =
          pr.b + (static_cast<long long>(tap) * pr.n + col) * pr.kt + k0 + cc;
      copy<VEC>(bs + r * S::kLdb + cc, valid ? src : pr.b, valid);
    }
  }
}

// Split z = blockIdx.z of c = A B over the chunks [z split_chunks, ...),
// then epi on every entry of the tile: epi(row, o, c[o], c[half + o]) where
// PAIRED, else epi(row, col, c[col]).
template <class T, int AM, bool TRANS_B, bool PAIRED, bool VEC, class Epi>
__global__ void __launch_bounds__(T::kThreads)
    gated_conv_mma_kernel(const Problem pr, const Epi epi) {
  constexpr bool TRANS_A = trans_a(AM);
  using S = Stage<T, TRANS_A, TRANS_B>;
  constexpr int MI = T::MI, NI = T::NI, HB = T::BN / 2, HM = T::BM / 2;
  constexpr int KSTEP = AM == kAConv ? KC / 2 : KC;  // channels a chunk
  static_assert(NI % 2 == 0, "fragments j and j + NI / 2 pair");
  extern __shared__ float4 gconv_smem[];
  float* smem = reinterpret_cast<float*>(gconv_smem);
  int4* rows_s = reinterpret_cast<int4*>(smem + T::kStages * S::kFloats);
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
    float* as = smem + stage * S::kFloats;
    const int tap = c / cpt;
    const int k0 = (c - tap * cpt) * KSTEP;
    load_a<T, AM, VEC>(as, pr, blk, tap, k0, rows_s);
    load_b<T, TRANS_B, PAIRED, AM == kAConv, VEC>(as + S::kA, pr, blk.n0,
                                                  tap, k0);
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
    float* as = smem + (t % T::kStages) * S::kFloats;
    elu_a<T, AM, VEC>(as, blk);
    __syncthreads();  // chunk t is in; every warp is done with chunk t - 1
    const int ahead = t + T::kStages - 1;  // into the stage chunk t - 1 held
    if (ahead < nk) load_stage(ahead % T::kStages, c_begin + ahead);
    gpnf::cp_async_commit();
    const float* bs = as + S::kA;
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      FragB fb[NI];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int nl = (j < NI / 2 ? 0 : HB) + wn + 8 * (j % (NI / 2)) + gr;
        fb[j] = TRANS_B ? gpnf::tile_frag_bt<KC>(bs, nl, kk + tg)
                        : gpnf::frag_b_kmajor<S::kLdb>(bs, kk + tg, nl);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int row = wm + 16 * i + gr;
        const FragA fa = TRANS_A
                             ? gpnf::frag_a_kmajor<S::kLda>(as, kk + tg, row)
                             : gpnf::tile_frag_a<KC>(as, row, kk + tg);
#pragma unroll
        for (int j = 0; j < NI; ++j) gpnf::mma_3xtf32(part[i][j], fa, fb[j]);
      }
    }
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

// -- launches -----------------------------------------------------------------
struct Geometry {
  int batch, height, width, channels, pixels;
};

// The product c (m x n) = A B, K = taps kt: kt is C for the conv (its 2C
// halves pair in each chunk) and dx, 2C for the gate and dh, P for the
// weight gradients.
Problem problem(const Geometry& g, const float* a, const float* b, int m,
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
// channel pairs, and one for the ones row.
long long m_blocks(int am, int m, int c, int bm) {
  return am == kAConvT ? 9LL * ((c + bm / 2 - 1) / (bm / 2)) + 1
                       : (m + bm - 1) / bm;
}

// The tiles of a product, from its shape alone: 128 x 128 where those tiles cover the
// output with no ragged edge (dw1: whole channel pairs) and make
// kLargeMinTiles blocks; else, for unpaired columns in (64, 128], one
// block's worth of them, 64 x 96 up to 96 (the conv and dw1 at C = 96) and
// 64 x 128 above (A, which carries the gather and the ELU, staged once a
// row of blocks); else 64 x 64. On the 4-byte path 64 x 64.
TileKind pick_tile(int am, bool paired, int m, int n, int c, bool vec) {
  if (!vec) return kSmall;
  const bool even = am == kAConvT ? c % (Large::BM / 2) == 0
                                  : m % Large::BM == 0;
  if (am != kACols && even && n % Large::BN == 0 &&
      m_blocks(am, m, c, Large::BM) * (n / Large::BN) >= kLargeMinTiles) {
    return kLarge;
  }
  if (!paired && n > Small::BN && n <= Mid::BN) return kMid;
  if (!paired && n > Mid::BN && n <= Wide::BN) return kWide;
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
      m_blocks(am, pr.m, pr.channels, tile_rows(t)) *
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
  return product_splits(
      am, pr, pick_tile(am, pr.half != 0, pr.m, pr.n, pr.channels, vec));
}

template <class T, int AM, bool TRANS_B, bool PAIRED, bool VEC, class Epi>
cudaError_t launch_tiles(Problem pr, const Epi& epi, int splits,
                         cudaStream_t stream) {
  using S = Stage<T, trans_a(AM), TRANS_B>;
  const int kstep = AM == kAConv ? KC / 2 : KC;
  const int chunks = pr.taps * ((pr.kt + kstep - 1) / kstep);
  pr.split_chunks = (chunks + splits - 1) / splits;
  const size_t bytes = S::kBytes + (gathers(AM) ? T::BM * sizeof(int4) : 0);
  const auto kernel = gated_conv_mma_kernel<T, AM, TRANS_B, PAIRED, VEC, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int cols = PAIRED ? (pr.half + T::BN / 2 - 1) / (T::BN / 2)
                          : (pr.n + T::BN - 1) / T::BN;
  const dim3 grid(static_cast<unsigned>(
                      m_blocks(AM, pr.m, pr.channels, T::BM)),
                  cols, splits);
  kernel<<<grid, T::kThreads, bytes, stream>>>(pr, epi);
  return cudaGetLastError();
}

template <int AM, bool TRANS_B, bool PAIRED, class Epi>
cudaError_t launch_kind(TileKind t, bool vec, const Problem& pr,
                        const Epi& epi, int splits, cudaStream_t stream) {
  if constexpr (AM != kACols) {
    if (t == kLarge) {
      return launch_tiles<Large, AM, TRANS_B, PAIRED, true>(pr, epi, splits,
                                                            stream);
    }
  }
  if constexpr (!PAIRED) {
    if (t == kWide) {
      return launch_tiles<Wide, AM, TRANS_B, PAIRED, true>(pr, epi, splits,
                                                           stream);
    }
    if (t == kMid) {
      return launch_tiles<Mid, AM, TRANS_B, PAIRED, true>(pr, epi, splits,
                                                          stream);
    }
  }
  return vec ? launch_tiles<Small, AM, TRANS_B, PAIRED, true>(pr, epi, splits,
                                                              stream)
             : launch_tiles<Small, AM, TRANS_B, PAIRED, false>(pr, epi, splits,
                                                               stream);
}

// One product on the tiles `pick_tile` names; with K split (`product_splits`)
// each split writes its partial into `work` and `sum_splits_kernel` adds
// them in split order and runs the epilogue.
template <int AM, bool TRANS_B, bool PAIRED, class Epi>
cudaError_t run(const Problem& pr, const Epi& epi, bool vec, float* work,
                cudaStream_t stream) {
  const TileKind t = pick_tile(AM, PAIRED, pr.m, pr.n, pr.channels, vec);
  const int splits = splits_of(AM, pr, vec);
  if (splits == 1) {
    return launch_kind<AM, TRANS_B, PAIRED>(t, vec, pr, epi, 1, stream);
  }
  cudaError_t err = launch_kind<AM, TRANS_B, PAIRED>(
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
Problem conv_problem(const Geometry& g, const float* x, const float* w1) {
  return problem(g, x, w1, g.pixels, g.channels, g.channels, 9, 0);
}

Problem gate_problem(const Geometry& g, const float* a, const float* wg) {
  const int c = g.channels;
  return problem(g, a, wg, g.pixels, 2 * c, 2 * c, 1, c);
}

Problem dx_problem(const Geometry& g, const float* dh, const float* w1) {
  const int c = g.channels;
  return problem(g, dh, w1, g.pixels, 2 * c, c, 9, c);
}

Problem dwg_problem(const Geometry& g, const float* h2, const float* dg) {
  const int c = g.channels;
  return problem(g, h2, dg, 2 * c + 1, 2 * c, g.pixels, 1, 0);
}

Problem dw1_problem(const Geometry& g, const float* x, const float* dh) {
  const int c = g.channels;
  return problem(g, x, dh, 18 * c + 1, c, g.pixels, 1, 0);
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
// call needs), and the call's device launches: each product, a sum of each
// one whose K is split, and the table of dropout scales with a seed.
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
  if (launches) *launches = n;
  return need;
}

}  // namespace

// The scratch floats a call takes and the device launches it makes, from
// its shape alone (dropout: a seed is passed; vec: C a multiple of 4 and
// x, w1 and wg on 16-byte boundaries). The forward's scratch is h2 (B H W
// 2C floats), the dropout scales (B 2C, with a seed), then the split
// products' partials; the backward's `partial` the scales, then the
// partials (at least one float).
extern "C" int gpnf_gated_conv_plan(int batch, int height, int width,
                                    int channels, int dropout, int vec,
                                    int backward, long long* scratch_floats,
                                    int* launches) {
  if (!valid_shape(batch, height, width, channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{batch, height, width, channels, batch * height * width};
  const long long scales = dropout ? 2LL * batch * channels : 0;
  const long long work =
      work_floats(g, backward != 0, vec != 0, dropout != 0, launches);
  *scratch_floats = backward ? std::max(1LL, scales + work)
                             : 2LL * g.pixels * channels + scales + work;
  return 0;
}

// out (B, H, W, C) from x and the weights; seed null means no dropout.
// scratch, scratch_floats long: h2 (B H W 2C floats), the dropout scales
// (B 2C, with a seed), then the split products' partials
// (`gpnf_gated_conv_plan`).
extern "C" int gpnf_gated_conv_fwd(const int* seed, const float* x,
                                   const float* w1, const float* b1,
                                   const float* wg, const float* bg,
                                   float* out, float* scratch, int batch,
                                   int height, int width, int channels,
                                   uint32_t threshold, float keep_scale,
                                   long long scratch_floats, void* stream) {
  if (!valid_shape(batch, height, width, channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{batch, height, width, channels, batch * height * width};
  const int c = channels;
  float* h2 = scratch;
  float* scales = scratch + static_cast<long long>(g.pixels) * 2 * c;
  float* work = scales + (seed ? 2LL * batch * c : 0);
  const bool vec = c % 4 == 0 && aligned16(x) && aligned16(w1) &&
                   aligned16(wg) && aligned16(h2);
  if (scratch_floats < (work - scratch) + work_floats(g, false, vec, false,
                                                      nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (!seed) scales = nullptr;
  cudaError_t err = cudaSuccess;
  if (seed) err = drop_scales(seed, scales, g, threshold, keep_scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run<kAConv, false, false>(
      conv_problem(g, x, w1),
      ConvOut{b1, scales, nullptr, h2, c, height * width}, vec, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run<kARows, false, true>(gate_problem(g, h2, wg),
                                 GateOut{bg, x, out, c}, vec, work, s);
  return static_cast<int>(err);
}

// dx (B, H, W, C), dw1 (3, 3, 2C, C), db1 (C), dwg (2C, 2C), dbg (2C) from
// the forward's inputs and the cotangent g. Scratch from the caller: hdh
// (B, H, W, C: h, then dh over it), dg and h2 (B, H, W, 2C), and partial,
// partial_floats long: the dropout scales (B 2C, with a seed), then the
// split products' partials (`gpnf_gated_conv_plan`).
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
  if (!valid_shape(batch, height, width, channels)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry geo{batch, height, width, channels, batch * height * width};
  const int c = channels, hw = height * width;
  const bool vec = c % 4 == 0 && aligned16(x) && aligned16(w1) &&
                   aligned16(wg) && aligned16(hdh) && aligned16(dg) &&
                   aligned16(h2);
  float* scales = seed ? partial : nullptr;
  float* work = partial + (seed ? 2LL * batch * c : 0);
  if (partial_floats <
      (work - partial) + work_floats(geo, true, vec, false, nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (seed) err = drop_scales(seed, scales, geo, threshold, keep_scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1. the conv again: h and h2
  err = run<kAConv, false, false>(conv_problem(geo, x, w1),
                                  ConvOut{b1, scales, hdh, h2, c, hw}, vec,
                                  work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 2. the gate again: dG2
  err = run<kARows, false, true>(gate_problem(geo, h2, wg),
                                 GateGrad{bg, g, dg, c}, vec, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 3. dh2 = dG2 wg^T, then dh over h
  err = run<kARows, true, true>(gate_problem(geo, dg, wg),
                                DhOut{scales, hdh, c, hw}, vec, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 4. dh1 = the transposed conv of dh, then dx
  err = run<kADx, true, true>(dx_problem(geo, hdh, w1), DxOut{x, g, dx, c},
                              vec, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 5. dwg | dbg = [h2 | 1]^T dG2
  err = run<kACols, false, false>(dwg_problem(geo, h2, dg),
                                  WgradOut{dwg, dbg, 2 * c, 2 * c}, vec, work,
                                  s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 6. dw1 | db1 = [im2col(concat_elu(x)) | 1]^T dh
  err = run<kAConvT, false, false>(dw1_problem(geo, x, hdh),
                                   WgradOut{dw1, db1, 18 * c, c}, vec, work,
                                   s);
  return static_cast<int>(err);
}
