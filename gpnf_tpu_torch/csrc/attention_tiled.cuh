// Key-tiled multi-head attention: the forward with in-kernel dropout and
// the backward's two kernels, shared by fused_attention_long.cu (packed
// qkv) and fused_attention.cu (separate q, k, v, or packed qkv), both at
// S <= (2^31 - 1) / 3. One template of device code serves every entry; a
// layout says where head (b, h) of each operand starts and how far apart
// its rows are.
//
// For every batch row b and head h, with q, k, v the head's (S, Dh) rows:
//   P = softmax((q_scale q) k^T);  Pd = keep * P / (1 - rate);  out = Pd v
// q_scale is Dh^-1/2 where the caller hands q unscaled (the packed entries:
// q is scaled as it is loaded) and 1 where q comes scaled (the separate
// entry). The keep bit of score (b, h, i, j) is word (j & 3) of Philox at
// counter (j >> 2, i, h, b) (philox.cuh), a pure function of (seed, b, h,
// i, j), so at one seed every attention entry drops the same scores, and
// the backward regenerates the forward's mask.
//
// Backward, with g = d out:
//   dV = Pd^T g;  dPd = g V^T;  dP = keep * dPd / (1 - rate)
//   dS = P * (dP - D),  D_i = sum_j dP_ij P_ij
//   dq = dS K * q_scale;  dK = dS^T (q_scale q)
//
// Design. The Pallas kernels hold one head's (S, S) fp32 scores (4 MB at
// S=1024), and a head's K and V whole (2*S*Dh*4 B, 256 KB at S=512, Dh=64)
// exceed a 227 KB block. So the key axis is tiled, and shared memory does not
// grow with S. Every kernel, at every width (4 to 256), runs its S x S x Dh
// products on the tensor cores: 16-row tiles of a warp, 3xTF32 mma.sync at
// about fp32 accuracy (mma_tf32.cuh), cp.async double buffers.
//   - forward: a block per (64 queries, head, batch row); K and V stream in
//     key tiles, the online softmax (the denominator sums every exp(s - m);
//     the output adds only the kept terms, scaled) runs on the score
//     fragments in registers, and each tile's Pd V is added in fp32;
//   - backward: two kernels. Kernel 1 (dq) runs pass A over the key tiles
//     for m_i, l_i and D_i online (D rescales like the denominator), then
//     pass B for dq_i = sum_j p_ij (dP_ij - D_i) k_j, written times q_scale,
//     with (m_i, 1/l_i, D_i) into a (B, H, S, 3) scratch; kernel 2 (dK/dV)
//     streams query tiles of q, g and the stats past a block's keys and
//     accumulates dV_j and dK_j.
//   No atomics: each output element is written once, and sums run in a
//   fixed order, so every kernel repeats bit for bit. The packed layout
//   reads qkv and writes out or dqkv in place, with no head split or merge
//   copies. What bounds them on the H100: the S x S x Dh products (two
//   forward, five backward) at 3xTF32's rate (495 / 3 TFLOP/s) and ~5
//   operations a score. The forward: >= ~13 us at the CLIs' default C =
//   512, B = 16, S = 256 (Dh 128), ~10 us at the flagship's level 0 (C =
//   96, B = 64, S = 256, Dh 24) and ~164 us at the 64-px level 0 (S =
//   1024); the backward ~33, ~25 and ~400 us; the bytes 5-50 us.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "philox.cuh"

namespace gpnf {

// qkv (B, S, 3C) packed [k | v | q] along the channels, out and g (B, S, C),
// dqkv (B, S, 3C) packed as qkv. q, k, v (and dq, dk, dv) point at the
// first element of their third: qkv + 2C, qkv, qkv + C.
template <int D>
struct PackedQkv {
  static constexpr int kHeadDim = D;
  int seq_len, heads;
  __device__ size_t in_head(int b, int h) const {
    return static_cast<size_t>(b) * seq_len * 3 * heads * D + h * D;
  }
  __device__ size_t in_row() const { return 3 * static_cast<size_t>(heads) * D; }
  __device__ size_t out_head(int b, int h) const {
    return static_cast<size_t>(b) * seq_len * heads * D + h * D;
  }
  __device__ size_t out_row() const { return static_cast<size_t>(heads) * D; }
};

// q, k, v, out, g and dq, dk, dv: separate (B, H, S, Dh) tensors.
template <int D>
struct SplitHeads {
  static constexpr int kHeadDim = D;
  int seq_len, heads;
  __device__ size_t in_head(int b, int h) const {
    return (static_cast<size_t>(b) * heads + h) * seq_len * D;
  }
  __device__ size_t in_row() const { return D; }
  __device__ size_t out_head(int b, int h) const { return in_head(b, h); }
  __device__ size_t out_row() const { return D; }
};

// -- operands of the tensor-core backward: float32, or bf16 widened ----------
// The dq and dK/dV kernels below take float32 operands (every entry) or bf16
// ones (`fused_attention_bwd` on bf16: `_bwd_kernel`'s recipe, every product
// in float32 from the widened operands, only dq, dk and dv rounded). A bf16
// tile stays bf16 in shared memory (cp.async moves 16-byte chunks, so Dh is a
// multiple of 8: the wrapper pads Dh 4 to 8), in rows of `tile_ld` values, W
// rounded down to 16 plus 8, an odd multiple of 8: a fragment read as A or
// B^T touches words (LD / 2) gr + tg / 2 + const, LD / 2 an odd multiple of
// 4, and one read as B words LD tg + gr / 2 + const, 16 distinct banks
// either way, the two lanes of a word sharing it: no conflicts. A widened
// value is its bf16 bits shifted up by 16, exact in TF32 (8 significant bits
// of its 11), so its split has lo = 0, and a product drops the passes that
// lo would feed: q K^T and g V^T (both operands widened) take one TF32 pass,
// hi hi; dS K, Pd^T g and dS^T q (a float32 intermediate by a widened
// operand) two, lo hi then hi hi, where float32 operands take three. The
// sums are 3xTF32's, less terms that are zero.
template <class In, int W>
__host__ __device__ constexpr int tile_ld() {
  return std::is_same<In, bf16>::value ? W / 16 * 16 + 8 : W + kTilePad;
}

struct FragAHi {
  uint32_t hi[4];
};
struct FragBHi {
  uint32_t hi[2];
};

__device__ __forceinline__ uint32_t widened(bf16 x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(x)) << 16;
}

// `tile_frag_a`, `tile_frag_bt` and `tile_frag_b` of mma_tf32.cuh on a bf16
// tile: the same elements, widened.
template <int W>
__device__ __forceinline__ FragAHi tile_frag_a(const bf16* tile, int r,
                                               int c) {
  constexpr int LD = tile_ld<bf16, W>();
  return {{widened(tile[r * LD + c]), widened(tile[(r + 8) * LD + c]),
           widened(tile[r * LD + c + 4]),
           widened(tile[(r + 8) * LD + c + 4])}};
}

template <int W>
__device__ __forceinline__ FragBHi tile_frag_bt(const bf16* tile, int r,
                                                int c) {
  constexpr int LD = tile_ld<bf16, W>();
  return {{widened(tile[r * LD + c]), widened(tile[r * LD + c + 4])}};
}

template <int W>
__device__ __forceinline__ FragBHi tile_frag_b(const bf16* tile, int r,
                                               int c) {
  constexpr int LD = tile_ld<bf16, W>();
  return {{widened(tile[r * LD + c]), widened(tile[(r + 1) * LD + c])}};
}

// d += a b in the TF32 passes the operands' splits need.
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a,
                                          const FragB& b) {
  mma_3xtf32(d, a, b);
}

__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a,
                                          const FragBHi& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.hi);
}

__device__ __forceinline__ void mma_split(float (&d)[4], const FragAHi& a,
                                          const FragBHi& b) {
  mma_tf32(d, a.hi, b.hi);
}

// `load_rows_async` into a bf16 tile of `tile_ld` rows.
template <int W, int ROWS, int TW = W>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                int r0, int seq_len,
                                                size_t stride, int threads) {
  load_rows_bf16<W, ROWS, tile_ld<bf16, TW>()>(dst, src, r0, seq_len, stride,
                                               threads);
}

// Two neighbouring outputs, float32 or rounded to bf16.
__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

__device__ __forceinline__ void store_pair(bf16* dst, float x, float y) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x, y);
}

// -- the tensor-core kernels ---------------------------------------------------
// Every S x S x Dh product runs on the tensor cores in 3xTF32
// (mma_tf32.cuh), and the streamed tiles are copied by cp.async into a
// double buffer, so the next tile loads while the current one computes.
// Tiles are padded rows of W + 4 floats, W = kWidth: Dh, or 8 at Dh = 4
// (one k step of m16n8k8). There the columns past Dh are zeroed once, never
// copied and never stored, so they add nothing to any product. The forward
// is described above its kernel.
//
// dq kernel: a block per (kRows queries, head, batch row), a warp per 16
// query rows. The block's q and g rows sit in shared memory; K and V stream
// in tiles of kKeys keys. For each tile the warp computes S = q K^T and
// dPd = g V^T into register accumulators (a thread holds columns 2 tg,
// 2 tg + 1 of rows gr and gr + 8). Pass A keeps the online (m, l, D) of each
// row: a thread sums its own columns, the row max is reduced across the 4
// lanes of a quad, and at the end of the pass the quad adds its 4 partial
// sums in one order. Pass B forms dS = P (dP - D) in the accumulators, which
// are the A fragments of dq += dS K as they stand (the k order of
// mma_tf32.cuh), and writes dq * q_scale and (m, 1/l, D). The keep bits of
// a thread's two columns of one row are words of one Philox call: the
// lanes with tg even call it for row gr, the odd ones for row gr + 8, and a
// pair trades the two words the other needs by shuffle
// (fragment_keep_words, which the forward calls too).
//
// dK/dV kernel: a block per (kKeys keys, head, batch row); a pair of warps
// per 16 keys, whose K and V rows sit in shared memory. Query tiles of q, g
// and the stats stream by cp.async. For each tile the even warp computes
// S^T = K q^T, the odd one dPd^T = V g^T (16 keys x kQueries queries each,
// the k steps alternating between two accumulator sets; an odd last step,
// Dh = 8 and 24, has no partner); both go to the pair's shared exchange
// tiles; the pair's 64 threads turn them into Pd and dS, one Philox call
// for 4 keys of one query (the words of every other kernel); then the even
// warp accumulates dV += Pd^T g and the odd one dK += dS^T q in registers
// (W / 2 floats a thread). Two named barriers a tile order the pair; one
// __syncthreads a tile orders the buffer. Queries past S take P = 0, so
// they add nothing to dK or dV.
//
// q comes unscaled from the caller and is copied as it is: scores are
// scaled by q_scale after the product, dK and dq before the store. Sums run
// in a fixed order (k steps, then tiles, then the quad's butterfly), and
// each output element is written once: two calls give the same bits.
//
// Tiles by width (kKeys of dq, kQueries of dK/dV): 64 and 64 up to Dh 24,
// 32 and 32 at 32-64, 16 and 32 at 128, 16 and 16 at 256. Shared memory a
// block (4 warps, 128 threads, each kernel), dq / dK/dV: 18 / 35 KB at Dh
// 4 and 8, 30 / 45 at 16, 42 / 55 at 24, 36 / 38 at 32, 52 / 50 at 48, 68
// / 62 at 64, 99 / 110 at 128, 195 / 136 at 256. Registers (ptxas,
// sm_90a, without / with dropout), dq, then dK/dV: Dh 4 115 / 130, 48 /
// 48; 8 117 / 134, 56 / 61; 16 125 / 128, 96 / 95; 24 128 / 132, 127 /
// 120; 32 117 / 128, 123 / 94; 48 127 / 128, 96 / 93; 64 127 / 128, 124 /
// 124; 128 154 / 155, 159 / 157; 256 218 / 228, 212 / 214. No spills but
// 8 bytes in dq at Dh 16 with dropout. Chosen on the card by
// bench_attention --kernel lanes_bwd (Dh 128, 256) and --kernel rows_bwd
// (Dh <= 64; NVIDIA H100 80GB HBM3, 700 W, rate 0): unrolling dq's k loop
// by 8 took up to 23% off the call against 4 at Dh 128 (2: slower; full:
// slower at Dh 256); 32-key tiles at Dh 128, two warps a dq block, 8-key
// tiles at Dh 256, even / odd accumulators in dq and 16-query tiles in
// dK/dV were no faster there. At Dh 24, B 64, S 256 / 64 / 16 / 1024,
// 64-key dq tiles against 32 and 16: 0.2177 / 0.0276 / 0.0177 / 3.06 ms,
// 0.2282 / 0.0281 / 0.0154 / 3.20, 0.2511 / 0.0308 / 0.0142 / 3.51;
// 64-query dK/dV tiles against 32: 0.2240 / 0.0278 / 0.0168 / 3.13 and
// the same 0.2282 / 0.0281 / 0.0154 / 3.20 (both 64, in another call:
// 0.2123 / 0.0268 / 0.0191 / 2.97); the same held at Dh 8 and 4, while at
// Dh 48 64-query tiles were 6% slower and 64-key ones level. At Dh <= 8
// 128-query tiles were 9-20% slower and 128-key ones 1-5% (they spill);
// two or four sets of dq's and dV's sums (more products in flight) 1-2%
// slower. So S 16 runs ~24%
// slower than it would in 32-wide tiles, for 5-7% off the larger S (one
// set of tiles a width: two would double the instantiations). At Dh 4 the
// thread-a-row kernels these replace took 0.1200 ms against 0.1204 at
// rate 0 (0.3%) and 0.1897 against 0.1752 at rate 0.2, the training rate:
// every width runs these kernels.
template <int DH>
struct MmaDq {
  static constexpr int kWidth = DH < 8 ? 8 : DH;  // a tile row's values
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // queries a block
  static constexpr int kKeys = DH <= 24 ? 64 : DH <= 64 ? 32 : 16;  // a tile
  // the shared memory of a block whose tiles hold operands of type In
  template <class In>
  __host__ __device__ static constexpr size_t bytes() {
    return sizeof(In) * (2 * kRows + 2 * 2 * kKeys) * tile_ld<In, kWidth>();
  }
};

template <int DH>
struct MmaDkv {
  static constexpr int kWidth = DH < 8 ? 8 : DH;  // a tile row's values
  static constexpr int kPairs = 2;
  static constexpr int kThreads = 64 * kPairs;
  static constexpr int kKeys = 16 * kPairs;  // keys a block
  // queries a tile
  static constexpr int kQueries = DH <= 24 ? 64 : DH <= 128 ? 32 : 16;
  static constexpr int kPad = kQueries + 8;  // an exchange row, in floats
  // K, V and the two stages of q and g, of operand type In; then the
  // stages' stats and the pairs' float exchange tiles
  template <class In>
  __host__ __device__ static constexpr size_t tile_bytes() {
    return sizeof(In) * 2 * (kKeys + 2 * kQueries) * tile_ld<In, kWidth>();
  }
  template <class In>
  __host__ __device__ static constexpr size_t bytes() {
    return tile_bytes<In>() +
           sizeof(float) * (2 * 3 * kQueries + kPairs * 2 * 16 * kPad);
  }
};

// Zero the `floats` floats of dynamic shared memory at smem, then sync: the
// pad columns of tiles wider than Dh stay zero, as no copy writes them.
__device__ __forceinline__ void zero_shared(float* smem, int floats) {
  for (int e = threadIdx.x; e < floats; e += blockDim.x) smem[e] = 0.f;
  __syncthreads();
}

// The 64 threads of warp pair `pair` wait for each other: named barrier
// pair + 1 (0 is __syncthreads'), each id a constant, so ptxas reserves
// only those.
template <int ID>
__device__ __forceinline__ void named_barrier_64() {
  asm volatile("bar.sync %0, 64;" ::"n"(ID) : "memory");
}

template <int PAIRS>
__device__ __forceinline__ void pair_sync(int pair) {
  static_assert(PAIRS <= 2, "one named barrier a pair: add a case");
  if (pair == 0) {
    named_barrier_64<1>();
  } else {
    named_barrier_64<2>();
  }
}

// The Philox words of the keep bits of the four scores a thread holds in
// the C fragment of rows row0 .. row0 + 15 and keys j .. j + 7 (j a
// multiple of 4): bits[0], bits[1] of row row0 + gr, bits[2], bits[3] of
// row row0 + gr + 8, keys j + 2 tg and j + 2 tg + 1. One Philox call a
// lane: the lanes with tg even call it for row gr, the odd ones for row gr
// + 8, and a pair trades the two words the other needs by shuffle. Every
// lane of the warp calls it.
__device__ __forceinline__ void fragment_keep_words(uint32_t (&bits)[4],
                                                    uint32_t seed, int b,
                                                    int h, int row0, int j,
                                                    int lane) {
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const bool odd = tg & 1;
  const uint4 r = attention_dropout_bits(seed, b, h, row0 + gr + (odd ? 8 : 0),
                                         j / 4 + (tg >> 1));
  const uint32_t own0 = odd ? r.z : r.x, own1 = odd ? r.w : r.y;
  const uint32_t got0 = __shfl_xor_sync(0xffffffffu, odd ? r.x : r.z, 1);
  const uint32_t got1 = __shfl_xor_sync(0xffffffffu, odd ? r.y : r.w, 1);
  bits[0] = odd ? got0 : own0;
  bits[1] = odd ? got1 : own1;
  bits[2] = odd ? own0 : got0;
  bits[3] = odd ? own1 : got1;
}

// The forward on the tensor cores: a block per (kRows queries, head, batch
// row), a warp per 16 query rows, whose q rows sit in shared memory. K and
// V stream in tiles of kKeys keys through a cp.async double buffer. For
// each tile the warp computes S = q K^T into register accumulators (a
// thread holds columns 2 tg, 2 tg + 1 of rows gr and gr + 8; the k steps
// go round kSplits accumulator sets, added in order after, so that more
// products are in flight than the tile's columns of 8 give), scales it by
// q_scale (keys past S at -inf), reduces the row max across the quad,
// forms corr = exp(m_old - m_new), P = exp(s - m) (every term added to the
// thread's partial denominator, rescaled by corr) and Pd = keep P / (1 -
// rate) in place: the accumulators are the A fragments of Pd V as they
// stand (mma_tf32.cuh's k order). Each tile's Pd V is summed from zero and
// added to the output rows as fmaf(out, corr, Pd V): the tensor cores'
// fp32 accumulation truncates, and an output summed in place over all 64
// key tiles of S = 1024 with near-uniform scores drifted past the 1e-5 bar
// (tests/test_torch_cuda.py's near-uniform case). At the end the quad adds
// its 4 partial denominators in one order and the warp stores out = acc /
// l as float2s, rows past S left out.
//
// Tiles by width: kKeys keys a tile and kSplits sets of S's sums, the k
// steps over W (1, 1, 2, 3, 4, 6, 8, 16, 32 from Dh 4 to 256) dealt round
// the sets (where they do not divide, the last steps have no partner).
//
// Dh <= 64 (4 warps, 64 q rows): 64-key tiles and one set up to Dh 24, 32
// keys and one set at 32 and 48, 32 keys and four sets at 64; shared
// memory 15 KB at Dh 4 and 8, 25 at 16, 35 at 24, 27 at 32, 39 at 48, 51 at
// 64. ptxas (sm_90a, packed, without / with dropout): 79 / 80 registers at
// Dh 4, 93 / 96 at 8, 127 / 128 at 16, 128 / 128 at 24, 96 / 127 at 32, 96
// / 128 at 48, 154 / 163 at 64; no spills. Chosen on the card by
// bench_attention --kernel rows (NVIDIA H100 80GB HBM3, 700 W, B 64, 4
// heads, rate 0, ms at S 256 / 64 / 16 / 1024): 64-key tiles against 32
// and 16 at Dh 4 0.0316 / 0.0087 / 0.0080 / 0.3628, 0.0330 / 0.0086 /
// 0.0073 / 0.3896, 0.0387 / 0.0095 / 0.0070 / 0.4666; at Dh 24 0.0540 /
// 0.0116 / 0.0089 / 0.6782, 0.0562 / 0.0115 / 0.0081 / 0.7193, 0.0654 /
// 0.0123 / 0.0078 / 0.8286; at Dh 64 32 keys 0.1145 / 0.0178 / 0.0106 /
// 1.5459 against 64 0.1281 / 0.0184 / 0.0129 / 1.7315 and 16 0.1313 /
// 0.0192 / 0.0099 / 1.7234 (two sets). One set against two and four at
// Dh 24: 0.0540 / 0.0117 / 0.0089 / 0.6784, 0.0539 / 0.0117 / 0.0090 /
// 0.6806, 0.0557 / 0.0118 / 0.0092 / 0.7072 (rate 0.2, S 1024: 0.9297,
// 0.9379, 0.9950); at Dh 32 (S 256 / 1024) 0.0658 / 0.8658 against 0.0669
// / 0.8827 and 0.0716 / 0.9346; at Dh 48 0.0912 / 1.1859, 0.0922 / 1.2014,
// 0.0957 / 1.2583; at Dh 64 four sets 0.1108 / 0.0167 / 0.0097 / 1.5252
// against two 0.1148 / 0.0178 / 0.0105 / 1.5455 and one 0.1140 / 0.0177 /
// 0.0103 / 1.5376. So S 16 runs 7-14% slower than in 16-key tiles, for
// 10-22% off S 256 and 1024 (one set of tiles a width). The thread-a-row
// kernel these replace (a thread a query, K and V tiles read as
// broadcasts) took 0.0471 / 0.0163 / 0.0089 / 0.3678 at Dh 4, 0.1827 /
// 0.0485 / 0.0174 / 1.6788 at Dh 24 and 0.6881 / 0.1016 / 0.0322 / 6.5557
// at Dh 64 in the same turns: every width runs this kernel.
//
// Dh 128 and 256 (4 warps, 64 q rows, 2 x 2 tiles of 16 keys): 66 KB of
// shared memory at Dh 128 (three blocks an SM), 130 KB at 256 (one). ptxas
// (sm_90a, both layouts, without / with dropout): 167 / 167 registers at Dh
// 128 (165 with dropout on split heads), 255 / 255 at 256; no spills. Chosen
// on the card by bench_attention --kernel lanes (NVIDIA H100 80GB HBM3, 700
// W), rate 0, B 16 / 4: blocks of 4 warps against 1, 2 and 8 (1 and 2 warps
// were up to 1.7x and 1.1x slower at Dh 128, S 256; 8 up to 1.4x slower at
// Dh 256); 4 accumulator sets at Dh 128 (0.0672 / 0.0178 / 0.0094 ms at S
// 256 / 64 / 16, against 0.0732 / 0.0201 / 0.0101 with one and 0.0747 /
// 0.0204 / 0.0101 with two) and 2 at Dh 256 (0.0789 ms, against 0.0826 with
// one and 0.0801 with four); 32-key tiles (2 sets) were 4% faster at S 256
// and 27% slower at S 16.
template <int DH>
struct MmaFwd {
  static constexpr int kWidth = DH < 8 ? 8 : DH;  // a tile row's floats
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // queries a block
  static constexpr int kKeys = DH <= 24 ? 64 : DH <= 64 ? 32 : 16;  // a tile
  static constexpr int kSplits = DH <= 48 ? 1 : DH == 256 ? 2 : 4;  // S's sets
  static constexpr size_t kBytes =
      sizeof(float) * (kRows + 2 * 2 * kKeys) * (kWidth + kTilePad);
};

template <class Layout, bool DROPOUT>
__global__ void __launch_bounds__(MmaFwd<Layout::kHeadDim>::kThreads)
    attention_mma_fwd_kernel(Layout lay, const int* __restrict__ seed_ptr,
                             const float* __restrict__ q_in,
                             const float* __restrict__ k_in,
                             const float* __restrict__ v_in,
                             float* __restrict__ out, float q_scale,
                             uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  using T = MmaFwd<DH>;
  constexpr int W = T::kWidth;
  constexpr int KT = T::kKeys;
  constexpr int NT = KT / 8;  // columns of 8 keys in a tile
  constexpr int NK = W / 8;   // k steps over W, and out's columns of 8
  constexpr int NS = T::kSplits;
  constexpr int LD = W + kTilePad;
  extern __shared__ float4 mma_smem[];
  float* q_s = reinterpret_cast<float*>(mma_smem);  // (kRows, LD), unscaled
  float* kv_s = q_s + T::kRows * LD;  // stage st: K, then V, at 2 st KT LD
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int i0 = blockIdx.x * T::kRows;
  const int r0 = 16 * warp;  // the warp's rows in the block
  const bool active = i0 + r0 < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;
  const int nk = (seq_len + KT - 1) / KT;

  if constexpr (W != DH) zero_shared(q_s, T::kBytes / sizeof(float));
  load_rows_async<DH, T::kRows, W>(q_s, q_in + head, i0, seq_len, row,
                                   T::kThreads);
  load_rows_async<DH, KT, W>(kv_s, k_in + head, 0, seq_len, row, T::kThreads);
  load_rows_async<DH, KT, W>(kv_s + KT * LD, v_in + head, 0, seq_len, row,
                             T::kThreads);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NK][4];
#pragma unroll
  for (int dn = 0; dn < NK; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < nk) {
      float* next = kv_s + ((t + 1) & 1) * 2 * KT * LD;
      load_rows_async<DH, KT, W>(next, k_in + head, (t + 1) * KT, seq_len,
                                 row, T::kThreads);
      load_rows_async<DH, KT, W>(next + KT * LD, v_in + head, (t + 1) * KT,
                                 seq_len, row, T::kThreads);
      cp_async_commit();
    }
    if (!active) continue;
    const int j0 = t * KT;
    const float* k_s = kv_s + (t & 1) * 2 * KT * LD;
    const float* v_s = k_s + KT * LD;

    // S = q K^T: the warp's 16 rows x the tile's KT keys, k step ks into
    // accumulator set ks % NS for more products in flight (an odd NK's last
    // step alone), the sets added in order
    float x[NS][NT][4];
#pragma unroll
    for (int p = 0; p < NS; ++p) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        x[p][n][0] = x[p][n][1] = x[p][n][2] = x[p][n][3] = 0.f;
      }
    }
#pragma unroll (8 / NS)
    for (int ks = 0; ks < NK; ks += NS) {
#pragma unroll
      for (int p = 0; p < NS; ++p) {
        if (ks + p >= NK) break;
        const int c = 8 * (ks + p) + tg;
        const FragA qa = tile_frag_a<W>(q_s, r0 + gr, c);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_3xtf32(x[p][n], qa, tile_frag_bt<W>(k_s, 8 * n + gr, c));
        }
      }
    }
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = x[0][n][e];
#pragma unroll
        for (int p = 1; p < NS; ++p) s[n][e] += x[p][n][e];
      }
    }
    // scaled scores, -inf past S; the row max over the quad, and the
    // factor corr that rescales the thread's denominators and output rows
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key = j0 + 8 * n + 2 * tg + (e & 1) < seq_len;
        s[n][e] = key ? s[n][e] * q_scale : -INFINITY;
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = expf(m[r] - mx);
      l[r] *= corr[r];
      m[r] = mx;
    }
    // P into the denominators, Pd = keep P / (1 - rate) as A fragments
    FragA pa[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bits[4] = {0u, 0u, 0u, 0u};
      if (DROPOUT) {
        fragment_keep_words(bits, seed, b, h, i0 + r0, j0 + 8 * n, lane);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[n][e] = !DROPOUT ? p : bits[e] >= threshold ? p * keep_scale : 0.f;
      }
      pa[n] = frag_a_from_c(s[n]);
    }
    // out = corr out + Pd V: the tile's product into a zeroed fragment, 8
    // keys a k step, then added to the rescaled rows by one fmaf each
#pragma unroll
    for (int dn = 0; dn < NK; ++dn) {
      float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_3xtf32(pv, pa[n],
                   tile_frag_b<W>(v_s, 8 * n + 2 * tg, 8 * dn + gr));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[dn][e] = fmaf(acc[dn][e], corr[e >> 1], pv[e]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv_l = 1.f / lt;
    const int i = i0 + r0 + gr + 8 * r;
    if (i >= seq_len) continue;
    float* dst = out + lay.out_head(b, h) + static_cast<size_t>(i) *
                 lay.out_row() + 2 * tg;
#pragma unroll
    for (int dn = 0; dn < NK; ++dn) {
      if (8 * dn + 2 * tg >= DH) break;  // a pad column (Dh = 4)
      *reinterpret_cast<float2*>(dst + 8 * dn) =
          make_float2(acc[dn][2 * r] * inv_l, acc[dn][2 * r + 1] * inv_l);
    }
  }
}

// The first `cols` values of `rows` rows of a bf16 tile (LD-value rows)
// times q_scale, rounded to bf16 in place, by all `threads` threads.
template <int LD>
__device__ __forceinline__ void scale_rows_bf16(bf16* tile, int rows,
                                                int cols, float q_scale,
                                                int threads) {
  for (int e = threadIdx.x; e < rows * cols; e += threads) {
    bf16* x = tile + (e / cols) * LD + e % cols;
    *x = __float2bfloat16_rn(__bfloat162float(*x) * q_scale);
  }
}

// The backward in bf16 (MarScfConfig(compute_dtype="bfloat16"), training):
// the JAX package's bf16 rounding points, `_bwd_kernel_proj` and
// `_bwd_kernel_bh` (gpnf_tpu/ops/pallas/fused_attention.py) on bf16 qkv and
// g: q * q_scale rounded to bf16 as the forward rounds it (q_scale the bf16
// constant), so the scores, P and the mask are the forward's; the scores,
// P, dP = keep dPd / (1 - rate) and D in float32; Pd rounded to bf16 for
// dV = Pd^T g; dS = P (dP - D) rounded to bf16 for dq = dS K and
// dK = dS^T (q scaled and rounded); every product summed in float32 on the
// tensor cores (bf16 mma.sync.m16n8k16, mma_bf16.cuh) and rounded once. dq
// leaves in one of the two recipes the wrapper names: times dq_scale in
// float32 and rounded once (`_bwd_kernel_proj`, dq_scale = Dh^-1/2 in
// float32), or rounded, then times the bf16 constant and rounded again
// (`_bwd_kernel_bh`'s bf16 dq scaled by `_vjp_bwd_long`, dq_round_first).
// dK, dV and dq are written in bf16 into the packed dqkv.
//
// Two kernels, after FlashAttention-2's backward kept deterministic. The
// forward saved each query row's float32 (m, 1/l), its softmax's max and
// inverse denominator (attention_wgmma.cuh's `attention_wgmma_fwd_kernel`
// with STATS, a (B, H, S, 2) buffer), so P = exp(s - m) / l needs no online
// rescale here.
//
// dq kernel: a block per (64 queries, head, batch row), a warp per 16 query
// rows; the block's q rows (scaled and rounded in place) and g rows sit in
// shared memory, and each k16 step reads their A fragments by ldmatrix. K
// and V stream in tiles of kKeys keys through a cp.async double buffer,
// twice. For a tile the warp computes S = q K^T and dPd = g V^T (K's and
// V's B fragments by ldmatrix). Pass A sums the thread's share of
// D = sum_j P dP with P = exp(s - m) from the saved m (times the saved 1/l
// once at the end, after the quad adds its shares in one order); pass B
// forms dS = exp(s - m) / l (dP - D) in the accumulators, rounded and
// paired into the A fragments of dq += dS K (K's B fragments by
// ldmatrix.trans), dq's sums kept in the accumulators across tiles. D goes
// to a float32 (B, H, S) buffer for the dK/dV kernel. D is FlashAttention's
// sum_j P dP, not its rowsum(g * out): out is rounded to bf16 (and its P
// before P V), and D from it put dK and dq past the 2^-7 bar against the
// plain version (tests/test_torch_bf16_mma.py).
//
// Dropout: pass A draws each score's keep bit once (Philox, the words of
// `fragment_keep_words`, one call for 4 scores) and stores it in the pair's
// keep-bit buffer, one 32-bit word a fragment element by __ballot_sync
// (`keep_group`); pass B and the dK/dV kernel read the bits back. So the
// pair draws each score once, where it drew it three times, and the buffer
// (S^2 / 8 bytes a head) lives only for the call.
//
// dK/dV kernel: a block per (64 keys, head, batch row), a warp per 16 keys
// (two warps at W 256, each computing the keys' scores alike and dK and dV
// for half the columns, so that its sums stay in registers); K's and V's
// rows sit in shared memory, their A fragments in registers for the whole
// block at W 32. Query tiles of q, g, the saved (m, 1/l) and D stream
// through a kStages cp.async ring that all warps share; each q tile is
// scaled and rounded in place when it arrives. For a tile the warp computes
// S^T = K q^T and dPd^T = V g^T (16 keys x kQueries queries, q's and g's B
// fragments by ldmatrix) into its own accumulators, forms Pd^T and dS^T
// there (a thread's four keep bits from two words of the buffer), and the
// C fragments of two neighbouring n8 query tiles, rounded and paired, are
// the A fragment of one k16 step of dV += Pd^T g and dK += dS^T q (q's and
// g's B fragments by ldmatrix.trans). Queries past S come with q, g and
// the stats zero, so their P is 0.
//
// Tiles by width (W = Dh rounded up to 16; Dh 24 runs 32 wide, its pad
// columns zeroed once and never copied or stored): dq's kKeys 64 / 32 / 16
// and dK/dV's kQueries 64 / 32 / 16 at W 32 / 128 / 256, so that a
// thread's accumulators (dq's W / 2 floats and 2 kKeys / 4 of S and dPd;
// dK's and dV's W / 4 (W / 8 at 256) and 2 kQueries / 4 of S^T and dPd^T)
// stay in registers. Sums run in a fixed order and each output element is
// written once: two calls give the same bits.
//
// What bounds them on the H100: at the flagship's level 0 (B 64, S 256, Dh
// 24 run 32 wide, 4 heads) the pair's nine S x S x W products (S and dPd
// twice and dq in the dq kernel; S^T, dPd^T, dV and dK in dK/dV) are
// 9 x 2 x 64 x 4 x 256^2 x 32 = 9.7 GFLOP, ~9.8 us at the dense bf16 rate
// (989 TFLOP/s), five of them at the true width ~5.4 us; the bytes (qkv,
// g, the stats in; D out and in; dqkv out) ~8 us. At the CLIs' C 512 (B 16,
// S 256, Dh 128) 9.7 GFLOP and ~21 MB; at the 64-px level 0 (S 1024)
// 155 GFLOP, ~157 us: operations.
template <int DH>
struct MmaDqBf16 {
  static constexpr int kWidth = (DH + 15) / 16 * 16;  // a tile row's values
  static constexpr int kLd = kWidth + kBf16Pad;
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;  // queries a block
  static constexpr int kKeys = kWidth <= 32 ? 64 : kWidth <= 128 ? 32 : 16;
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * kRows + 2 * 2 * kKeys) * kLd;
};

template <int DH>
struct MmaDkvBf16 {
  static constexpr int kWidth = (DH + 15) / 16 * 16;  // a tile row's values
  static constexpr int kLd = kWidth + kBf16Pad;
  static constexpr int kColSplit = kWidth <= 128 ? 1 : 2;  // warps a key
  static constexpr int kWarps = 4 * kColSplit;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeys = 64;  // keys a block, 16 a warp
  // queries a tile
  static constexpr int kQueries = kWidth <= 32 ? 64 : kWidth <= 128 ? 32 : 16;
  static constexpr int kStages = 2;  // the query tiles' ring
  static constexpr bool kKvInRegisters = kWidth <= 32;
  static constexpr size_t kTileBytes =
      sizeof(bf16) * (2 * kKeys + kStages * 2 * kQueries) * kLd;
  // a stage's stats: (m, 1/l) of each query, then D
  static constexpr size_t kBytes =
      kTileBytes + sizeof(float) * kStages * 3 * kQueries;
};

// The first of the four words of the keep-bit buffer that hold query rows
// i .. i + 15 (i a multiple of 16) and keys j .. j + 7 (j a multiple of 8)
// of head bh, in a buffer of S rounded up to 64 rows and keys (padded_len,
// so that every tile of either kernel lies inside it): word e (0 .. 3)
// holds rows i + 8 (e >> 1) + r and keys j + 2 c + (e & 1) at bit 4 r + c,
// the ballot of the dq kernel's m16n8 C fragment element e.
__device__ __forceinline__ size_t keep_group(int bh, int padded_len, int i,
                                             int j) {
  return ((static_cast<size_t>(bh) * (padded_len / 16) + i / 16) *
              (padded_len / 8) + j / 8) * 4;
}

__device__ __forceinline__ int keep_padded_len(int seq_len) {
  return (seq_len + 63) / 64 * 64;
}

// Backward kernel 1 in bf16: dq, and D of each query row into dsum
// (B, H, S), from the forward's (m, 1/l) in stats (B, H, S, 2).
template <class Layout, bool DROPOUT>
__global__ void __launch_bounds__(MmaDqBf16<Layout::kHeadDim>::kThreads)
    attention_bf16_dq_kernel(Layout lay, const int* __restrict__ seed_ptr,
                             const bf16* __restrict__ q_in,
                             const bf16* __restrict__ k_in,
                             const bf16* __restrict__ v_in,
                             const bf16* __restrict__ g,
                             const float* __restrict__ stats,
                             bf16* __restrict__ dq_out,
                             float* __restrict__ dsum,
                             uint32_t* __restrict__ keep, float q_scale,
                             float dq_scale, int dq_round_first,
                             uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  using T = MmaDqBf16<DH>;
  constexpr int W = T::kWidth;
  constexpr int LD = T::kLd;
  constexpr int KT = T::kKeys;
  constexpr int NT = KT / 8;   // n8 key tiles of a tile
  constexpr int NKS = W / 16;  // k16 steps over W
  constexpr int ND = W / 8;    // n8 tiles of dq's columns
  extern __shared__ float4 mma_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(mma_smem);  // (kRows, LD), scaled
  bf16* g_s = q_s + T::kRows * LD;
  bf16* kv_s = g_s + T::kRows * LD;  // stage st: K, then V, at 2 st KT LD
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int i0 = blockIdx.x * T::kRows;
  const int r0 = 16 * warp;  // the warp's rows in the block
  const bool active = i0 + r0 < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const size_t row_stats = (static_cast<size_t>(b) * lay.heads + h) * seq_len;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;
  const int nk = (seq_len + KT - 1) / KT;
  const int bh = b * lay.heads + h;
  const int padded_len = keep_padded_len(seq_len);

  if constexpr (W != DH) {
    zero_shared(reinterpret_cast<float*>(q_s), T::kBytes / sizeof(float));
  }
  load_rows_bf16<DH, T::kRows, LD>(q_s, q_in + head, i0, seq_len, row,
                                   T::kThreads);
  load_rows_bf16<DH, T::kRows, LD>(g_s, g + lay.out_head(b, h), i0, seq_len,
                                   lay.out_row(), T::kThreads);
  load_rows_bf16<DH, KT, LD>(kv_s, k_in + head, 0, seq_len, row, T::kThreads);
  load_rows_bf16<DH, KT, LD>(kv_s + KT * LD, v_in + head, 0, seq_len, row,
                             T::kThreads);
  cp_async_commit();
  // the forward's (m, 1/l) of the thread's rows gr and gr + 8; rows past S
  // take 1/l = 0, so their dS is 0
  float m[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r0 + gr + 8 * r;
    if (i < seq_len) {
      const float2 st =
          *reinterpret_cast<const float2*>(stats + (row_stats + i) * 2);
      m[r] = st.x;
      inv_l[r] = st.y;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  scale_rows_bf16<LD>(q_s, T::kRows, DH, q_scale, T::kThreads);

  float dpart[2] = {0.f, 0.f}, big_d[2] = {0.f, 0.f};
  float dq[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
  }
  // tiles 0 .. nk - 1 are pass A, nk .. 2 nk - 1 pass B, over the same keys
  for (int t = 0; t < 2 * nk; ++t) {
    if (t > 0) cp_async_wait_all();
    __syncthreads();  // tile t (and q scaled) is in; tile t - 1 is done
    if (t + 1 < 2 * nk) {
      const int jn = ((t + 1) % nk) * KT;
      bf16* next = kv_s + ((t + 1) & 1) * 2 * KT * LD;
      load_rows_bf16<DH, KT, LD>(next, k_in + head, jn, seq_len, row,
                                 T::kThreads);
      load_rows_bf16<DH, KT, LD>(next + KT * LD, v_in + head, jn, seq_len,
                                 row, T::kThreads);
      cp_async_commit();
    }
    if (!active) continue;
    const int j0 = (t % nk) * KT;
    const bf16* k_s = kv_s + (t & 1) * 2 * KT * LD;
    const bf16* v_s = k_s + KT * LD;

    // S = q K^T and dPd = g V^T: the warp's 16 rows x the tile's KT keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      uint32_t qa[4], ga[4];
      frag_a_bf16<LD>(qa, q_s, r0, 16 * ks, lane);
      frag_a_bf16<LD>(ga, g_s, r0, 16 * ks, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4], vb[4];
        frag_b_bf16_pair<LD>(kb, k_s, 16 * np, 16 * ks, lane);
        frag_b_bf16_pair<LD>(vb, v_s, 16 * np, 16 * ks, lane);
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * np], ga, vb[0], vb[1]);
        mma_bf16(dp[2 * np + 1], ga, vb[2], vb[3]);
      }
    }
    // -inf past S, and dP = keep * dPd / (1 - rate): pass A draws the keep
    // bits and stores the fragment's four ballots, pass B reads them
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint4 kw = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) {
        uint32_t* at = keep + keep_group(bh, padded_len, i0 + r0, j0 + 8 * n);
        if (t < nk) {
          uint32_t bits[4];
          fragment_keep_words(bits, seed, b, h, i0 + r0, j0 + 8 * n, lane);
          kw = make_uint4(__ballot_sync(0xffffffffu, bits[0] >= threshold),
                          __ballot_sync(0xffffffffu, bits[1] >= threshold),
                          __ballot_sync(0xffffffffu, bits[2] >= threshold),
                          __ballot_sync(0xffffffffu, bits[3] >= threshold));
          if (lane == 0) *reinterpret_cast<uint4*>(at) = kw;
        } else {
          kw = *reinterpret_cast<const uint4*>(at);
        }
      }
      const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j0 + 8 * n + 2 * tg + (e & 1) >= seq_len) s[n][e] = -INFINITY;
        if (DROPOUT) {
          dp[n][e] = (words[e] >> lane) & 1u ? dp[n][e] * keep_scale : 0.f;
        }
      }
    }
    if (t < nk) {
      // pass A: the thread's share of sum_j exp(s - m) dP; the quad's
      // shares added in one order after the last tile, then times 1/l
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dpart[e >> 1] =
              fmaf(expf(s[n][e] - m[e >> 1]), dp[n][e], dpart[e >> 1]);
        }
      }
      if (t == nk - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float dt = dpart[r] + __shfl_xor_sync(0xffffffffu, dpart[r], 1);
          dt += __shfl_xor_sync(0xffffffffu, dt, 2);
          big_d[r] = dt * inv_l[r];
        }
      }
      continue;
    }
    // pass B: dS = P (dP - D), rounded and paired into the A fragments of
    // dq += dS K, 16 keys a k16 step
#pragma unroll
    for (int kp = 0; kp < NT / 2; ++kp) {
      float d[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          d[x][e] = expf(s[2 * kp + x][e] - m[r]) * inv_l[r] *
                    (dp[2 * kp + x][e] - big_d[r]);
        }
      }
      const uint32_t da[4] = {pack_bf16(d[0][0], d[0][1]),
                              pack_bf16(d[0][2], d[0][3]),
                              pack_bf16(d[1][0], d[1][1]),
                              pack_bf16(d[1][2], d[1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < ND / 2; ++dp2) {
        uint32_t kb[4];
        frag_b_bf16_trans_pair<LD>(kb, k_s, 16 * kp, 16 * dp2, lane);
        mma_bf16(dq[2 * dp2], da, kb[0], kb[1]);
        mma_bf16(dq[2 * dp2 + 1], da, kb[2], kb[3]);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r0 + gr + 8 * r;
    if (i >= seq_len) continue;
    bf16* dst = dq_out + head + static_cast<size_t>(i) * row + 2 * tg;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      if (8 * dn >= DH) break;  // a pad column (Dh = 24)
      float x = dq[dn][2 * r], y = dq[dn][2 * r + 1];
      if (dq_round_first) {
        x = __bfloat162float(__float2bfloat16_rn(x));
        y = __bfloat162float(__float2bfloat16_rn(y));
      }
      *reinterpret_cast<uint32_t*>(dst + 8 * dn) =
          pack_bf16(x * dq_scale, y * dq_scale);
    }
    if (tg == 0) dsum[row_stats + i] = big_d[r];
  }
}

// Backward kernel 2 in bf16: dK and dV, from the forward's (m, 1/l) in
// stats (B, H, S, 2), the dq kernel's D in dsum (B, H, S) and, with
// dropout, its keep bits.
template <class Layout, bool DROPOUT>
__global__ void __launch_bounds__(MmaDkvBf16<Layout::kHeadDim>::kThreads)
    attention_bf16_dkv_kernel(Layout lay, const uint32_t* __restrict__ keep,
                              const bf16* __restrict__ q_in,
                              const bf16* __restrict__ k_in,
                              const bf16* __restrict__ v_in,
                              const bf16* __restrict__ g,
                              const float* __restrict__ stats,
                              const float* __restrict__ dsum,
                              bf16* __restrict__ dk_out,
                              bf16* __restrict__ dv_out, float q_scale,
                              float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  using T = MmaDkvBf16<DH>;
  constexpr int W = T::kWidth;
  constexpr int LD = T::kLd;
  constexpr int QT = T::kQueries;
  constexpr int NQ = QT / 8;   // n8 query tiles of a tile
  constexpr int NKS = W / 16;  // k16 steps over W
  constexpr int ND = W / 8 / T::kColSplit;  // n8 tiles of the warp's dK, dV
  constexpr int NS = T::kStages;
  constexpr int NKA = T::kKvInRegisters ? NKS : 1;
  extern __shared__ float4 mma_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(mma_smem);  // (kKeys, LD)
  bf16* v_s = k_s + T::kKeys * LD;
  bf16* qg_s = v_s + T::kKeys * LD;  // stage st: q, then g, at 2 st QT LD
  float* st_s = reinterpret_cast<float*>(
      reinterpret_cast<char*>(mma_smem) + T::kTileBytes);  // 3 st QT
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int kr0 = 16 * (warp % 4);  // the warp's keys in the block
  const int c0 = (warp / 4) * 8 * ND;  // its first column of dK and dV
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int kb0 = blockIdx.x * T::kKeys;
  const int k0 = kb0 + kr0;
  const bool active = k0 < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const bf16* g_head = g + lay.out_head(b, h);
  const size_t row_stats = (static_cast<size_t>(b) * lay.heads + h) * seq_len;
  const float* st_head = stats + 2 * row_stats;
  const float* d_head = dsum + row_stats;
  const int bh = b * lay.heads + h;
  const int padded_len = keep_padded_len(seq_len);
  const int nq = (seq_len + QT - 1) / QT;

  if constexpr (W != DH) {
    zero_shared(reinterpret_cast<float*>(mma_smem), T::kBytes / sizeof(float));
  }
  load_rows_bf16<DH, T::kKeys, LD>(k_s, k_in + head, kb0, seq_len, row,
                                   T::kThreads);
  load_rows_bf16<DH, T::kKeys, LD>(v_s, v_in + head, kb0, seq_len, row,
                                   T::kThreads);
  cp_async_commit();
  // query tile `tile` into its stage: q, g, (m, 1/l) and D, zero past S;
  // a commit even with nothing to load keeps every thread's count of groups
  auto load_tile_async = [&](int tile) {
    if (tile < nq) {
      const int i0 = tile * QT;
      bf16* q_t = qg_s + (tile % NS) * 2 * QT * LD;
      float* st = st_s + (tile % NS) * 3 * QT;
      load_rows_bf16<DH, QT, LD>(q_t, q_in + head, i0, seq_len, row,
                                 T::kThreads);
      load_rows_bf16<DH, QT, LD>(q_t + QT * LD, g_head, i0, seq_len,
                                 lay.out_row(), T::kThreads);
      for (int e = threadIdx.x; e < 3 * QT; e += T::kThreads) {
        const bool ml = e < 2 * QT;
        const int at = ml ? 2 * i0 + e : i0 + e - 2 * QT;
        const bool valid = at < (ml ? 2 * seq_len : seq_len);
        cp_async4(st + e, (ml ? st_head : d_head) + (valid ? at : 0), valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) load_tile_async(p);
  cp_async_wait<NS - 1>();  // K and V are in
  __syncthreads();
  uint32_t ka[NKA][4], va[NKA][4];
  if constexpr (T::kKvInRegisters) {
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      frag_a_bf16<LD>(ka[ks], k_s, kr0, 16 * ks, lane);
      frag_a_bf16<LD>(va[ks], v_s, kr0, 16 * ks, lane);
    }
  }

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }
  for (int t = 0; t < nq; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    load_tile_async(t + NS - 1);  // into tile t - 1's stage
    bf16* q_t = qg_s + (t % NS) * 2 * QT * LD;
    scale_rows_bf16<LD>(q_t, QT, DH, q_scale, T::kThreads);
    __syncthreads();  // q scaled and rounded
    if (!active) continue;
    const int i0 = t * QT;
    const bf16* g_t = q_t + QT * LD;
    const float* st = st_s + (t % NS) * 3 * QT;

    // S^T = K q^T and dPd^T = V g^T: the warp's 16 keys x QT queries
    float sx[NQ][4], dx[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sx[n][e] = dx[n][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      if constexpr (!T::kKvInRegisters) {
        frag_a_bf16<LD>(ka[0], k_s, kr0, 16 * ks, lane);
        frag_a_bf16<LD>(va[0], v_s, kr0, 16 * ks, lane);
      }
      const uint32_t(&kf)[4] = ka[T::kKvInRegisters ? ks : 0];
      const uint32_t(&vf)[4] = va[T::kKvInRegisters ? ks : 0];
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t qb[4], gb[4];
        frag_b_bf16_pair<LD>(qb, q_t, 16 * np, 16 * ks, lane);
        frag_b_bf16_pair<LD>(gb, g_t, 16 * np, 16 * ks, lane);
        mma_bf16(sx[2 * np], kf, qb[0], qb[1]);
        mma_bf16(sx[2 * np + 1], kf, qb[2], qb[3]);
        mma_bf16(dx[2 * np], vf, gb[0], gb[1]);
        mma_bf16(dx[2 * np + 1], vf, gb[2], gb[3]);
      }
    }
    // Pd^T = keep P^T / (1 - rate) and dS^T = P^T (dP^T - D), in place; a
    // thread's queries 2 tg and 2 tg + 1 of each n8 tile take their stats
    // by one float4 and one float2, and the keep bits of its keys gr and
    // gr + 8 from one word each (`keep_group`: bit 4 (query & 7) +
    // ((key & 7) >> 1) of word 2 ((query >> 3) & 1) + (key & 1))
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      uint32_t kw[2] = {0u, 0u};
      if (DROPOUT) {
        const uint32_t* at = keep + keep_group(bh, padded_len, i0 + 8 * n,
                                               k0) +
                             2 * (((i0 + 8 * n) >> 3) & 1) + (gr & 1);
        kw[0] = at[0];
        kw[1] = at[4];  // keys k0 + 8 ..
      }
      const float4 ml = *reinterpret_cast<const float4*>(st + 2 * (8 * n +
                                                                   2 * tg));
      const float2 dd =
          *reinterpret_cast<const float2*>(st + 2 * QT + 8 * n + 2 * tg);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        const float p =
            expf(sx[n][e] - (odd ? ml.z : ml.x)) * (odd ? ml.w : ml.y);
        float pd = p, dpv = dx[n][e];
        if (DROPOUT) {
          const bool kept = (kw[e >> 1] >> (4 * (2 * tg + odd) + (gr >> 1))) &
                            1u;
          pd = kept ? p * keep_scale : 0.f;
          dpv = kept ? dpv * keep_scale : 0.f;
        }
        sx[n][e] = pd;
        dx[n][e] = p * (dpv - (odd ? dd.y : dd.x));
      }
    }
    // dV += Pd^T g and dK += dS^T q, 16 queries a k16 step: two n8 tiles'
    // accumulators, rounded and paired, are the step's A fragments
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(sx[2 * kk][0], sx[2 * kk][1]),
          pack_bf16(sx[2 * kk][2], sx[2 * kk][3]),
          pack_bf16(sx[2 * kk + 1][0], sx[2 * kk + 1][1]),
          pack_bf16(sx[2 * kk + 1][2], sx[2 * kk + 1][3])};
      const uint32_t da[4] = {
          pack_bf16(dx[2 * kk][0], dx[2 * kk][1]),
          pack_bf16(dx[2 * kk][2], dx[2 * kk][3]),
          pack_bf16(dx[2 * kk + 1][0], dx[2 * kk + 1][1]),
          pack_bf16(dx[2 * kk + 1][2], dx[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t gb[4], qb[4];
        frag_b_bf16_trans_pair<LD>(gb, g_t, 16 * kk, c0 + 16 * dp, lane);
        frag_b_bf16_trans_pair<LD>(qb, q_t, 16 * kk, c0 + 16 * dp, lane);
        mma_bf16(dv[2 * dp], pa, gb[0], gb[1]);
        mma_bf16(dv[2 * dp + 1], pa, gb[2], gb[3]);
        mma_bf16(dk[2 * dp], da, qb[0], qb[1]);
        mma_bf16(dk[2 * dp + 1], da, qb[2], qb[3]);
      }
    }
  }
  cp_async_wait_all();  // the ring's empty groups
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + gr + 8 * r;
    if (j >= seq_len) continue;
    const size_t at = head + static_cast<size_t>(j) * row + c0 + 2 * tg;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      if (c0 + 8 * dn >= DH) break;  // a pad column (Dh = 24)
      *reinterpret_cast<uint32_t*>(dk_out + at + 8 * dn) =
          pack_bf16(dk[dn][2 * r], dk[dn][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + at + 8 * dn) =
          pack_bf16(dv[dn][2 * r], dv[dn][2 * r + 1]);
    }
  }
}

// Backward kernel 1 on the tensor cores: dq (times q_scale), and (m, 1/l, D)
// of each query row into stats (B, H, S, 3); operands of type In, float32 or
// bf16 (widened as they are read, dq rounded at the store).
template <class Layout, class In, bool DROPOUT>
__global__ void __launch_bounds__(MmaDq<Layout::kHeadDim>::kThreads)
    attention_mma_dq_kernel(Layout lay, const int* __restrict__ seed_ptr,
                            const In* __restrict__ q_in,
                            const In* __restrict__ k_in,
                            const In* __restrict__ v_in,
                            const In* __restrict__ g,
                            In* __restrict__ dq_out,
                            float* __restrict__ stats, float q_scale,
                            uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  using T = MmaDq<DH>;
  constexpr int W = T::kWidth;
  constexpr int KT = T::kKeys;
  constexpr int NT = KT / 8;  // columns of 8 keys in a tile
  constexpr int NK = W / 8;   // k steps over W, and dq's columns of 8
  constexpr int LD = tile_ld<In, W>();
  extern __shared__ float4 mma_smem[];
  In* q_s = reinterpret_cast<In*>(mma_smem);  // (kRows, LD), unscaled
  In* g_s = q_s + T::kRows * LD;
  In* kv_s = g_s + T::kRows * LD;  // stage st: K, then V, at 2 st KT LD
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int i0 = blockIdx.x * T::kRows;
  const int r0 = 16 * warp;  // the warp's rows in the block
  const bool active = i0 + r0 < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;
  const int nk = (seq_len + KT - 1) / KT;

  if constexpr (W != DH) {
    zero_shared(reinterpret_cast<float*>(mma_smem),
                T::template bytes<In>() / sizeof(float));
  }
  load_rows_async<DH, T::kRows, W>(q_s, q_in + head, i0, seq_len, row,
                                   T::kThreads);
  load_rows_async<DH, T::kRows, W>(g_s, g + lay.out_head(b, h), i0, seq_len,
                                   lay.out_row(), T::kThreads);
  load_rows_async<DH, KT, W>(kv_s, k_in + head, 0, seq_len, row, T::kThreads);
  load_rows_async<DH, KT, W>(kv_s + KT * LD, v_in + head, 0, seq_len, row,
                             T::kThreads);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float dsum[2] = {0.f, 0.f}, inv_l[2] = {0.f, 0.f}, big_d[2] = {0.f, 0.f};
  float dq[NK][4];
#pragma unroll
  for (int dn = 0; dn < NK; ++dn) {
    dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;
  }
  // tiles 0 .. nk - 1 are pass A, nk .. 2 nk - 1 pass B, over the same keys
  for (int t = 0; t < 2 * nk; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < 2 * nk) {
      const int jn = ((t + 1) % nk) * KT;
      In* next = kv_s + ((t + 1) & 1) * 2 * KT * LD;
      load_rows_async<DH, KT, W>(next, k_in + head, jn, seq_len, row,
                                 T::kThreads);
      load_rows_async<DH, KT, W>(next + KT * LD, v_in + head, jn, seq_len,
                                 row, T::kThreads);
      cp_async_commit();
    }
    if (!active) continue;
    const int j0 = (t % nk) * KT;
    const In* k_s = kv_s + (t & 1) * 2 * KT * LD;
    const In* v_s = k_s + KT * LD;

    // S = q K^T and dPd = g V^T: the warp's 16 rows x the tile's KT keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll 8
    for (int ks = 0; ks < NK; ++ks) {
      const int c = 8 * ks + tg;
      const auto qa = tile_frag_a<W>(q_s, r0 + gr, c);
      const auto ga = tile_frag_a<W>(g_s, r0 + gr, c);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        mma_split(s[n], qa, tile_frag_bt<W>(k_s, 8 * n + gr, c));
        mma_split(dp[n], ga, tile_frag_bt<W>(v_s, 8 * n + gr, c));
      }
    }
    // scaled scores (-inf past S) and dP = keep * dPd / (1 - rate)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bits[4] = {0u, 0u, 0u, 0u};
      if (DROPOUT) {
        fragment_keep_words(bits, seed, b, h, i0 + r0, j0 + 8 * n, lane);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key = j0 + 8 * n + 2 * tg + (e & 1) < seq_len;
        s[n][e] = key ? s[n][e] * q_scale : -INFINITY;
        if (DROPOUT) {
          dp[n][e] = bits[e] >= threshold ? dp[n][e] * keep_scale : 0.f;
        }
      }
    }
    if (t < nk) {
      // pass A: the row max over the quad, then the thread's own sums,
      // rescaled with m
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float corr = expf(m[r] - mx);
        l[r] *= corr;
        dsum[r] *= corr;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float ex = expf(s[n][e] - mx);
            l[r] += ex;
            dsum[r] = fmaf(ex, dp[n][e], dsum[r]);
          }
        }
        m[r] = mx;
      }
      if (t == nk - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
          lt += __shfl_xor_sync(0xffffffffu, lt, 2);
          float dt = dsum[r] + __shfl_xor_sync(0xffffffffu, dsum[r], 1);
          dt += __shfl_xor_sync(0xffffffffu, dt, 2);
          inv_l[r] = 1.f / lt;
          big_d[r] = dt * inv_l[r];
        }
      }
      continue;
    }
    // pass B: dS = P (dP - D) in place, then dq += dS K, 8 keys a k step
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[n][e] = expf(s[n][e] - m[r]) * inv_l[r] * (dp[n][e] - big_d[r]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const FragA da = frag_a_from_c(s[n]);
#pragma unroll
      for (int dn = 0; dn < NK; ++dn) {
        mma_split(dq[dn], da,
                  tile_frag_b<W>(k_s, 8 * n + 2 * tg, 8 * dn + gr));
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r0 + gr + 8 * r;
    if (i >= seq_len) continue;
    In* dst = dq_out + head + static_cast<size_t>(i) * row + 2 * tg;
#pragma unroll
    for (int dn = 0; dn < NK; ++dn) {
      if (8 * dn + 2 * tg >= DH) break;  // a pad column (Dh = 4)
      store_pair(dst + 8 * dn, dq[dn][2 * r] * q_scale,
                 dq[dn][2 * r + 1] * q_scale);
    }
    if (tg == 0) {
      float* st =
          stats + ((static_cast<size_t>(b) * lay.heads + h) * seq_len + i) * 3;
      st[0] = m[r];
      st[1] = inv_l[r];
      st[2] = big_d[r];
    }
  }
}

// Backward kernel 2 on the tensor cores: dK and dV; operands of type In,
// float32 or bf16 (widened as they are read, dK and dV rounded at the
// store).
template <class Layout, class In, bool DROPOUT>
__global__ void __launch_bounds__(MmaDkv<Layout::kHeadDim>::kThreads)
    attention_mma_dkv_kernel(Layout lay, const int* __restrict__ seed_ptr,
                             const In* __restrict__ q_in,
                             const In* __restrict__ k_in,
                             const In* __restrict__ v_in,
                             const In* __restrict__ g,
                             const float* __restrict__ stats,
                             In* __restrict__ dk_out,
                             In* __restrict__ dv_out, float q_scale,
                             uint32_t threshold, float keep_scale) {
  constexpr int DH = Layout::kHeadDim;
  using T = MmaDkv<DH>;
  constexpr int W = T::kWidth;
  constexpr int QT = T::kQueries;
  constexpr int NQ = QT / 8;  // columns of 8 queries in a tile
  constexpr int NK = W / 8;   // k steps over W, and dK's columns of 8
  constexpr int LD = tile_ld<In, W>();
  constexpr int XP = T::kPad;
  extern __shared__ float4 mma_smem[];
  In* k_s = reinterpret_cast<In*>(mma_smem);  // (kKeys, LD)
  In* v_s = k_s + T::kKeys * LD;
  In* qg_s = v_s + T::kKeys * LD;  // stage st: q (unscaled), g at 2 st QT LD
  // stage st: (m, 1/l, D) at 3 st QT, after the tiles
  float* st_s = reinterpret_cast<float*>(reinterpret_cast<char*>(mma_smem) +
                                         T::template tile_bytes<In>());
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int pair = warp >> 1;
  const int role = warp & 1;  // 0: S^T and dV, 1: dPd^T and dK
  float* xs = st_s + 2 * 3 * QT + pair * 2 * 16 * XP;  // S^T, then Pd^T
  float* xd = xs + 16 * XP;                            // dPd^T, then dS^T
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int k0 = blockIdx.x * T::kKeys + 16 * pair;  // the pair's first key
  const int kr0 = 16 * pair;
  const bool active = k0 < seq_len;
  const size_t row = lay.in_row();
  const size_t head = lay.in_head(b, h);
  const In* g_head = g + lay.out_head(b, h);
  const float* st_head =
      stats + (static_cast<size_t>(b) * lay.heads + h) * seq_len * 3;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;
  const int nq = (seq_len + QT - 1) / QT;
  const int n_st = 3 * seq_len;

  const int kb0 = blockIdx.x * T::kKeys;
  if constexpr (W != DH) {
    zero_shared(reinterpret_cast<float*>(mma_smem),
                T::template bytes<In>() / sizeof(float));
  }
  load_rows_async<DH, T::kKeys, W>(k_s, k_in + head, kb0, seq_len, row,
                                   T::kThreads);
  load_rows_async<DH, T::kKeys, W>(v_s, v_in + head, kb0, seq_len, row,
                                   T::kThreads);
  auto load_tile_async = [&](int i0, int stage) {
    In* q_t = qg_s + stage * 2 * QT * LD;
    load_rows_async<DH, QT, W>(q_t, q_in + head, i0, seq_len, row,
                               T::kThreads);
    load_rows_async<DH, QT, W>(q_t + QT * LD, g_head, i0, seq_len,
                               lay.out_row(), T::kThreads);
    for (int e = threadIdx.x; e < 3 * QT; e += T::kThreads) {
      const bool valid = 3 * i0 + e < n_st;
      cp_async4(st_s + stage * 3 * QT + e, st_head + (valid ? 3 * i0 + e : 0),
                valid);
    }
    cp_async_commit();
  };
  load_tile_async(0, 0);

  float acc[NK][4];  // dV (role 0) or dK / q_scale (role 1)
#pragma unroll
  for (int dn = 0; dn < NK; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  const In* a_s = role ? v_s : k_s;  // the rows of the first product's A
  float* x_own = role ? xd : xs;
  for (int t = 0; t < nq; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < nq) load_tile_async((t + 1) * QT, (t + 1) & 1);
    if (!active) continue;
    const int i0 = t * QT;
    const In* q_t = qg_s + (t & 1) * 2 * QT * LD;
    const In* g_t = q_t + QT * LD;
    const float* st = st_s + (t & 1) * 3 * QT;

    // S^T = K q^T (even warp) or dPd^T = V g^T (odd): 16 keys x QT queries,
    // even and odd k steps in separate accumulators for more products in
    // flight (an odd NK's last step alone)
    {
      const In* b_s = role ? g_t : q_t;
      float x[2][NQ][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[p][n][e] = 0.f;
        }
      }
#pragma unroll 2
      for (int ks = 0; ks < NK; ks += 2) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (ks + p >= NK) break;
          const int c = 8 * (ks + p) + tg;
          const auto fa = tile_frag_a<W>(a_s, kr0 + gr, c);
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            mma_split(x[p][n], fa, tile_frag_bt<W>(b_s, 8 * n + gr, c));
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        *reinterpret_cast<float2*>(x_own + gr * XP + 8 * n + 2 * tg) =
            make_float2(x[0][n][0] + x[1][n][0], x[0][n][1] + x[1][n][1]);
        *reinterpret_cast<float2*>(x_own + (gr + 8) * XP + 8 * n + 2 * tg) =
            make_float2(x[0][n][2] + x[1][n][2], x[0][n][3] + x[1][n][3]);
      }
    }
    pair_sync<T::kPairs>(pair);
    // Pd = keep P / (1 - rate) and dS = P (dP - D): one Philox call for the
    // 4 keys of a quad and one query
    for (int u = 32 * role + lane; u < 4 * QT; u += 64) {
      const int qi = u % QT;
      const int quad = u / QT;
      const int i = i0 + qi;
      const float mi = st[3 * qi], li = st[3 * qi + 1], di = st[3 * qi + 2];
      uint4 bits = make_uint4(0u, 0u, 0u, 0u);
      if (DROPOUT) bits = attention_dropout_bits(seed, b, h, i, k0 / 4 + quad);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int at = (4 * quad + r) * XP + qi;
        const bool live = i < seq_len && k0 + 4 * quad + r < seq_len;
        const float p = live ? expf(xs[at] * q_scale - mi) * li : 0.f;
        float pd = p, dpv = xd[at];
        if (DROPOUT) {
          const bool keep = philox_word(bits, r) >= threshold;
          pd = keep ? p * keep_scale : 0.f;
          dpv = keep ? dpv * keep_scale : 0.f;
        }
        xs[at] = pd;
        xd[at] = p * (dpv - di);
      }
    }
    pair_sync<T::kPairs>(pair);
    // dV += Pd^T g (even warp) or dK += dS^T q (odd), 8 queries a k step
    const In* b2 = role ? q_t : g_t;
#pragma unroll
    for (int kk = 0; kk < NQ; ++kk) {
      const float2 top =
          *reinterpret_cast<const float2*>(x_own + gr * XP + 8 * kk + 2 * tg);
      const float2 bot = *reinterpret_cast<const float2*>(
          x_own + (gr + 8) * XP + 8 * kk + 2 * tg);
      const FragA fa = frag_a(top.x, bot.x, top.y, bot.y);
#pragma unroll
      for (int dn = 0; dn < NK; ++dn) {
        mma_split(acc[dn], fa,
                  tile_frag_b<W>(b2, 8 * kk + 2 * tg, 8 * dn + gr));
      }
    }
  }
  if (!active) return;
  In* out = role ? dk_out : dv_out;
  const float scale = role ? q_scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + gr + 8 * r;
    if (j >= seq_len) continue;
    In* dst = out + head + static_cast<size_t>(j) * row + 2 * tg;
#pragma unroll
    for (int dn = 0; dn < NK; ++dn) {
      if (8 * dn + 2 * tg >= DH) break;  // a pad column (Dh = 4)
      store_pair(dst + 8 * dn, acc[dn][2 * r] * scale,
                 acc[dn][2 * r + 1] * scale);
    }
  }
}

// Launch `kernel` on `threads` threads a block with `bytes` of dynamic
// shared memory (above the 48 KB a static array may take).
template <class Kernel, class... Args>
cudaError_t launch_dynamic(Kernel kernel, dim3 grid, int threads, size_t bytes,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// The forward of one layout, at every width: the tensor-core kernel, one
// launch. cp.async copies 16-byte chunks, so q, k and v must start 16-byte
// aligned (the wrappers' fresh tensors do; a view at an odd offset is
// refused, with no launch).
template <class Layout>
cudaError_t attention_tiled_fwd(Layout lay, int batch, const int* seed,
                                const float* q, const float* k,
                                const float* v, float* out, float q_scale,
                                uint32_t threshold, float keep_scale,
                                cudaStream_t stream) {
  using T = MmaFwd<Layout::kHeadDim>;
  for (const float* p : {q, k, v}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  const dim3 grid((lay.seq_len + T::kRows - 1) / T::kRows, lay.heads, batch);
  auto* kernel = threshold > 0 ? &attention_mma_fwd_kernel<Layout, true>
                               : &attention_mma_fwd_kernel<Layout, false>;
  return launch_dynamic(kernel, grid, T::kThreads, T::kBytes, stream, lay,
                        seed, q, k, v, out, q_scale, threshold, keep_scale);
}

// The backward of one layout, at every width: the tensor-core dq and dK/dV
// kernels, two launches, on operands of type In (float32, or bf16 at a width
// that is a multiple of 8). cp.async copies 16-byte chunks, so every operand
// must start 16-byte aligned (the wrappers' fresh tensors do; a view at an
// odd offset is refused, with no launch).
template <class Layout, class In>
cudaError_t attention_tiled_bwd(Layout lay, int batch, const int* seed,
                                const In* q, const In* k, const In* v,
                                const In* g, In* dq, In* dk, In* dv,
                                float* stats, float q_scale,
                                uint32_t threshold, float keep_scale,
                                cudaStream_t stream) {
  constexpr int DH = Layout::kHeadDim;
  using Q = MmaDq<DH>;
  using KV = MmaDkv<DH>;
  for (const In* p : {q, k, v, g}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  const dim3 dq_grid((lay.seq_len + Q::kRows - 1) / Q::kRows, lay.heads,
                     batch);
  auto* dq_kernel = threshold > 0
                        ? &attention_mma_dq_kernel<Layout, In, true>
                        : &attention_mma_dq_kernel<Layout, In, false>;
  cudaError_t err = launch_dynamic(
      dq_kernel, dq_grid, Q::kThreads, Q::template bytes<In>(), stream, lay,
      seed, q, k, v, g, dq, stats, q_scale, threshold, keep_scale);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((lay.seq_len + KV::kKeys - 1) / KV::kKeys, lay.heads,
                     batch);
  auto* dkv_kernel = threshold > 0
                         ? &attention_mma_dkv_kernel<Layout, In, true>
                         : &attention_mma_dkv_kernel<Layout, In, false>;
  return launch_dynamic(dkv_kernel, kv_grid, KV::kThreads,
                        KV::template bytes<In>(), stream, lay, seed, q, k, v,
                        g, static_cast<const float*>(stats), dk, dv, q_scale,
                        threshold, keep_scale);
}

// fn(Layout<D>{seq_len, heads}) for D = head_dim among the widths built (the
// wrappers' HEAD_DIMS; the forward and the backward run on the tensor cores
// at every one; without DH4, the bf16 backward's, every one but 4);
// cudaErrorInvalidValue for any other.
template <template <int> class Layout, bool DH4 = true, class Fn>
cudaError_t with_head_dim(int head_dim, int seq_len, int heads, Fn fn) {
  switch (head_dim) {
    case 4:
      if constexpr (DH4) return fn(Layout<4>{seq_len, heads});
      return cudaErrorInvalidValue;
    case 8: return fn(Layout<8>{seq_len, heads});
    case 16: return fn(Layout<16>{seq_len, heads});
    case 24: return fn(Layout<24>{seq_len, heads});
    case 32: return fn(Layout<32>{seq_len, heads});
    case 48: return fn(Layout<48>{seq_len, heads});
    case 64: return fn(Layout<64>{seq_len, heads});
    case 128: return fn(Layout<128>{seq_len, heads});
    case 256: return fn(Layout<256>{seq_len, heads});
    default: return cudaErrorInvalidValue;
  }
}

inline bool attention_args_ok(int batch, int seq_len, int heads,
                              int head_dim, int max_seq_len, const int* seed,
                              uint32_t threshold) {
  return batch > 0 && seq_len > 0 && seq_len <= max_seq_len && heads > 0 &&
         head_dim > 0 && batch <= 65535 && heads <= 65535 &&
         (threshold == 0 || seed != nullptr);
}

// out (B, S, C) from qkv (B, S, 3C) packed [k | v | q], q scaled by
// q_scale as it is loaded: Dh^-1/2, 1.f / sqrtf(Dh), or the true width's
// where the caller zero-padded the heads to a built width. A template (T is
// float) so that a source that includes this header without calling it
// builds none of its kernels.
template <class T>
int attention_packed_fwd(const int* seed, const T* qkv, T* out, int batch,
                         int seq_len, int channels, int heads,
                         int max_seq_len, float q_scale, uint32_t threshold,
                         float keep_scale, void* stream) {
  static_assert(std::is_same<T, float>::value, "the float32 kernels");
  if (heads <= 0 || channels % heads != 0 ||
      !attention_args_ok(batch, seq_len, heads, channels / heads, max_seq_len,
                         seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh = channels / heads;
  return static_cast<int>(with_head_dim<PackedQkv>(
      dh, seq_len, heads, [&](auto lay) {
        return attention_tiled_fwd(lay, batch, seed, qkv + 2 * channels, qkv,
                                   qkv + channels, out, q_scale, threshold,
                                   keep_scale,
                                   static_cast<cudaStream_t>(stream));
      }));
}

// The bf16 backward of one layout (Dh 24, 128 or 256): the dq and dK/dV
// kernels, two launches, from the forward's float32 stats (B, H, S, 2);
// dsum is the float32 (B, H, S) scratch of D, and keep, where threshold >
// 0, the scratch of the keep bits (B H Sp^2 / 32 words, Sp = S rounded up
// to 64). cp.async copies 16-byte chunks, so q, k, v and g must start
// 16-byte aligned.
template <class Layout>
cudaError_t attention_tiled_bwd_bf16(Layout lay, int batch, const int* seed,
                                     const bf16* q, const bf16* k,
                                     const bf16* v, const bf16* g,
                                     const float* stats, float* dsum,
                                     uint32_t* keep, bf16* dq, bf16* dk,
                                     bf16* dv, float q_scale, float dq_scale,
                                     int dq_round_first, uint32_t threshold,
                                     float keep_scale, cudaStream_t stream) {
  constexpr int DH = Layout::kHeadDim;
  using Q = MmaDqBf16<DH>;
  using KV = MmaDkvBf16<DH>;
  for (const bf16* p : {q, k, v, g}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  if (stats == nullptr || dsum == nullptr ||
      (threshold > 0 && keep == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const dim3 dq_grid((lay.seq_len + Q::kRows - 1) / Q::kRows, lay.heads,
                     batch);
  auto* dq_kernel = threshold > 0 ? &attention_bf16_dq_kernel<Layout, true>
                                  : &attention_bf16_dq_kernel<Layout, false>;
  cudaError_t err =
      launch_dynamic(dq_kernel, dq_grid, Q::kThreads, Q::kBytes, stream, lay,
                     seed, q, k, v, g, stats, dq, dsum, keep, q_scale,
                     dq_scale, dq_round_first, threshold, keep_scale);
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((lay.seq_len + KV::kKeys - 1) / KV::kKeys, lay.heads,
                     batch);
  auto* dkv_kernel = threshold > 0
                         ? &attention_bf16_dkv_kernel<Layout, true>
                         : &attention_bf16_dkv_kernel<Layout, false>;
  return launch_dynamic(dkv_kernel, kv_grid, KV::kThreads, KV::kBytes, stream,
                        lay, static_cast<const uint32_t*>(keep), q, k, v, g,
                        stats, static_cast<const float*>(dsum), dk, dv,
                        q_scale, keep_scale);
}

// dqkv (B, S, 3C) packed [dK | dV | dq * q_scale] from (seed, qkv, g);
// stats is the caller's (B, H, S, 3) scratch. A template as
// `attention_packed_fwd`.
template <class T>
int attention_packed_bwd(const int* seed, const T* qkv, const T* g, T* dqkv,
                         float* stats, int batch, int seq_len, int channels,
                         int heads, int max_seq_len, float q_scale,
                         uint32_t threshold, float keep_scale, void* stream) {
  static_assert(std::is_same<T, float>::value, "the float32 kernels");
  if (heads <= 0 || channels % heads != 0 ||
      !attention_args_ok(batch, seq_len, heads, channels / heads, max_seq_len,
                         seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dh = channels / heads;
  return static_cast<int>(with_head_dim<PackedQkv>(
      dh, seq_len, heads, [&](auto lay) {
        return attention_tiled_bwd(lay, batch, seed, qkv + 2 * channels, qkv,
                                   qkv + channels, g, dqkv + 2 * channels,
                                   dqkv, dqkv + channels, stats, q_scale,
                                   threshold, keep_scale,
                                   static_cast<cudaStream_t>(stream));
      }));
}

}  // namespace gpnf
