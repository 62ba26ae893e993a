// The bf16 attention forward on Hopper's machinery (sm_90a): TMA loads on an
// mbarrier ring, S = (q scale) K^T and P V as warpgroup products (wgmma,
// wgmma_bf16.cuh), P read by wgmma from registers.
//
// Replaces the attention inside gpnf_tpu/ops/pallas/fused_attention.py's
// `_fwd_kernel_proj` (:393, reached through `_run_proj_fwd`) and
// `_fwd_kernel_bh` (:533, through `_run_bh`) in bf16
// (MarScfConfig(compute_dtype="bfloat16")): on packed qkv (B, S, 3C) =
// [k | v | q], per (batch row, head),
//   P = softmax(bf16(q * q_scale) K^T);  Pd = keep P / (1 - rate)
//   out = bf16(Pd V) with fp32 sums,
// at the JAX package's bf16 rounding points: q * q_scale rounded to bf16
// (q_scale the bf16 constant Dh^-1/2), the scores, softmax and dropout in
// fp32, pd = keep p / (1 - rate) rounded to bf16 for P V (p = exp(s - m)
// unnormalised, m the running max; the JAX package rounds the normalised
// p, either within 2^-9 of its value), P V summed in fp32 and out = acc / l
// rounded once. The keep bit of score (b, h, i, j) is philox.cuh's, drawn
// by `fragment_keep_words` for each accumulator element at the coordinates
// every other attention kernel gives it, so the bf16 backward and
// `dropout_keep_plain` regenerate this mask. With STATS (training: a
// forward whose backward is to come) each query row's float32 (m, 1/l)
// goes to a (B, H, S, 2) buffer for the backward; out keeps its bits.
//
// What bounds it on the H100: the exponentials. At the 64-px level 0 (B 64,
// H 4, S 1024, Dh 24) the kernel takes 64 x 4 x 1024^2 = 268 M of them, ~69
// us at the special-function unit's ~3.9 T/s, against ~26 us for the two
// products at the dense bf16 rate (Dh run 32 wide) and ~15 us of bytes; at
// the flagship's 32-px level 0 (S 256) ~4.3 us of exps, 3.8 us of bytes; at
// the CLIs' C 512 (B 16, S 256, Dh 128) 5.0 us of bytes. So a score costs
// one FFMA and one MUFU ex2 (q comes scaled, so p = 2^(s log2e - m log2e)),
// the max and the sum into l, and the bf16 pack; the key-edge mask runs on
// a ragged last tile only, outside the key loop; the products and the
// Philox draws run under the ALU work of other warps and of the next tile.
// Past the exponentials the issue of those few instructions a score bounds
// it, so the tiles are chosen for the warps an SM holds (WgFwd).
//
// Design. A block is `consumers` warpgroups of 64 query rows each (1 or 2,
// `wgmma_fwd_consumers`: 2 where the width takes them and 128-row blocks
// still fill half the SMs) and one producer warp. One 4-D tensor map over
// the packed qkv, (Dh, 3H, S, B), serves q (head 2H + h), K (h) and V
// (H + h): a box that reaches past S is zero-filled and never reads the
// next batch row, and at Dh 24 the box is 32 values wide, so columns 24-31
// arrive as zeros. Boxes are kSpan bytes a row (64 at W 32, 128 above, with
// the TMA swizzle of that span); a tile W values wide is W / kBoxCols boxes
// side by side. The producer loads each warpgroup's q rows once, then keeps
// the ring of `stages` stages (K and V of one key tile each) full, every
// reuse waiting for each consumer to release the stage. A consumer
// warpgroup scales its q rows in shared memory (each value times q_scale,
// rounded to bf16, q * q_scale's one rounding), fences them to the async
// proxy and, per key tile t:
//   - issues S_{t+1} = q K_{t+1}^T (wgmma m64nKTk16, both operands K-major
//     in shared memory) as soon as tile t+1 has landed, and P_t V_t (wgmma
//     m64nWk16, P from registers: the accumulators of two neighbouring n8
//     key blocks are one k16 A fragment; V MN-major), every register of
//     both settled before the first;
//   - waits for S_{t+1} and runs its softmax while P_t V_t is in flight
//     (the two P register sets alternate);
//   - waits for P_t V_t: at W 32 it was summed from zero and is added by
//     fmaf(acc, corr_t, pv) (a rescale of accumulators in place made ptxas
//     serialise every product at this width); at W 128 and 256, where a
//     second set of W / 2 accumulators does not fit, acc *= corr_t went
//     before the product and the product accumulated in place (the tensor
//     cores' fp32 sum over at most 64 tiles, S 2048: far inside bf16's
//     2^-7 bar);
//   - releases the stage.
// At the end the quad adds its partial denominators in one order and the
// warpgroup stores out = acc / l rounded to bf16 (rows past S and pad
// columns left out). Sums run in a fixed order: two calls give the same
// bits, with or without STATS. One launch a call, no atomics.
//
// Tiles by width W (Dh 24 runs 32 wide, every other width is zero-padded by
// the wrapper to 24, 128 or 256) and rate: WgFwd. The ring is `stages`
// deep, at most kMaxStages, as many as the key tiles.
// tests/test_torch_wgmma.py models every box, descriptor and fragment of
// this file.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tiled.cuh"
#include "wgmma_bf16.cuh"

namespace gpnf {

// q, k, v and out: separate (B, H, S, dh) bf16 tensors, `fused_attention`'s
// layout (q already scaled), in a kernel built D wide (the tiles of a width
// D: 32, 128 or 256), dh a multiple of 8 up to D given at run time. Each
// operand has a tensor map of its own over (dh, S, H, B), which zero-fills
// a box's columns past dh as the packed map does Dh 24's columns 24 to 31,
// so every width up to D runs on these tiles with no copy.
template <int D>
struct SplitHeadsTma {
  static constexpr int kHeadDim = D;
  int seq_len, heads, head_dim;
  __device__ size_t out_head(int b, int h) const {
    return (static_cast<size_t>(b) * heads + h) * seq_len * head_dim;
  }
  __device__ size_t out_row() const { return head_dim; }
};

template <class Layout>
struct SplitMaps : std::false_type {};
template <int D>
struct SplitMaps<SplitHeadsTma<D>> : std::true_type {};

// The tiles of one width and rate. Dropout's Philox draws take registers:
// without them a Dh 24 tile is 64 keys and a block two warpgroups, two
// blocks an SM; with them 32 keys and one warpgroup, three blocks an SM
// (no spills either way); W 128 takes 64 keys without dropout and 32 with
// it, W 256 32 keys and one warpgroup (its 128 accumulators a thread).
// Chosen on the card among variants of these constants timed in turns
// (PERF.md §6).
template <int DH, bool DROPOUT>
struct WgFwd {
  static constexpr int kWidth = DH <= 32 ? 32 : DH <= 128 ? 128 : 256;
  // a box row's bytes, the swizzle's span: 64 at W 32, else 128
  static constexpr int kSpan = kWidth < 64 ? 2 * kWidth : 128;
  static constexpr int kBoxCols = kSpan / 2;  // values a box row
  static constexpr int kBoxes = kWidth / kBoxCols;  // boxes across a row
  static constexpr int kKeys = kWidth <= 128 && !DROPOUT ? 64 : 32;
  static constexpr int kRows = 64;  // query rows a warpgroup
  static constexpr int kQBoxBytes = kRows * kSpan;  // a column box of q
  static constexpr int kBoxBytes = kKeys * kSpan;   // a column box of K or V
  static constexpr int kQBytes = kBoxes * kQBoxBytes;  // a warpgroup's q
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kMaxStages = 4;
  static constexpr int kMaxConsumers =
      kWidth == 128 || (kWidth == 32 && !DROPOUT) ? 2 : 1;
  static constexpr int kThreads = 128 * kMaxConsumers + 32;
  // blocks an SM holds at once (the registers a thread may take)
  static constexpr int kMinBlocks = kWidth != 32 ? 1 : DROPOUT ? 3 : 2;
  // P V summed from zero and added by fmaf (W 32), or summed in place in
  // the accumulators after acc *= corr (W 128 and 256: a second set of W / 2
  // accumulators does not fit)
  static constexpr bool kPvFromZero = kWidth == 32;
  static constexpr size_t bytes(int consumers, int stages) {
    return 1024 + static_cast<size_t>(consumers) * kQBytes +
           static_cast<size_t>(stages) * kStageBytes +
           8 * (2 * kMaxStages + 1);
  }
  static_assert(kBoxBytes % (8 * kSpan) == 0 && kQBoxBytes % 1024 == 0,
                "every box on the swizzle pattern's period");
};

// 2^x on the special-function unit (MUFU.EX2; 2^-inf = 0).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The softmax of one key tile's scores s (a thread's NS = KT / 2 of the
// m64nKT accumulators: rows row0 + lane / 4 (+ 8), keys j0 + 8 n + 2 (lane
// % 4) (+ 1)): -inf past S where RAGGED, the running max m over the quad
// and corr = 2^(m_old log2e - m log2e), p = 2^(s log2e - m log2e) into the
// thread's denominators l (rescaled by corr), pd = keep p / (1 - rate)
// rounded to bf16 into pa, the A fragments of P V (two neighbouring n8 key
// blocks a k16 step).
template <bool RAGGED, bool DROPOUT, int NS>
__device__ __forceinline__ void wgmma_fwd_softmax(
    float (&s)[NS], uint32_t (&pa)[NS / 8][4], float (&m)[2], float (&l)[2],
    float (&corr)[2], int j0, int seq_len, uint32_t seed, int b, int h,
    int row0, int lane, uint32_t threshold, float keep_scale) {
  if constexpr (RAGGED) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (j0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1) >= seq_len) {
        s[i] = -INFINITY;
      }
    }
  }
  float ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int n = 0; n < NS / 4; ++n) {
      mx = fmaxf(mx, fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    ml[r] = mx * kLog2e;
    corr[r] = ex2_approx(fmaf(m[r], kLog2e, -ml[r]));
    l[r] *= corr[r];
    m[r] = mx;
  }
#pragma unroll
  for (int n = 0; n < NS / 4; ++n) {
    uint32_t bits[4] = {0u, 0u, 0u, 0u};
    if (DROPOUT) {
      fragment_keep_words(bits, seed, b, h, row0, j0 + 8 * n, lane);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2_approx(fmaf(s[4 * n + e], kLog2e, -ml[e >> 1]));
      l[e >> 1] += p;
      s[4 * n + e] =
          !DROPOUT ? p : bits[e] >= threshold ? p * keep_scale : 0.f;
    }
    pa[n >> 1][2 * (n & 1)] = pack_bf16(s[4 * n], s[4 * n + 1]);
    pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(s[4 * n + 2], s[4 * n + 3]);
  }
}

// tmap is the packed qkv's map, or q's on split heads, where tmap_k and
// tmap_v are K's and V's (the packed layout passes its map in all three).
template <class Layout, bool DROPOUT, bool STATS>
__global__ void __launch_bounds__(
    WgFwd<Layout::kHeadDim, DROPOUT>::kThreads,
    WgFwd<Layout::kHeadDim, DROPOUT>::kMinBlocks)
    attention_wgmma_fwd_kernel(const __grid_constant__ CUtensorMap tmap,
                               const __grid_constant__ CUtensorMap tmap_k,
                               const __grid_constant__ CUtensorMap tmap_v,
                               Layout lay, const int* __restrict__ seed_ptr,
                               bf16* __restrict__ out,
                               float* __restrict__ stats, float q_scale,
                               uint32_t threshold, float keep_scale,
                               int stages) {
  namespace wg = wgmma;
  constexpr int DH = Layout::kHeadDim;
  using T = WgFwd<DH, DROPOUT>;
  constexpr int W = T::kWidth;
  constexpr int KT = T::kKeys;
  constexpr int NS = KT / 2;    // score accumulators a thread
  constexpr int NP = KT / 16;   // k16 steps of P V (A fragments of P)
  constexpr int NA = W / 2;     // output accumulators a thread
  constexpr int NV = W <= 128 ? 1 : 2;  // P V products of N = W / NV
  constexpr wg::Swizzle kSwz = T::kSpan == 128 ? wg::kSwizzle128
                                               : wg::kSwizzle64;
  constexpr uint32_t kSbo = 8 * T::kSpan;  // the next 8 rows
  constexpr bool kSplit = SplitMaps<Layout>::value;
  extern __shared__ uint8_t wgfwd_smem_raw[];
  const uint32_t raw = wg::smem_u32(wgfwd_smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = wgfwd_smem_raw + (base - raw);
  const int consumers = (blockDim.x - 32) / 128;
  const uint32_t ring = base + consumers * T::kQBytes;
  const uint32_t full = ring + stages * T::kStageBytes;  // kMaxStages each
  const uint32_t empty = full + 8 * T::kMaxStages;
  const uint32_t qbar = empty + 8 * T::kMaxStages;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int seq_len = lay.seq_len;
  const int i0 = blockIdx.x * T::kRows * consumers;
  const int nk = (seq_len + KT - 1) / KT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, consumers);
    }
    wg::mbar_init(qbar, 1);
    wg::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * consumers) {  // the producer
    if (lane == 0) {
      wg::prefetch_tmap(&tmap);
      if constexpr (kSplit) {
        wg::prefetch_tmap(&tmap_k);
        wg::prefetch_tmap(&tmap_v);
      }
      wg::mbar_expect_tx(qbar, consumers * T::kQBytes);
      for (int g = 0; g < consumers; ++g) {
        for (int c = 0; c < T::kBoxes; ++c) {
          for (int r = 0; r < T::kRows; r += KT) {
            if constexpr (kSplit) {  // q's map: (dh, S, H, B)
              wg::tma_load_4d(base + g * T::kQBytes + c * T::kQBoxBytes +
                                  r * T::kSpan,
                              &tmap, c * T::kBoxCols, i0 + T::kRows * g + r,
                              h, b, qbar);
            } else {
              wg::tma_load_4d(base + g * T::kQBytes + c * T::kQBoxBytes +
                                  r * T::kSpan,
                              &tmap, c * T::kBoxCols, 2 * lay.heads + h,
                              i0 + T::kRows * g + r, b, qbar);
            }
          }
        }
      }
      for (int t = 0; t < nk; ++t) {
        const int s = t % stages, use = t / stages;
        if (use > 0) wg::mbar_wait(empty + 8 * s, (use - 1) & 1);
        const uint32_t bar = full + 8 * s;
        wg::mbar_expect_tx(bar, T::kStageBytes);
        const uint32_t k_dst = ring + s * T::kStageBytes;
        for (int c = 0; c < T::kBoxes; ++c) {
          if constexpr (kSplit) {
            wg::tma_load_4d(k_dst + c * T::kBoxBytes, &tmap_k,
                            c * T::kBoxCols, t * KT, h, b, bar);
            wg::tma_load_4d(k_dst + T::kTileBytes + c * T::kBoxBytes,
                            &tmap_v, c * T::kBoxCols, t * KT, h, b, bar);
          } else {
            wg::tma_load_4d(k_dst + c * T::kBoxBytes, &tmap, c * T::kBoxCols,
                            h, t * KT, b, bar);
            wg::tma_load_4d(k_dst + T::kTileBytes + c * T::kBoxBytes, &tmap,
                            c * T::kBoxCols, lay.heads + h, t * KT, b, bar);
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g, query rows i0 + 64 g .. + 63; warp w of it
  // holds rows 16 w .. 16 w + 15 (the m16n8 C fragment of each n8 block)
  const int g = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int row0 = i0 + T::kRows * g + 16 * (warp & 3);
  const uint32_t q_tile = base + g * T::kQBytes;
  const uint32_t seed = DROPOUT ? static_cast<uint32_t>(*seed_ptr) : 0u;

  // q * q_scale rounded to bf16 in place (pad columns and rows past S are
  // zeros and stay so), then visible to wgmma's async proxy
  wg::mbar_wait(qbar, 0);
  for (int c = tid; c < T::kQBytes / 16; c += 128) {
    uint4* p = reinterpret_cast<uint4*>(smem + g * T::kQBytes + 16 * c);
    uint4 x = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      w[e] = pack_bf16(f.x * q_scale, f.y * q_scale);
    }
    *p = x;
  }
  wg::fence_proxy_async();
  wg::named_sync(1 + g, 128);

  // descriptors: q and K K-major (the k16 step kk at column 16 kk, in box
  // 16 kk / kBoxCols), V MN-major (the k16 step kp 16 rows of keys in, the
  // next box along the output columns LBO = kBoxBytes on)
  auto q_desc = [&](int kk) {
    const int col = 16 * kk;
    return wg::make_desc(q_tile + (col / T::kBoxCols) * T::kQBoxBytes +
                             2 * (col % T::kBoxCols),
                         16, kSbo, kSwz);
  };
  auto k_desc = [&](int st, int kk) {
    const int col = 16 * kk;
    return wg::make_desc(ring + st * T::kStageBytes +
                             (col / T::kBoxCols) * T::kBoxBytes +
                             2 * (col % T::kBoxCols),
                         16, kSbo, kSwz);
  };
  auto v_desc = [&](int st, int kp, int half) {
    return wg::make_desc(ring + st * T::kStageBytes + T::kTileBytes +
                             half * (T::kBoxes / NV) * T::kBoxBytes +
                             kp * 16 * T::kSpan,
                         T::kBoxBytes, kSbo, kSwz);
  };

  float s[NS];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float corr[2], corr_next[2];
  float acc[NV][NA / NV];
#pragma unroll
  for (int x = 0; x < NV; ++x) {
#pragma unroll
    for (int i = 0; i < NA / NV; ++i) acc[x][i] = 0.f;
  }

  // S = q K^T of the key tile in stage st, issued (committed, not waited);
  // the caller fences the registers first
  auto issue_scores = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
      wg::mma_m64k16<KT, 0, 0>(s, q_desc(kk), k_desc(st, kk), kk > 0);
    }
    wg::wgmma_commit();
  };
  // the softmax of tile t's scores in s, the key-edge mask only on a
  // ragged last tile (a branch a tile)
  auto softmax = [&](int t, uint32_t(&pa)[NP][4], bool ragged) {
    if (ragged) {
      wgmma_fwd_softmax<true, DROPOUT>(s, pa, m, l, corr_next, t * KT,
                                       seq_len, seed, b, h, row0, lane,
                                       threshold, keep_scale);
    } else {
      wgmma_fwd_softmax<false, DROPOUT>(s, pa, m, l, corr_next, t * KT,
                                        seq_len, seed, b, h, row0, lane,
                                        threshold, keep_scale);
    }
    corr[0] = corr_next[0];
    corr[1] = corr_next[1];
  };
  // tile t: S_{t+1} issued (`more`: t + 1 < nk), P_t V_t issued, the
  // softmax of S_{t+1} into pn (`ragged`: the ragged last tile) while
  // P_t V_t runs, then the stage released
  auto step = [&](int t, uint32_t(&pc)[NP][4], uint32_t(&pn)[NP][4],
                  bool more, bool ragged) {
    const int st = t % stages;
    const int sn = (t + 1) % stages;
    if (more) wg::mbar_wait(full + 8 * sn, ((t + 1) / stages) & 1);
    // every register the two products read or write is settled before
    // the first of them
    constexpr bool kFromZero = T::kPvFromZero;
    const float c0 = corr[0], c1 = corr[1];  // tile t's
    float pv[kFromZero ? NV : 1][kFromZero ? NA / NV : 1];
#pragma unroll
    for (int x = 0; x < NV; ++x) {
      if constexpr (kFromZero) {
        wg::fence_regs(pv[x]);
      } else {
#pragma unroll
        for (int i = 0; i < NA / NV; ++i) acc[x][i] *= (i >> 1) & 1 ? c1 : c0;
        wg::fence_regs(acc[x]);
      }
    }
    wg::fence_regs(pc);
    wg::fence_regs(s);
    wg::wgmma_fence();
    if (more) issue_scores(sn);
#pragma unroll
    for (int x = 0; x < NV; ++x) {
#pragma unroll
      for (int kp = 0; kp < NP; ++kp) {
        if constexpr (kFromZero) {
          wg::mma_rs_m64k16<W / NV, 1>(pv[x], pc[kp], v_desc(st, kp, x),
                                       kp > 0);
        } else {
          wg::mma_rs_m64k16<W / NV, 1>(acc[x], pc[kp], v_desc(st, kp, x), 1);
        }
      }
    }
    wg::wgmma_commit();
    if (more) {
      wg::wgmma_wait<1>();  // S_{t+1}
      wg::fence_regs(s);
      softmax(t + 1, pn, ragged);
    }
    wg::wgmma_wait<0>();  // P_t V_t
    wg::fence_regs(pc);
#pragma unroll
    for (int x = 0; x < NV; ++x) {
      if constexpr (kFromZero) {
        wg::fence_regs(pv[x]);
#pragma unroll
        for (int i = 0; i < NA / NV; ++i) {
          acc[x][i] = fmaf(acc[x][i], (i >> 1) & 1 ? c1 : c0, pv[x][i]);
        }
      } else {
        wg::fence_regs(acc[x]);
      }
    }
    if (tid == 0) wg::mbar_arrive(empty + 8 * st);
  };

  // the key loop holds no ragged tile: the last one (S not a multiple of
  // KT) takes the mask in the tail, as does a single tile's prologue
  const bool ragged = seq_len % KT != 0;
  uint32_t pa[NP][4], pb[NP][4];
  wg::mbar_wait(full, 0);
  wg::fence_regs(s);
  wg::wgmma_fence();
  issue_scores(0);
  wg::wgmma_wait<0>();
  wg::fence_regs(s);
  softmax(0, pa, ragged && nk == 1);
  int t = 0;
  for (; t + 3 < nk; t += 2) {
    step(t, pa, pb, true, false);
    step(t + 1, pb, pa, true, false);
  }
  if (t + 3 == nk) {
    step(t, pa, pb, true, false);
    step(t + 1, pb, pa, true, ragged);
    step(t + 2, pa, pb, false, false);
  } else if (t + 2 == nk) {
    step(t, pa, pb, true, ragged);
    step(t + 1, pb, pa, false, false);
  } else {
    step(t, pa, pb, false, false);
  }

  // the head's columns: Dh, or on split heads the run-time width
  int cols = DH;
  if constexpr (kSplit) cols = lay.head_dim;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv_l = 1.f / lt;
    const int i = row0 + (lane >> 2) + 8 * r;
    if (i >= seq_len) continue;
    if (STATS && (lane & 3) == 0) {
      *reinterpret_cast<float2*>(
          stats + ((static_cast<size_t>(b) * lay.heads + h) * seq_len + i) *
                      2) = make_float2(m[r], inv_l);
    }
    bf16* dst = out + lay.out_head(b, h) + static_cast<size_t>(i) *
                lay.out_row() + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      if (8 * j >= cols) break;  // a pad column (Dh = 24)
      const float* a = acc[j / (W / 8 / NV)];
      const int jj = j % (W / 8 / NV);
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(a[4 * jj + 2 * r] * inv_l, a[4 * jj + 2 * r + 1] * inv_l);
    }
  }
}

// The rows of a block: 2 warpgroups (128 query rows) where the width takes
// two (`most`), S is above one warpgroup's 64 and 128-row blocks still give
// at least half the card's 132 SMs a block; else 1 (the 32-px levels 1 and
// 2, Dh 24 with dropout, Dh 256).
inline int wgmma_fwd_consumers(int batch, int seq_len, int heads,
                               int most) {
  const long long blocks =
      static_cast<long long>((seq_len + 127) / 128) * heads * batch;
  return most > 1 && seq_len > 64 && blocks >= 132 / 2 ? 2 : 1;
}

// One launch of the kernel of one layout and rate: its tensor maps (one
// over the packed qkv, at q, or q's, K's and V's on split heads), its rows a
// block and its ring. Split heads keep no statistics.
template <class Layout, bool DROPOUT>
cudaError_t launch_wgmma_fwd(Layout lay, int batch, const int* seed,
                             const bf16* q, const bf16* k, const bf16* v,
                             bf16* out, float* stats, float q_scale,
                             uint32_t threshold, float keep_scale,
                             cudaStream_t stream) {
  constexpr int DH = Layout::kHeadDim;
  using T = WgFwd<DH, DROPOUT>;
  constexpr bool kSplit = SplitMaps<Layout>::value;
  const CUtensorMapSwizzle swizzle =
      T::kSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap maps[3];
  if constexpr (kSplit) {
    if (stats != nullptr || lay.head_dim % 8 != 0 || lay.head_dim > DH) {
      return cudaErrorInvalidValue;
    }
    const long long row = 2LL * lay.head_dim;  // bytes
    const long long dims[4] = {lay.head_dim, lay.seq_len, lay.heads, batch};
    const long long strides[3] = {row, row * lay.seq_len,
                                  row * lay.seq_len * lay.heads};
    const int box[4] = {T::kBoxCols, T::kKeys, 1, 1};
    const bf16* bases[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
      if (!encode_tmap_4d(&maps[i], bases[i],
                          CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dims, strides, box,
                          swizzle)) {
        return cudaErrorInvalidValue;
      }
    }
  } else {
    const long long row = 3LL * lay.heads * DH * 2;  // bytes
    const long long dims[4] = {DH, 3LL * lay.heads, lay.seq_len, batch};
    const long long strides[3] = {DH * 2, row, row * lay.seq_len};
    const int box[4] = {T::kBoxCols, 1, T::kKeys, 1};
    if (!encode_tmap_4d(&maps[0], q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, dims,
                        strides, box, swizzle)) {
      return cudaErrorInvalidValue;
    }
    maps[1] = maps[2] = maps[0];
  }
  const int consumers = wgmma_fwd_consumers(batch, lay.seq_len, lay.heads,
                                            T::kMaxConsumers);
  const int nk = (lay.seq_len + T::kKeys - 1) / T::kKeys;
  const int stages = nk < T::kMaxStages ? nk : T::kMaxStages;
  const dim3 grid((lay.seq_len + T::kRows * consumers - 1) /
                      (T::kRows * consumers),
                  lay.heads, batch);
  auto* with = &attention_wgmma_fwd_kernel<Layout, DROPOUT, !kSplit>;
  auto* without = &attention_wgmma_fwd_kernel<Layout, DROPOUT, false>;
  // the largest ring's shared memory allowed once, not at every call
  static const cudaError_t allowed = [&] {
    const int most = static_cast<int>(
        T::bytes(T::kMaxConsumers, T::kMaxStages));
    const cudaError_t err = cudaFuncSetAttribute(
        with, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    return err != cudaSuccess
               ? err
               : cudaFuncSetAttribute(
                     without, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     most);
  }();
  if (allowed != cudaSuccess) return allowed;
  auto* kernel = stats != nullptr ? with : without;
  kernel<<<grid, 128 * consumers + 32, T::bytes(consumers, stages),
           stream>>>(maps[0], maps[1], maps[2], lay, seed, out, stats,
                     q_scale, threshold, keep_scale, stages);
  return cudaGetLastError();
}

// The bf16 forward of one layout: the packed qkv (Dh 24, 128 or 256) as q,
// k and v all three, or split heads' q, k and v; one launch. With stats (not
// null; packed only) the kernel also stores each query row's float32
// (m, 1/l) there, (B, H, S, 2), for the backward. The tensor maps need their
// bases 16-byte aligned; they are encoded on the host each call.
template <class Layout>
cudaError_t attention_wgmma_fwd(Layout lay, int batch, const int* seed,
                                const bf16* q, const bf16* k, const bf16* v,
                                bf16* out, float* stats, float q_scale,
                                uint32_t threshold, float keep_scale,
                                cudaStream_t stream) {
  for (const bf16* p : {q, k, v}) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return cudaErrorMisalignedAddress;
    }
  }
  return threshold > 0
             ? launch_wgmma_fwd<Layout, true>(lay, batch, seed, q, k, v, out,
                                              stats, q_scale, threshold,
                                              keep_scale, stream)
             : launch_wgmma_fwd<Layout, false>(lay, batch, seed, q, k, v, out,
                                               stats, q_scale, threshold,
                                               keep_scale, stream);
}

// out (B, S, C, bf16) from packed bf16 qkv (B, S, 3C), q * q_scale rounded
// to bf16, at the head widths built in bf16, 24, 128 and 256 (the wrappers'
// BF16_HEAD_DIMS, which pad every other width to one of them);
// cudaErrorInvalidValue at any other. With stats (a float32 (B, H, S, 2),
// or null) the kernel also stores each query row's (m, 1/l); out's bits are
// the same either way.
inline int attention_packed_fwd_bf16(const int* seed, const void* qkv,
                                     void* out, float* stats, int batch,
                                     int seq_len, int channels, int heads,
                                     int max_seq_len, float q_scale,
                                     uint32_t threshold, float keep_scale,
                                     void* stream) {
  if (heads <= 0 || channels % heads != 0 ||
      !attention_args_ok(batch, seq_len, heads, channels / heads, max_seq_len,
                         seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* in = static_cast<const bf16*>(qkv);
  auto run = [&](auto lay) {
    return attention_wgmma_fwd(lay, batch, seed, in, in, in,
                               static_cast<bf16*>(out), stats, q_scale,
                               threshold, keep_scale,
                               static_cast<cudaStream_t>(stream));
  };
  switch (channels / heads) {
    case 24: return static_cast<int>(run(PackedQkv<24>{seq_len, heads}));
    case 128: return static_cast<int>(run(PackedQkv<128>{seq_len, heads}));
    case 256: return static_cast<int>(run(PackedQkv<256>{seq_len, heads}));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 backward on packed bf16 qkv and g: dqkv (B, S, 3C) packed
// [dK | dV | dq], q scaled by the bf16 constant q_scale as the forward scales
// it, from the forward's stats (float32 (B, H, S, 2), its (m, 1/l)); dsum is
// the caller's float32 (B, H, S) scratch of D and keep, read only when
// threshold > 0, its int32 scratch of the keep bits, B H Sp^2 / 32 words (Sp
// = S rounded up to 64). dq leaves as dS K times dq_scale rounded once, or,
// with dq_round_first, rounded first and then times dq_scale (the bf16
// constant) and rounded again: `attention_bf16_dq_kernel` and
// `attention_bf16_dkv_kernel`, at the widths built in bf16 (24, 128, 256);
// cudaErrorInvalidValue at any other.
inline int attention_packed_bwd_bf16(
    const int* seed, const void* qkv, const void* g, const float* stats,
    float* dsum, void* keep, void* dqkv, int batch, int seq_len, int channels,
    int heads, int max_seq_len, float q_scale, float dq_scale,
    int dq_round_first, uint32_t threshold, float keep_scale, void* stream) {
  if (heads <= 0 || channels % heads != 0 ||
      !attention_args_ok(batch, seq_len, heads, channels / heads, max_seq_len,
                         seed, threshold)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* in = static_cast<const bf16*>(qkv);
  bf16* out = static_cast<bf16*>(dqkv);
  auto run = [&](auto lay) {
    return attention_tiled_bwd_bf16(
        lay, batch, seed, in + 2 * channels, in, in + channels,
        static_cast<const bf16*>(g), stats, dsum, static_cast<uint32_t*>(keep),
        out + 2 * channels, out, out + channels, q_scale, dq_scale,
        dq_round_first, threshold, keep_scale,
        static_cast<cudaStream_t>(stream));
  };
  switch (channels / heads) {
    case 24: return static_cast<int>(run(PackedQkv<24>{seq_len, heads}));
    case 128: return static_cast<int>(run(PackedQkv<128>{seq_len, heads}));
    case 256: return static_cast<int>(run(PackedQkv<256>{seq_len, heads}));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gpnf
