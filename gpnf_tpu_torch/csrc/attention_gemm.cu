// The qkv projection of GatedAttn and its backward (dseq, dW) around the
// key-tiled attention kernels, for S <= 512, hand-written for Hopper
// (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py, the products that
// `_fwd_kernel_proj` (`_kernel_proj_qkv`: qkv = seq w^T) and
// `_bwd_kernel_proj` (dseq = dqkv w, dW = dqkv^T seq) compute in their own
// body. For S <= 512 the JAX package runs those kernels at every width. The
// port runs the forward and the backward at every S <= 512 as these
// products around the key-tiled kernels of fused_attention_long.cu, which
// take qkv and give out or dqkv. Above S = 512 the JAX package's
// `fused_attention_long` leaves the products to XLA, and so does the port
// (torch.matmul).
//
// One kernel, c (M x N) = A (M x K) B (K x N) in float32, c row-major:
//   qkv  = seq w^T:    A = seq (B S x C),  B = w^T (w is 3C x C),  N = 3C
//   dseq = dqkv w:     A = dqkv (B S x 3C), B = w,                  N = C
//   dW   = dqkv^T seq: A = dqkv^T,          B = seq,                K = B S
// TRANS_A reads A from a (K x M) array, TRANS_B reads B from an (N x K) one.
//
// What bounds it on the H100: operations. At the CLIs' width (C = 512) and
// the 32-px level 0 (B = 16, S = 256) each of the three products is 2 x 4096
// x 1536 x 512 = 6.4 GFLOP: >= ~39 us at 3xTF32's rate on the tensor cores
// (495 / 3 TFLOP/s); the bytes (at most 4 (4096 x 1536 + 4096 x 512 +
// 1536 x 512) = 36.7 MB) need ~11 us. At the flagship's width (C = 96,
// B = 64, S = 256) each product is 0.9 GFLOP and 25.3 MB: ~5.5 us of
// operations, ~7.6 us of bytes.
//
// Design: 3xTF32 mma.sync.m16n8k8 tiles (mma_tf32.cuh: each operand split
// hi + lo, three products a k step), about fp32 accurate. A block computes
// a BM x BN tile of c with warps of WM x WN (WM / 16 x WN / 8 accumulators
// of m16n8). K runs in chunks of KC = 32 through a ring of kStages
// shared-memory stages, filled by cp.async: the chunk kStages - 1 ahead is
// in flight while a chunk is multiplied (cp.async.wait_group kStages - 2
// and one barrier a chunk). Each operand's tile keeps the array's own
// layout, so every copy is of whole rows: a tile whose rows run along k
// (A of qkv and dseq, B of qkv) has rows of KC + 4 floats; one whose rows
// run along m or n (A of dW, B of dseq and dW) has KC rows of BM + 8 or
// BN + 8 floats. Every fragment is read in the natural k order (k = tg,
// tg + 4), conflict-free at those strides (mma_tf32.cuh's header; the CPU
// test counts the banks of every load of every instantiation).
//
// The tensor cores' fp32 accumulation truncates (attention_tiled.cuh's
// forward found it): a sum kept in them over K = 1536 takes 576 truncated
// adds, ~3e-5 of its size if each drops half an ulp of same-sign terms.
// So each chunk of KC is summed into fresh accumulators (12 adds) and
// added to the block's fp32 sums with plain, rounded adds; the card test
// of same-sign inputs holds the result within 1e-5.
//
// Operands: the 16-byte path (cp.async of 4 floats) where every base is
// 16-byte aligned and every row (of A, B and c) a multiple of 4 floats;
// otherwise the same kernel copies 4 bytes at a time (VEC = false), so any
// contiguous float32 operand is taken and gives the same bits.
//
// Tiles, a pure function of the output's shape (`pick_large`): 128 x 128
// with 8 warps of 64 x 32 where those tiles cover the output with no
// ragged edge and make kLargeMinTiles blocks (qkv and dseq at C = 512, B =
// 16, S = 256), else 64 x 64 with 4 warps of 32 x 32 (a ragged 128-wide
// edge, as at N = 288, wasted a quarter of the large tiles' products: qkv
// at C = 96, B 64, S 256 ran 0.0355 ms with them, 0.0289 with 64 x 64).
// Few output tiles and a long K (dW at C = 96 has 10 tiles and K = B S up
// to 16,384) would leave most SMs idle while a few blocks walk the whole K
// axis. So K is split: `splits` blocks (blockIdx.z) per tile, split z
// summing the K rows [z chunk, min(K, (z + 1) chunk)), chunk a multiple of
// KC. The wrapper picks `splits` from the shape alone (fused_attention.py,
// `gemm_splits`: large tiles unsplit, small ones aimed at GEMM_BLOCKS = 2
// x 132 blocks). With one split the block writes c; with more, each writes
// its (M x N) partial and a second kernel adds the partials in split
// order. Every c entry sums its products in one fixed order, so two calls
// give the same bits; no atomics.
//
// ptxas (sm_90a), registers with 16-byte / 4-byte copies, no spills; the
// dynamic shared memory of 3 stages:
//   64 x 64:   qkv 123 / 167, dseq 157 / 165, dW 122 / 156; 55,296 bytes
//   128 x 128: qkv 195 / 240, dseq 231 / 235, dW 189 / 219; 110,592 /
//              107,520 / 104,448 bytes
// Chosen on the card (bench_attention --kernel gemm, NVIDIA H100 80GB
// HBM3, 700 W; PERF.md, PR 16), against variants at the 21 products of
// its cells: 2 stages up to 4.5% slower, 4 up to 10.3%, the three
// products of a k step issued pass by pass within 0.7%, 128 x 64 large
// tiles up to 15.2% and 64 x 32 warps up to 22.2% slower; none of them
// more than 2.8% faster at any product.
//
// bf16 (MarScfConfig(compute_dtype="bfloat16"), serving and training): the
// same three products on bf16 operands, as `_kernel_proj_qkv` and
// `_bwd_kernel_proj` compute them (fused_attention.py:383-390, :453-470):
// products summed in fp32, qkv and dseq rounded once to bf16, dW written in
// fp32 (the wrapper rounds it to w's dtype, as `_vjp_bwd_proj` does).
// What bounds it: bytes at the flagship (C = 96, B 64, S 256: each product
// 0.9 GFLOP, ~0.9 us at the bf16 tensor cores' 989 TFLOP/s; each 12.6 MB,
// ~3.8 us), operations at C = 512 (6.4 GFLOP, ~6.5 us; 18.4 MB, ~5.5 us).
//
// `gpnf_attention_gemm_bf16`: Hopper's machinery (wgmma_bf16.cuh),
// `gemm_wgmma_bf16_kernel`. Tiles of 128 rows (two consumer warpgroups of
// m64) by 96 or 128 columns (`wgmma_bn`: the flagship's n 288 and 96 and
// C 512's 1536 and 512 in whole tiles), K in blocks of 64 (one 128-byte
// swizzle span) through a ring of TMA loads that one producer warp keeps
// in flight on mbarriers; wgmma reads both operands from shared memory,
// K-major (qkv) or MN-major through its transpose bits (B of dseq, A and B
// of dW; an MN-major operand comes in 128-byte-swizzled boxes of 64 values,
// so a B of 96 columns is two boxes, the second's last 32 columns past the
// tile and never read), and keeps each split's sum in the tensor core's fp32
// accumulators (the float64 check of dW at K = 16,384 reads 1.6e-8 to
// 2.6e-8 of sum |products| against the plain float32 product's 1.7e-8).
// TMA's zero fill takes the ragged edges of M, N and K. The epilogue
// stages the tile in the ring, swizzled, for TMA stores. dseq's and dW's
// long K splits across a cluster of 8 blocks that sums its partials over
// DSMEM in split order, and clusters in cluster order through an arrival
// count: one launch a call, the same order every call. Two blocks share
// an SM (96 registers a thread) unless the grid fits the card, where one
// block an SM runs a deeper ring. ptxas (sm_90a): 74-96 registers; the
// clusters of 2 at tiles 128 wide with bf16 c spill 32 bytes (their
// reduction's loads), the rest none.
//
// `gpnf_attention_gemm_bf16_unaligned`, `gemm_bf16_kernel`: operands TMA
// cannot take (a base off 16 bytes, a row not a multiple of 8 values, say
// C = 20). bf16 mma.sync.m16n8k16 (mma_bf16.cuh) on the fp32 kernel's
// tiles, warps and 3-stage ring, one value copied at a time, K unsplit in
// chunks of 32 values each summed into fresh accumulators. Tiles keep the
// arrays' layouts, rows of 32 + 8 or BM / BN + 8 bf16 values, read by
// ldmatrix (A of dW and B of dseq and dW transposed, ldmatrix.trans),
// conflict-free (mma_bf16.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "wgmma_bf16.cuh"

namespace {

using gpnf::FragA;
using gpnf::FragB;

constexpr int KC = 32;  // k rows a stage holds; a split is whole chunks
constexpr int kKPad = gpnf::kTilePad;  // floats after each KC-float row
constexpr int kOuterPad = 8;  // floats after each BM- or BN-float row
constexpr int kLargeMinTiles = 128;  // 128 x 128 tiles from this many up
constexpr int kSumThreads = 256;

template <int BM_, int BN_, int WM_, int WN_, int STAGES>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kStages = STAGES;
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int MI = WM / 16;  // m16 rows of accumulators a warp
  static constexpr int NI = WN / 8;   // n8 columns
};
using Large = Tile<128, 128, 64, 32, 3>;
using Small = Tile<64, 64, 32, 32, 3>;

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

// Rows [r0, r0 + R) and columns [c0, c0 + W) of the row-major src (row
// stride ld floats) into dst (R rows of LD floats), zeros where the row
// is >= rows or the column >= cols. VEC: 16-byte copies (src, ld and cols
// multiples of 4 floats, so a chunk is all in or all out); else 4 bytes.
// Asynchronous: the caller commits and waits.
template <int R, int W, int LD, int THREADS, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long ld, int r0, int c0,
                                          int rows, int cols) {
  constexpr int kPer = VEC ? 4 : 1;
  constexpr int kRow = W / kPer;
  static_assert((R * kRow) % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < R * kRow / THREADS; ++it) {
    const int e = threadIdx.x + it * THREADS;
    const int r = e / kRow;
    const int c = kPer * (e - r * kRow);
    const bool valid = r0 + r < rows && c0 + c < cols;
    const float* from =
        valid ? src + static_cast<long long>(r0 + r) * ld + c0 + c : src;
    if (VEC) {
      gpnf::cp_async16(dst + r * LD + c, from, valid);
    } else {
      gpnf::cp_async4(dst + r * LD + c, from, valid);
    }
  }
}

// Split z = blockIdx.z of c = A B: the K rows [z chunk, min(k, (z + 1)
// chunk)) into out + z m n (out is c with one split).
template <class T, bool TRANS_A, bool TRANS_B, bool VEC>
__global__ void __launch_bounds__(T::kThreads)
    gemm_mma_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int m, int n, int k, int chunk) {
  using S = Stage<T, TRANS_A, TRANS_B>;
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ float4 gemm_smem[];
  float* smem = reinterpret_cast<float*>(gemm_smem);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(k, k_begin + chunk);
  const int nk = (k_end - k_begin + KC - 1) / KC;
  out += static_cast<long long>(blockIdx.z) * m * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int wm = (warp / T::kWarpsN) * T::WM;
  const int wn = (warp % T::kWarpsN) * T::WN;

  auto load_stage = [&](int stage, int k0) {
    float* as = smem + stage * S::kFloats;
    float* bs = as + S::kA;
    if (TRANS_A) {  // a is (k, m): KC rows of BM
      load_tile<KC, T::BM, S::kLda, T::kThreads, VEC>(as, a, m, k0, m0, k_end,
                                                      m);
    } else {  // a is (m, k): BM rows of KC
      load_tile<T::BM, KC, S::kLda, T::kThreads, VEC>(as, a, k, m0, k0, m,
                                                      k_end);
    }
    if (TRANS_B) {  // b is (n, k): BN rows of KC
      load_tile<T::BN, KC, S::kLdb, T::kThreads, VEC>(bs, b, k, n0, k0, n,
                                                      k_end);
    } else {  // b is (k, n): KC rows of BN
      load_tile<KC, T::BN, S::kLdb, T::kThreads, VEC>(bs, b, n, k0, n0, k_end,
                                                      n);
    }
  };

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < nk) load_stage(s, k_begin + s * KC);
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
    gpnf::cp_async_wait<T::kStages - 2>();
    __syncthreads();  // chunk t is in; every warp is done with chunk t - 1
    const int ahead = t + T::kStages - 1;  // into the stage chunk t - 1 held
    if (ahead < nk) load_stage(ahead % T::kStages, k_begin + ahead * KC);
    gpnf::cp_async_commit();
    const float* as = smem + (t % T::kStages) * S::kFloats;
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
        const int col = wn + 8 * j + gr;
        fb[j] = TRANS_B ? gpnf::tile_frag_bt<KC>(bs, col, kk + tg)
                        : gpnf::frag_b_kmajor<S::kLdb>(bs, kk + tg, col);
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
      const int row = m0 + wm + 16 * i + gr + 8 * h;
      if (row >= m) continue;
      float* dst = out + static_cast<long long>(row) * n;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + wn + 8 * j + 2 * tg;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (VEC && col < n) {  // n a multiple of 4: col + 1 < n too
          *reinterpret_cast<float2*>(dst + col) = make_float2(x, y);
        } else {
          if (col < n) dst[col] = x;
          if (col + 1 < n) dst[col + 1] = y;
        }
      }
    }
  }
}

// c[i] = sum over z of partial[z][i], z in order: the splits' fixed-order
// sum.
__global__ void __launch_bounds__(kSumThreads)
    sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ c,
                      long long count, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kSumThreads +
                      threadIdx.x;
  if (i >= count) return;
  float acc = partial[i];
  for (int z = 1; z < splits; ++z) acc += partial[z * count + i];
  c[i] = acc;
}

template <class T, bool TRANS_A, bool TRANS_B, bool VEC>
cudaError_t launch_tiles(const float* a, const float* b, float* out, int m,
                         int n, int k, int splits, int chunk,
                         cudaStream_t stream) {
  using S = Stage<T, TRANS_A, TRANS_B>;
  const auto kernel = gemm_mma_kernel<T, TRANS_A, TRANS_B, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM, splits);
  kernel<<<grid, T::kThreads, S::kBytes, stream>>>(a, b, out, m, n, k, chunk);
  return cudaGetLastError();
}

template <bool TRANS_A, bool TRANS_B>
cudaError_t launch(bool large, bool vec, const float* a, const float* b,
                   float* out, int m, int n, int k, int splits, int chunk,
                   cudaStream_t s) {
  if (large) {
    return vec ? launch_tiles<Large, TRANS_A, TRANS_B, true>(
                     a, b, out, m, n, k, splits, chunk, s)
               : launch_tiles<Large, TRANS_A, TRANS_B, false>(
                     a, b, out, m, n, k, splits, chunk, s);
  }
  return vec ? launch_tiles<Small, TRANS_A, TRANS_B, true>(a, b, out, m, n, k,
                                                           splits, chunk, s)
             : launch_tiles<Small, TRANS_A, TRANS_B, false>(
                   a, b, out, m, n, k, splits, chunk, s);
}

// 128 x 128 tiles where they cover the output with no ragged edge and make
// kLargeMinTiles blocks, else 64 x 64 (fused_attention.py's `gemm_tile`
// mirrors it).
bool pick_large(int m, int n) {
  return m % Large::BM == 0 && n % Large::BN == 0 &&
         static_cast<long long>(m / Large::BM) * (n / Large::BN) >=
             kLargeMinTiles;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// -- bf16 on operands the TMA cannot take: qkv, dseq, dW ------------------------------
using gpnf::bf16;
constexpr int kBf16Kc = 32;  // k values a stage holds: two k16 steps

// The shared memory of one bf16 stage: A's tile, then B's, in bf16 values;
// a tile whose rows run along k has rows of KC + 8 values, one whose rows
// run along m or n rows of BM + 8 or BN + 8 (mma_bf16.cuh: conflict-free).
template <class T, bool TRANS_A, bool TRANS_B>
struct StageBf16 {
  static constexpr int kLda = TRANS_A ? T::BM + gpnf::kBf16Pad
                                      : kBf16Kc + gpnf::kBf16Pad;
  static constexpr int kLdb = TRANS_B ? kBf16Kc + gpnf::kBf16Pad
                                      : T::BN + gpnf::kBf16Pad;
  static constexpr int kA = TRANS_A ? kBf16Kc * kLda : T::BM * kLda;
  static constexpr int kB = TRANS_B ? T::BN * kLdb : kBf16Kc * kLdb;
  static constexpr int kVals = kA + kB;
  static constexpr size_t kBytes = sizeof(bf16) * T::kStages * kVals;
};

// Rows [r0, r0 + R) and columns [c0, c0 + W) of the row-major bf16 src (row
// stride ld values) into dst (R rows of LD values), one value at a time by
// plain loads and stores (which the barrier before the stage's use
// orders), zeros where the row is >= rows or the column >= cols.
template <int R, int W, int LD, int THREADS>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long ld, int r0, int c0,
                                               int rows, int cols) {
  for (int e = threadIdx.x; e < R * W; e += THREADS) {
    const int r = e / W;
    const int c = e - r * W;
    const bool valid = r0 + r < rows && c0 + c < cols;
    dst[r * LD + c] = valid ? src[static_cast<long long>(r0 + r) * ld + c0 + c]
                            : __float2bfloat16_rn(0.f);
  }
}

// c = A B in bf16 (A m x k, B k x n) on any contiguous operands: the K
// rows summed in fp32, each KC chunk into fresh accumulators, into out:
// bf16 (rounded once) where out_bf16, else float32 (dW).
template <class T, bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__(T::kThreads)
    gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                     void* __restrict__ out, int m, int n, int k,
                     int out_bf16) {
  using S = StageBf16<T, TRANS_A, TRANS_B>;
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ float4 gemm_smem[];
  bf16* smem = reinterpret_cast<bf16*>(gemm_smem);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int nk = (k + kBf16Kc - 1) / kBf16Kc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;
  const int tg = lane & 3;
  const int wm = (warp / T::kWarpsN) * T::WM;
  const int wn = (warp % T::kWarpsN) * T::WN;

  auto load_stage = [&](int stage, int k0) {
    bf16* as = smem + stage * S::kVals;
    bf16* bs = as + S::kA;
    if (TRANS_A) {  // a is (k, m): KC rows of BM
      load_tile_bf16<kBf16Kc, T::BM, S::kLda, T::kThreads>(as, a, m, k0, m0,
                                                           k, m);
    } else {  // a is (m, k): BM rows of KC
      load_tile_bf16<T::BM, kBf16Kc, S::kLda, T::kThreads>(as, a, k, m0, k0,
                                                           m, k);
    }
    if (TRANS_B) {  // b is (n, k): BN rows of KC
      load_tile_bf16<T::BN, kBf16Kc, S::kLdb, T::kThreads>(bs, b, k, n0, k0,
                                                           n, k);
    } else {  // b is (k, n): KC rows of BN
      load_tile_bf16<kBf16Kc, T::BN, S::kLdb, T::kThreads>(bs, b, n, k0, n0,
                                                           k, n);
    }
  };

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < nk) load_stage(s, s * kBf16Kc);
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
    __syncthreads();  // chunk t is in; every warp is done with chunk t - 1
    const int ahead = t + T::kStages - 1;  // into the stage chunk t - 1 held
    if (ahead < nk) load_stage(ahead % T::kStages, ahead * kBf16Kc);
    const bf16* as = smem + (t % T::kStages) * S::kVals;
    const bf16* bs = as + S::kA;
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        part[i][j][0] = part[i][j][1] = part[i][j][2] = part[i][j][3] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBf16Kc; kk += 16) {
      uint32_t fb[NI / 2][4];
#pragma unroll
      for (int jp = 0; jp < NI / 2; ++jp) {
        if (TRANS_B) {
          gpnf::frag_b_bf16_pair<S::kLdb>(fb[jp], bs, wn + 16 * jp, kk, lane);
        } else {
          gpnf::frag_b_bf16_trans_pair<S::kLdb>(fb[jp], bs, kk, wn + 16 * jp,
                                                lane);
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t fa[4];
        if (TRANS_A) {
          gpnf::frag_a_bf16_trans<S::kLda>(fa, as, kk, wm + 16 * i, lane);
        } else {
          gpnf::frag_a_bf16<S::kLda>(fa, as, wm + 16 * i, kk, lane);
        }
#pragma unroll
        for (int jp = 0; jp < NI / 2; ++jp) {
          gpnf::mma_bf16(part[i][2 * jp], fa, fb[jp][0], fb[jp][1]);
          gpnf::mma_bf16(part[i][2 * jp + 1], fa, fb[jp][2], fb[jp][3]);
        }
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
      const int row = m0 + wm + 16 * i + gr + 8 * h;
      if (row >= m) continue;
      const long long at = static_cast<long long>(row) * n;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + wn + 8 * j + 2 * tg;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (out_bf16) {
          bf16* dst = static_cast<bf16*>(out) + at;
          if (col < n) dst[col] = __float2bfloat16_rn(x);
          if (col + 1 < n) dst[col + 1] = __float2bfloat16_rn(y);
        } else {
          float* dst = static_cast<float*>(out) + at;
          if (col < n) dst[col] = x;
          if (col + 1 < n) dst[col + 1] = y;
        }
      }
    }
  }
}

template <class T, bool TRANS_A, bool TRANS_B>
cudaError_t launch_tiles_bf16(const bf16* a, const bf16* b, void* out, int m,
                              int n, int k, int out_bf16,
                              cudaStream_t stream) {
  using S = StageBf16<T, TRANS_A, TRANS_B>;
  const auto kernel = gemm_bf16_kernel<T, TRANS_A, TRANS_B>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM);
  kernel<<<grid, T::kThreads, S::kBytes, stream>>>(a, b, out, m, n, k,
                                                   out_bf16);
  return cudaGetLastError();
}

template <bool TRANS_A, bool TRANS_B>
cudaError_t launch_bf16(bool large, const bf16* a, const bf16* b, void* out,
                        int m, int n, int k, int out_bf16, cudaStream_t s) {
  return large ? launch_tiles_bf16<Large, TRANS_A, TRANS_B>(a, b, out, m, n,
                                                            k, out_bf16, s)
               : launch_tiles_bf16<Small, TRANS_A, TRANS_B>(a, b, out, m, n,
                                                            k, out_bf16, s);
}

// -- bf16 on Hopper's machinery: TMA loads, mbarriers, wgmma -------------------------
namespace wg = gpnf::wgmma;

constexpr int kWgBM = 128;  // output rows a block: two consumer warpgroups
constexpr int kWgBK = 64;   // k values a stage: one 128-byte K-major row
// the ring: 2 stages at least; at most kWgSharedStages where the grid has
// more blocks than the card has SMs (two blocks an SM then share it), else
// kWgMaxStages (one block an SM: the deepest ring keeps the most loads of
// a long K in flight)
constexpr int kWgMinStages = 2;
constexpr int kWgSharedStages = 3;
constexpr int kWgMaxStages = 6;
constexpr int kWgSms = 132;  // the H100 SXM's SMs
constexpr int kWgBlocksPerSm = 2;
constexpr int kWgAtom = 64;  // m or n values of an MN-major box (128 bytes)
constexpr int kWgConsumers = 2;
constexpr int kWgThreads = 128 * kWgConsumers + 32;  // and a producer warp
constexpr int kWgStoreCols = 32;  // output columns of a TMA store box
constexpr int kWgSwizzle = 128;   // every operand: rows of 128 bytes
constexpr int kWgSboK = 8 * kWgSwizzle;   // K-major: the next 8 rows (m or n)
constexpr int kWgSboMn = 8 * kWgSwizzle;  // MN-major: the next 8 rows of k
constexpr int kWgLboMn = kWgBK * kWgSwizzle;  // MN-major: the next atom
constexpr int kWgLboK = 16;  // not read for a swizzled K-major operand
// the splits of a tile a cluster sums: 8 where the splits are a multiple of
// 8, else 2 (2, 4 or 6 splits: a long K over more tiles than 8 splits
// could keep within the card)
constexpr int kWgCluster = 8;
constexpr int kWgPair = 2;

// The shared memory of one block: `stages` stages of A (BM x BK) and B (BN,
// or MN-major whole atoms of it, x BK), on the 1024-byte period of the
// swizzle; the output tile staged in the ring once the products are done;
// the full and empty barriers of the ring and the last-split flag.
template <int BN, bool B_MN, bool OUT_BF16>
struct WgTile {
  static constexpr int kABytes = kWgBM * kWgBK * 2;
  static constexpr int kBCols =
      B_MN ? (BN + kWgAtom - 1) / kWgAtom * kWgAtom : BN;
  static constexpr int kBBytes = kBCols * kWgBK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOutElem = OUT_BF16 ? 2 : 4;
  // a warpgroup's 64 rows, in boxes of 64 x kWgStoreCols
  static constexpr int kStoreBoxBytes = 64 * kWgStoreCols * kOutElem;
  static constexpr int kOutHalfBytes = BN / kWgStoreCols * kStoreBoxBytes;
  static constexpr size_t bytes(int stages) {
    return 1024 + static_cast<size_t>(stages) * kStageBytes +
           2 * kWgMaxStages * 8 + 16;
  }
  static_assert(kABytes % 1024 == 0 && kBBytes % 1024 == 0 &&
                    kStoreBoxBytes % 1024 == 0,
                "every tile on the swizzle patterns' 1024-byte period");
  static_assert(BN % kWgStoreCols == 0, "whole store boxes");
  static_assert(kWgConsumers * kOutHalfBytes <= kWgMinStages * kStageBytes &&
                    kWgBM * BN * 4 <= kWgMinStages * kStageBytes,
                "the staged output and a split's partial fit the ring");
};

// The byte of (row, col) of a warpgroup's staged output: boxes of
// kWgStoreCols columns, 64 rows of kWgStoreCols values each, swizzled as the
// TMA store reads them (64-byte rows of bf16: 64-byte swizzle; 128-byte
// rows of fp32: 128-byte swizzle), so a warp's 8 rows of one store fall on
// distinct banks.
template <bool OUT_BF16>
__device__ __forceinline__ uint32_t out_offset(int row, int col) {
  constexpr int kElem = OUT_BF16 ? 2 : 4;
  constexpr uint32_t kRowBytes = kWgStoreCols * kElem;
  constexpr uint32_t kMask = kRowBytes / 16 - 1;
  const uint32_t off = (col / kWgStoreCols) * 64 * kRowBytes +
                       row * kRowBytes + (col % kWgStoreCols) * kElem;
  return off ^ (((off >> 7) & kMask) << 4);
}

// c (m x n) = A B in bf16 with fp32 sums, one output tile of kWgBM x BN a
// block, split z = blockIdx.z of K: k-blocks [z per, min(kb, (z + 1) per))
// of kWgBK. A_MN: A read from (k x m), m contiguous (dW's dqkv^T), else
// from (m x k); B_MN: B read from (k x n) (dseq's w, dW's seq), else from
// (n x k) (qkv's w). Warp 8 is the producer: its lane 0 keeps the ring of
// `stages` stages filled by TMA, each stage's bytes completing on full[s],
// each reuse waiting on empty[s], which both consumer warpgroups release.
// Warpgroup g multiplies rows 64 g .. 64 g + 63 of the tile: a batch of 4
// wgmma k16 steps a stage into its fp32 accumulators, kept in the tensor
// core across the split's whole range, one batch in flight while the next
// is issued.
//
// One split: the tile rounded (OUT_BF16) or not, staged in the ring's
// shared memory and written by TMA stores. More: the splits of a tile run
// as clusters of CS blocks (blockIdx.z / CS the cluster, its rank the
// split within it). Each block leaves its fp32 partial in its shared
// memory; block r of the cluster adds rows 128 r / CS .. of the cluster's
// CS partials (the fragments of warps 8 r / CS ..) in split order, read
// across the cluster (DSMEM) in whole 512-byte runs, so the cluster's sum
// takes one pass spread over CS SMs. One cluster a tile: block r writes
// those rows of c. More: it writes them to partial (its slab of the
// caller's scratch) and bumps counters[tile CS + r];
// the block that arrives last for those rows adds the clusters' sums in
// cluster order, writes the rows of c and resets the counter. One launch,
// the same order every call, no atomics on values.
template <int BN, bool A_MN, bool B_MN, bool OUT_BF16, int CS>
__global__ void __launch_bounds__(kWgThreads, kWgBlocksPerSm)
    gemm_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap tmap_a,
                           const __grid_constant__ CUtensorMap tmap_b,
                           const __grid_constant__ CUtensorMap tmap_c,
                           void* __restrict__ c, float* __restrict__ partial,
                           int* __restrict__ counters, int m, int n, int k,
                           int per, int stages) {
  using T = WgTile<BN, B_MN, OUT_BF16>;
  extern __shared__ uint8_t wg_smem_raw[];
  const uint32_t raw = wg::smem_u32(wg_smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = wg_smem_raw + (base - raw);
  const uint32_t full = base + stages * T::kStageBytes;  // kWgMaxStages each
  const uint32_t empty = full + 8 * kWgMaxStages;
  int* last_flag =
      reinterpret_cast<int*>(smem + stages * T::kStageBytes + 16 * kWgMaxStages);
  const int m0 = blockIdx.y * kWgBM, n0 = blockIdx.x * BN;
  const int kb_all = (k + kWgBK - 1) / kWgBK;
  const int kb0 = blockIdx.z * per;
  const int nkb = min(kb_all, kb0 + per) - kb0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool split = gridDim.z > 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, kWgConsumers);
    }
    wg::fence_barrier_init();
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int g = warp >> 2;  // the consumer warpgroup
  const int t = threadIdx.x & 127;
  if (warp == 4 * kWgConsumers) {  // the producer
    if (lane == 0) {
      wg::prefetch_tmap(&tmap_a);
      wg::prefetch_tmap(&tmap_b);
      // an MN-major box wholly past the edge is not loaded: its columns of
      // A (rows of c) or of B (columns of c) are never stored
      const int a_boxes =
          A_MN ? min(kWgBM / kWgAtom, (m - m0 + kWgAtom - 1) / kWgAtom) : 1;
      const int b_boxes =
          B_MN ? min(T::kBCols / kWgAtom, (n - n0 + kWgAtom - 1) / kWgAtom)
               : 1;
      const uint32_t box_mn = kWgAtom * kWgBK * 2;
      const uint32_t bytes = (A_MN ? a_boxes * box_mn : T::kABytes) +
                             (B_MN ? b_boxes * box_mn : T::kBBytes);
      int s = 0, use = 0;
      for (int it = 0; it < nkb; ++it) {
        if (use > 0) wg::mbar_wait(empty + 8 * s, (use - 1) & 1);
        const uint32_t bar = full + 8 * s;
        wg::mbar_expect_tx(bar, bytes);
        const int k0 = (kb0 + it) * kWgBK;
        const uint32_t a_dst = base + s * T::kStageBytes;
        const uint32_t b_dst = a_dst + T::kABytes;
        if (A_MN) {
          for (int j = 0; j < a_boxes; ++j) {
            wg::tma_load_2d(a_dst + j * kWgLboMn, &tmap_a, m0 + kWgAtom * j,
                            k0, bar);
          }
        } else {
          wg::tma_load_2d(a_dst, &tmap_a, k0, m0, bar);
        }
        if (B_MN) {
          for (int j = 0; j < b_boxes; ++j) {
            wg::tma_load_2d(b_dst + j * kWgLboMn, &tmap_b, n0 + kWgAtom * j,
                            k0, bar);
          }
        } else {
          wg::tma_load_2d(b_dst, &tmap_b, k0, n0, bar);
        }
        if (++s == stages) {
          s = 0;
          ++use;
        }
      }
    }
    if (!split) return;
  } else {  // the consumers: warpgroup g, rows 64 g .. 64 g + 63
    int s = 0, use = 0, prev = -1;
    for (int it = 0; it < nkb; ++it) {
      wg::mbar_wait(full + 8 * s, use & 1);
      const uint32_t a_tile = base + s * T::kStageBytes +
                              (A_MN ? g * (64 / kWgAtom) * kWgLboMn
                                    : g * 64 * kWgSwizzle);
      const uint32_t b_tile = base + s * T::kStageBytes + T::kABytes;
      wg::fence_regs(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t da =
            A_MN ? wg::make_desc(a_tile + kk * 16 * kWgSwizzle, kWgLboMn,
                                 kWgSboMn, wg::kSwizzle128)
                 : wg::make_desc(a_tile + kk * 32, kWgLboK, kWgSboK,
                                 wg::kSwizzle128);
        const uint64_t db =
            B_MN ? wg::make_desc(b_tile + kk * 16 * kWgSwizzle, kWgLboMn,
                                 kWgSboMn, wg::kSwizzle128)
                 : wg::make_desc(b_tile + kk * 32, kWgLboK, kWgSboK,
                                 wg::kSwizzle128);
        wg::mma_m64k16<BN, A_MN, B_MN>(acc, da, db, 1);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<1>();  // the batch before this one is done
      wg::fence_regs(acc);
      if (prev >= 0 && t == 0) wg::mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == stages) {
        s = 0;
        ++use;
      }
    }
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
  }

  if (!split) {
    // the epilogue: both warpgroups done with the ring, stage each one's
    // 64 rows in it (values 4 j + {0, 1} at (r, c), (r, c + 1), 4 j + {2,
    // 3} at (r + 8, ..), r = 16 (warp % 4) + lane / 4, c = 8 j + 2 (lane %
    // 4)), then TMA stores
    wg::named_sync(1, 128 * kWgConsumers);
    uint8_t* half = smem + g * T::kOutHalfBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * (warp & 3) + (lane >> 2) + 8 * h;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t off = out_offset<OUT_BF16>(row, 8 * j + 2 * (lane & 3));
        const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
        if (OUT_BF16) {
          *reinterpret_cast<uint32_t*>(half + off) = gpnf::pack_bf16(x, y);
        } else {
          *reinterpret_cast<float2*>(half + off) = make_float2(x, y);
        }
      }
    }
    wg::fence_proxy_async();
    wg::named_sync(2 + g, 128);
    const int row0 = m0 + 64 * g;
    if (t == 0 && row0 < m) {
      for (int j = 0; j < BN / kWgStoreCols && n0 + kWgStoreCols * j < n;
           ++j) {
        wg::tma_store_2d(&tmap_c,
                         base + g * T::kOutHalfBytes + j * T::kStoreBoxBytes,
                         n0 + kWgStoreCols * j, row0);
      }
      wg::tma_store_commit();
      wg::tma_store_wait_read();
    }
    return;
  }

  // split K: every thread of the block from here. The partial in shared
  // memory (the ring is free: every stage was consumed) in fragment order:
  // float4 i (values 4 i .. 4 i + 3) of lane l of warp w at (w BN / 8 + i)
  // 32 + l, so warp w's rows 16 w .. 16 w + 15 of the tile are one
  // contiguous block that a warp reads 512 bytes at a time
  __syncthreads();
  constexpr int kQuads = BN / 8;     // float4s a thread
  constexpr int kBlock = 32 * kQuads;  // float4s a warp
  if (warp < 4 * kWgConsumers) {
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      *reinterpret_cast<float4*>(smem + 16 * ((warp * kQuads + i) * 32 +
                                              lane)) =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                      acc[4 * i + 3]);
    }
  }
  wg::cluster_sync();
  // block r of the cluster sums the blocks of warps r 8 / CS .. (r + 1) 8 /
  // CS - 1 (rows 128 r / CS ..) of the cluster's CS partials in rank
  // (split) order: thread u its items u, u + 256, .. of them, every load
  // issued before the first add
  constexpr int kItems = 8 / CS * kBlock;  // float4s a block sums
  constexpr int kMine = (kItems + 128 * kWgConsumers - 1) /
                        (128 * kWgConsumers);
  const int rank = static_cast<int>(wg::cluster_rank());
  const int u = threadIdx.x;
  float4 sum[kMine];
  if (u < 128 * kWgConsumers) {
    float4 v[kMine][CS];
#pragma unroll
    for (int h = 0; h < kMine; ++h) {
      const int i = u + 128 * kWgConsumers * h;
      const uint32_t at = base + 16 * (rank * kItems + min(i, kItems - 1));
#pragma unroll
      for (int z = 0; z < CS; ++z) v[h][z] = wg::ld_cluster_f4(at, z);
    }
#pragma unroll
    for (int h = 0; h < kMine; ++h) {
      sum[h] = v[h][0];
#pragma unroll
      for (int z = 1; z < CS; ++z) {
        sum[h].x += v[h][z].x;
        sum[h].y += v[h][z].y;
        sum[h].z += v[h][z].z;
        sum[h].w += v[h][z].w;
      }
    }
  }
  wg::cluster_sync();  // every block's partial read: the blocks may leave
  if (u >= 128 * kWgConsumers) return;
  const int clusters = gridDim.z / CS;
  if (clusters > 1) {
    // the cluster's items to its slab of the scratch, then the last
    // cluster to arrive for these rows adds every cluster's in order
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int tiles = gridDim.x * gridDim.y;
    const int cl = blockIdx.z / CS;
    float4* slab = reinterpret_cast<float4*>(partial) +
                   (static_cast<long long>(tile) * CS + rank) * kItems;
    const long long stride = static_cast<long long>(tiles) * CS *
                             kItems;  // float4s a cluster
#pragma unroll
    for (int h = 0; h < kMine; ++h) {
      const int i = u + 128 * kWgConsumers * h;
      if (i < kItems) slab[cl * stride + i] = sum[h];
    }
    __threadfence();
    wg::named_sync(1, 128 * kWgConsumers);
    int* counter = counters + tile * CS + rank;
    if (u == 0) *last_flag = atomicAdd(counter, 1) == clusters - 1;
    wg::named_sync(1, 128 * kWgConsumers);
    if (!*last_flag) return;
    __threadfence();
#pragma unroll
    for (int h = 0; h < kMine; ++h) {
      const int i = u + 128 * kWgConsumers * h;
      if (i >= kItems) continue;
      const float4 mine = sum[h];
      for (int z = 0; z < clusters; ++z) {
        const float4 v = z == cl ? mine : __ldcg(slab + z * stride + i);
        if (z == 0) {
          sum[h] = v;
        } else {
          sum[h].x += v.x;
          sum[h].y += v.y;
          sum[h].z += v.z;
          sum[h].w += v.w;
        }
      }
    }
    if (u == 0) *counter = 0;  // every cluster has arrived
  }
  // item i: float4 e = i % kBlock of warp w = r 8 / CS + i / kBlock, lane l
  // = e % 32, quad q = e / 32: (r0, c), (r0, c + 1), (r0 + 8, c), (r0 + 8,
  // c + 1), r0 = 16 w + l / 4, c = 8 q + 2 (l % 4)
#pragma unroll
  for (int h = 0; h < kMine; ++h) {
    const int i = u + 128 * kWgConsumers * h;
    if (i >= kItems) continue;
    const int e = i % kBlock, l = e % 32;
    const int w = rank * (8 / CS) + i / kBlock;
    const int col = n0 + 8 * (e / 32) + 2 * (l % 4);
    if (col >= n) continue;  // n is even: the pair is in or out
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + 16 * w + l / 4 + 8 * half;
      if (row >= m) continue;
      const float x = half ? sum[h].z : sum[h].x;
      const float y = half ? sum[h].w : sum[h].y;
      const long long at = static_cast<long long>(row) * n + col;
      if (OUT_BF16) {
        *reinterpret_cast<uint32_t*>(static_cast<gpnf::bf16*>(c) + at) =
            gpnf::pack_bf16(x, y);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(c) + at) =
            make_float2(x, y);
      }
    }
  }
}

// The output tile's width for n columns: 128 where it divides n (the CLIs'
// C 512: n 1536 and 512), else 96 (the flagship's n 288 and 96 in whole
// tiles; fused_attention.py's `wgmma_tile` mirrors it).
int wgmma_bn(int n) { return n % 128 == 0 ? 128 : 96; }

// The ring's depth for `blocks` blocks of splits of `per` k-blocks: per,
// held to kWgMinStages .. kWgSharedStages, or .. kWgMaxStages where the
// grid fits the card's SMs (fused_attention.py's `wgmma_stages`).
int wgmma_stages(int per, long long blocks) {
  const int most = blocks <= kWgSms ? kWgMaxStages : kWgSharedStages;
  return per < kWgMinStages ? kWgMinStages : per > most ? most : per;
}

// One call of the kernel: its tensor maps and arguments.
struct WgCall {
  CUtensorMap ta, tb, tc;
  void* c;
  float* partial;
  int* counters;
  int m, n, k, splits, per;
};

// The cluster size of `splits` splits: 1 unsplit, else kWgCluster or
// kWgPair (`wgmma_cluster` in fused_attention.py), 0 for a count neither
// takes.
int wgmma_cluster(int splits) {
  if (splits == 1) return 1;
  if (splits % kWgCluster == 0) return kWgCluster;
  return splits <= 3 * kWgPair && splits % kWgPair == 0 ? kWgPair : 0;
}

template <int BN, bool A_MN, bool B_MN, bool OUT_BF16, int CS>
cudaError_t launch_wgmma(const WgCall& a, cudaStream_t stream) {
  using T = WgTile<BN, B_MN, OUT_BF16>;
  const auto kernel = gemm_wgmma_bf16_kernel<BN, A_MN, B_MN, OUT_BF16, CS>;
  const dim3 grid((a.n + BN - 1) / BN, (a.m + kWgBM - 1) / kWgBM, a.splits);
  const int stages = wgmma_stages(
      a.per, static_cast<long long>(grid.x) * grid.y * grid.z);
  static bool attribute_set = false;  // the deepest ring's bytes allowed
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(T::bytes(kWgMaxStages)));
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kWgThreads);
  config.dynamicSmemBytes = T::bytes(stages);
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = wgmma_cluster(a.splits);
  config.attrs = cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, a.ta, a.tb, a.tc, a.c, a.partial,
                            a.counters, a.m, a.n, a.k, a.per, stages);
}

template <int BN, bool A_MN, bool B_MN, bool OUT_BF16>
cudaError_t launch_wgmma_cs(const WgCall& a, cudaStream_t s) {
  return wgmma_cluster(a.splits) == kWgPair
             ? launch_wgmma<BN, A_MN, B_MN, OUT_BF16, kWgPair>(a, s)
             : launch_wgmma<BN, A_MN, B_MN, OUT_BF16, kWgCluster>(a, s);
}

template <int BN, bool A_MN, bool B_MN>
cudaError_t launch_wgmma_out(bool out_bf16, const WgCall& a, cudaStream_t s) {
  return out_bf16 ? launch_wgmma_cs<BN, A_MN, B_MN, true>(a, s)
                  : launch_wgmma_cs<BN, A_MN, B_MN, false>(a, s);
}

template <bool A_MN, bool B_MN>
cudaError_t launch_wgmma_bn(int bn, bool out_bf16, const WgCall& a,
                            cudaStream_t s) {
  return bn == 128 ? launch_wgmma_out<128, A_MN, B_MN>(out_bf16, a, s)
                   : launch_wgmma_out<96, A_MN, B_MN>(out_bf16, a, s);
}

}  // namespace

// c (m x n) = A B as above; trans_a and trans_b are 0 or 1, not both 1
// (no product of the three reads both operands transposed). K is cut into
// `splits` ranges of chunk = 32 ceil(ceil(k / 32) / splits) rows, none of
// them empty; with more than one, `partial` is the caller's (splits, m, n)
// scratch (unused, and may be null, with one).
extern "C" int gpnf_attention_gemm(const float* a, const float* b, float* c,
                                   float* partial, int m, int n, int k,
                                   int trans_a, int trans_b, int splits,
                                   void* stream) {
  const int chunks = (k + KC - 1) / KC;
  const int chunk = splits > 0 ? KC * ((chunks + splits - 1) / splits) : 0;
  const bool large = m > 0 && n > 0 && pick_large(m, n);
  const int block_rows = large ? Large::BM : Small::BM;
  if (m <= 0 || n <= 0 || k <= 0 || (m + block_rows - 1) / block_rows > 65535 ||
      (trans_a && trans_b) || splits <= 0 || splits > 65535 ||
      static_cast<long long>(splits - 1) * chunk >= k ||
      (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* out = splits > 1 ? partial : c;
  const int lda = trans_a ? m : k, ldb = trans_b ? k : n;
  const bool vec = aligned16(a) && aligned16(b) && aligned16(out) &&
                   lda % 4 == 0 && ldb % 4 == 0 && n % 4 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      trans_a   ? launch<true, false>(large, vec, a, b, out, m, n, k, splits,
                                      chunk, s)
      : trans_b ? launch<false, true>(large, vec, a, b, out, m, n, k, splits,
                                      chunk, s)
                : launch<false, false>(large, vec, a, b, out, m, n, k, splits,
                                       chunk, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(m) * n;
  sum_splits_kernel<<<static_cast<unsigned>((count + kSumThreads - 1) /
                                            kSumThreads),
                      kSumThreads, 0, s>>>(partial, c, count, splits);
  return static_cast<int>(cudaGetLastError());
}

// c (m x n) = A B in bf16 on Hopper's TMA and wgmma, as gpnf_attention_gemm
// lays out A and B: qkv = seq w^T (trans_b), dseq = dqkv w (neither), dW =
// dqkv^T seq (trans_a); the sums in float32, c bf16 rounded once where
// out_bf16, else float32. K in `splits` ranges (1, 2, 4, 6 or a multiple
// of kWgCluster: `wgmma_cluster`) of per = ceil(ceil(k / 64) / splits)
// k-blocks of 64, none empty, summed in one launch. With more splits than
// a cluster, `partial` is the caller's float32 scratch of one slab of
// (tiles, kWgBM, BN) a cluster and `counters` its int32 arrival counters,
// kWgCluster a (kWgBM x BN) tile of c, zero before the call and left zero
// after it (the caller keeps
// them for one stream: two launches at once on one buffer would mix their
// arrivals). Takes a, b and c on 16-byte boundaries with lda, ldb and n
// multiples of 8 values (TMA's rule for a base and a row stride); refuses
// the rest (gpnf_attention_gemm_bf16_unaligned takes it).
extern "C" int gpnf_attention_gemm_bf16(const void* a, const void* b, void* c,
                                        float* partial, int* counters, int m,
                                        int n, int k, int trans_a, int trans_b,
                                        int splits, int out_bf16,
                                        void* stream) {
  const int kb = (k + kWgBK - 1) / kWgBK;
  const int per = splits > 0 ? (kb + splits - 1) / splits : 0;
  const int lda = trans_a ? m : k, ldb = trans_b ? k : n;
  if (m <= 0 || n <= 0 || k <= 0 || (m + kWgBM - 1) / kWgBM > 65535 ||
      (trans_a && trans_b) || splits <= 0 || splits > 65535 ||
      wgmma_cluster(splits) == 0 ||
      static_cast<long long>(splits - 1) * per >= kb ||
      (splits > wgmma_cluster(splits) &&
       (partial == nullptr || counters == nullptr)) ||
      !aligned16(a) || !aligned16(b) || !aligned16(c) || lda % 8 != 0 ||
      ldb % 8 != 0 || n % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bn = wgmma_bn(n);
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  WgCall call;
  const bool ok =
      (trans_a ? gpnf::encode_tmap_2d(&call.ta, a, bf, 2, k, m, m, kWgBK,
                                      kWgAtom, CU_TENSOR_MAP_SWIZZLE_128B)
               : gpnf::encode_tmap_2d(&call.ta, a, bf, 2, m, k, k, kWgBM,
                                      kWgBK, CU_TENSOR_MAP_SWIZZLE_128B)) &&
      (trans_b ? gpnf::encode_tmap_2d(&call.tb, b, bf, 2, n, k, k, bn, kWgBK,
                                      CU_TENSOR_MAP_SWIZZLE_128B)
               : gpnf::encode_tmap_2d(&call.tb, b, bf, 2, k, n, n, kWgBK,
                                      kWgAtom, CU_TENSOR_MAP_SWIZZLE_128B)) &&
      (out_bf16 ? gpnf::encode_tmap_2d(&call.tc, c, bf, 2, m, n, n, 64,
                                       kWgStoreCols,
                                       CU_TENSOR_MAP_SWIZZLE_64B)
                : gpnf::encode_tmap_2d(&call.tc, c,
                                       CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, m,
                                       n, n, 64, kWgStoreCols,
                                       CU_TENSOR_MAP_SWIZZLE_128B));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  call.c = c;
  call.partial = partial;
  call.counters = counters;
  call.m = m;
  call.n = n;
  call.k = k;
  call.splits = splits;
  call.per = per;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool ob = out_bf16 != 0;
  const cudaError_t err =
      trans_a   ? launch_wgmma_bn<true, true>(bn, ob, call, s)
      : trans_b ? launch_wgmma_bn<false, false>(bn, ob, call, s)
                : launch_wgmma_bn<false, true>(bn, ob, call, s);
  return static_cast<int>(err);
}

// The same product on any contiguous bf16 operands (a base off a 16-byte
// boundary, or a row stride or n that is not a multiple of 8 values), by
// gemm_bf16_kernel: mma.sync on 64 x 64 or 128 x 128 tiles (`pick_large`),
// one value copied at a time, K unsplit.
extern "C" int gpnf_attention_gemm_bf16_unaligned(const void* a, const void* b,
                                                  void* c, int m, int n, int k,
                                                  int trans_a, int trans_b,
                                                  int out_bf16, void* stream) {
  const bool large = m > 0 && n > 0 && pick_large(m, n);
  const int block_rows = large ? Large::BM : Small::BM;
  if (m <= 0 || n <= 0 || k <= 0 || (m + block_rows - 1) / block_rows > 65535 ||
      (trans_a && trans_b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      trans_a   ? launch_bf16<true, false>(large, pa, pb, c, m, n, k, out_bf16,
                                           s)
      : trans_b ? launch_bf16<false, true>(large, pa, pb, c, m, n, k, out_bf16,
                                           s)
                : launch_bf16<false, false>(large, pa, pb, c, m, n, k,
                                            out_bf16, s);
  return static_cast<int>(err);
}
