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
// fp32 (the wrapper rounds it to w's dtype, as `_vjp_bwd_proj` does)
// (`gpnf_attention_gemm_bf16`, its own kernel, `gemm_bf16_kernel`). bf16
// mma.sync.m16n8k16 (mma_bf16.cuh) on the fp32 kernel's tiles, warps, K
// splits and 3-stage cp.async ring, K in chunks of 32 values (two k16
// steps), each chunk summed into fresh accumulators and added in fp32 as
// above, the splits' fp32 partials added in split order by a second launch
// (and rounded there, for qkv and dseq): two calls give the same bits.
// Tiles keep the arrays' layouts as in fp32, rows of 32 + 8 or BM / BN + 8
// bf16 values, read by ldmatrix (A of dW and B of dseq and dW transposed,
// ldmatrix.trans), conflict-free (mma_bf16.cuh). Operands: 16-byte copies
// where both bases are 16-byte aligned and both row strides are multiples
// of 8 values, else one value at a time (VEC = false). What bounds it:
// bytes at the flagship (C = 96, B 64, S 256: each product 0.9 GFLOP,
// ~0.9 us at the bf16 tensor cores' 989 TFLOP/s; each 12.6 MB, ~3.8 us),
// operations at C = 512 (6.4 GFLOP, ~6.5 us; 18.4 MB, ~5.5 us).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

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

// -- bf16: qkv = seq w^T, dseq = dqkv w, dW = dqkv^T seq --------------------------
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
// stride ld values) into dst (R rows of LD values), zeros where the row is
// >= rows or the column >= cols. VEC: 16-byte cp.async copies (src and ld
// multiples of 8 values, cols too, so a chunk is all in or all out),
// asynchronous, the caller commits and waits; else one value at a time by
// plain loads and stores, which the barrier before the stage's use orders.
template <int R, int W, int LD, int THREADS, bool VEC>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long ld, int r0, int c0,
                                               int rows, int cols) {
  if constexpr (VEC) {
    constexpr int kRow = W / 8;
    static_assert((R * kRow) % THREADS == 0, "whole copies a thread");
#pragma unroll
    for (int it = 0; it < R * kRow / THREADS; ++it) {
      const int e = threadIdx.x + it * THREADS;
      const int r = e / kRow;
      const int c = 8 * (e - r * kRow);
      const bool valid = r0 + r < rows && c0 + c < cols;
      const bf16* from =
          valid ? src + static_cast<long long>(r0 + r) * ld + c0 + c : src;
      gpnf::cp_async16_bf16(dst + r * LD + c, from, valid);
    }
  } else {
    for (int e = threadIdx.x; e < R * W; e += THREADS) {
      const int r = e / W;
      const int c = e - r * W;
      const bool valid = r0 + r < rows && c0 + c < cols;
      dst[r * LD + c] =
          valid ? src[static_cast<long long>(r0 + r) * ld + c0 + c]
                : __float2bfloat16_rn(0.f);
    }
  }
}

// Split z = blockIdx.z of c = A B in bf16 (A m x k, B k x n): the K rows
// [z chunk, min(k, (z + 1) chunk)) summed in fp32, each KC chunk into fresh
// accumulators, into out + z m n: bf16 (rounded once) where out_bf16, else
// float32 (dW, and the partials of a split product).
template <class T, bool TRANS_A, bool TRANS_B, bool VEC>
__global__ void __launch_bounds__(T::kThreads)
    gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                     void* __restrict__ out, int m, int n, int k, int chunk,
                     int out_bf16) {
  using S = StageBf16<T, TRANS_A, TRANS_B>;
  constexpr int MI = T::MI, NI = T::NI;
  extern __shared__ float4 gemm_smem[];
  bf16* smem = reinterpret_cast<bf16*>(gemm_smem);
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(k, k_begin + chunk);
  const int nk = (k_end - k_begin + kBf16Kc - 1) / kBf16Kc;
  const long long z_off = static_cast<long long>(blockIdx.z) * m * n;
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
      load_tile_bf16<kBf16Kc, T::BM, S::kLda, T::kThreads, VEC>(
          as, a, m, k0, m0, k_end, m);
    } else {  // a is (m, k): BM rows of KC
      load_tile_bf16<T::BM, kBf16Kc, S::kLda, T::kThreads, VEC>(
          as, a, k, m0, k0, m, k_end);
    }
    if (TRANS_B) {  // b is (n, k): BN rows of KC
      load_tile_bf16<T::BN, kBf16Kc, S::kLdb, T::kThreads, VEC>(
          bs, b, k, n0, k0, n, k_end);
    } else {  // b is (k, n): KC rows of BN
      load_tile_bf16<kBf16Kc, T::BN, S::kLdb, T::kThreads, VEC>(
          bs, b, n, k0, n0, k_end, n);
    }
  };

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < nk) load_stage(s, k_begin + s * kBf16Kc);
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
    if (ahead < nk) load_stage(ahead % T::kStages, k_begin + ahead * kBf16Kc);
    gpnf::cp_async_commit();
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
  const bool pairs = n % 2 == 0;  // then (col, col + 1) is one aligned word
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + 16 * i + gr + 8 * h;
      if (row >= m) continue;
      const long long at = z_off + static_cast<long long>(row) * n;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + wn + 8 * j + 2 * tg;
        const float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (out_bf16) {
          bf16* dst = static_cast<bf16*>(out) + at;
          if (pairs && col < n) {
            *reinterpret_cast<uint32_t*>(dst + col) = gpnf::pack_bf16(x, y);
          } else {
            if (col < n) dst[col] = __float2bfloat16_rn(x);
            if (col + 1 < n) dst[col + 1] = __float2bfloat16_rn(y);
          }
        } else {
          float* dst = static_cast<float*>(out) + at;
          if (pairs && col < n) {
            *reinterpret_cast<float2*>(dst + col) = make_float2(x, y);
          } else {
            if (col < n) dst[col] = x;
            if (col + 1 < n) dst[col + 1] = y;
          }
        }
      }
    }
  }
}

// c[i] = sum over z of partial[z][i], z in order, rounded once to bf16.
__global__ void __launch_bounds__(kSumThreads)
    sum_splits_bf16_kernel(const float* __restrict__ partial,
                           bf16* __restrict__ c, long long count,
                           int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kSumThreads +
                      threadIdx.x;
  if (i >= count) return;
  float acc = partial[i];
  for (int z = 1; z < splits; ++z) acc += partial[z * count + i];
  c[i] = __float2bfloat16_rn(acc);
}

template <class T, bool TRANS_A, bool TRANS_B, bool VEC>
cudaError_t launch_tiles_bf16(const bf16* a, const bf16* b, void* out, int m,
                              int n, int k, int splits, int chunk,
                              int out_bf16, cudaStream_t stream) {
  using S = StageBf16<T, TRANS_A, TRANS_B>;
  const auto kernel = gemm_bf16_kernel<T, TRANS_A, TRANS_B, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + T::BN - 1) / T::BN, (m + T::BM - 1) / T::BM, splits);
  kernel<<<grid, T::kThreads, S::kBytes, stream>>>(a, b, out, m, n, k, chunk,
                                                   out_bf16);
  return cudaGetLastError();
}

template <bool TRANS_A, bool TRANS_B>
cudaError_t launch_bf16(bool large, bool vec, const bf16* a, const bf16* b,
                        void* out, int m, int n, int k, int splits, int chunk,
                        int out_bf16, cudaStream_t s) {
  if (large) {
    return vec ? launch_tiles_bf16<Large, TRANS_A, TRANS_B, true>(
                     a, b, out, m, n, k, splits, chunk, out_bf16, s)
               : launch_tiles_bf16<Large, TRANS_A, TRANS_B, false>(
                     a, b, out, m, n, k, splits, chunk, out_bf16, s);
  }
  return vec ? launch_tiles_bf16<Small, TRANS_A, TRANS_B, true>(
                   a, b, out, m, n, k, splits, chunk, out_bf16, s)
             : launch_tiles_bf16<Small, TRANS_A, TRANS_B, false>(
                   a, b, out, m, n, k, splits, chunk, out_bf16, s);
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

// c (m x n) = A B in bf16, as gpnf_attention_gemm lays out A and B:
// qkv = seq w^T (trans_b), dseq = dqkv w (neither), dW = dqkv^T seq
// (trans_a); the same tiles (`pick_large`) and K splits (`splits`, chunk
// as above, `partial` the caller's float32 (splits, m, n) scratch). The
// sums are float32; c is bf16, rounded once, where out_bf16, else float32.
// Any contiguous operands: 16-byte copies where both bases are 16-byte
// aligned and both row strides multiples of 8 values, else one value at a
// time, with the same bits.
extern "C" int gpnf_attention_gemm_bf16(const void* a, const void* b, void* c,
                                        float* partial, int m, int n, int k,
                                        int trans_a, int trans_b, int splits,
                                        int out_bf16, void* stream) {
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
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  void* out = splits > 1 ? static_cast<void*>(partial) : c;
  const int direct_bf16 = splits > 1 ? 0 : out_bf16;
  const int lda = trans_a ? m : k, ldb = trans_b ? k : n;
  const bool vec = aligned16(a) && aligned16(b) && lda % 8 == 0 &&
                   ldb % 8 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      trans_a   ? launch_bf16<true, false>(large, vec, pa, pb, out, m, n, k,
                                           splits, chunk, direct_bf16, s)
      : trans_b ? launch_bf16<false, true>(large, vec, pa, pb, out, m, n, k,
                                           splits, chunk, direct_bf16, s)
                : launch_bf16<false, false>(large, vec, pa, pb, out, m, n, k,
                                            splits, chunk, direct_bf16, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(m) * n;
  const unsigned blocks =
      static_cast<unsigned>((count + kSumThreads - 1) / kSumThreads);
  if (out_bf16) {
    sum_splits_bf16_kernel<<<blocks, kSumThreads, 0, s>>>(
        partial, static_cast<bf16*>(c), count, splits);
  } else {
    sum_splits_kernel<<<blocks, kSumThreads, 0, s>>>(
        partial, static_cast<float*>(c), count, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
