// Blocked lower Cholesky factorization, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/cholesky.py, `_chol_kernel` (launched by
// `pallas_cholesky`, the VMEM-resident kernel for n < 2048) and
// `_hbm_chol_kernel` (launched by `pallas_cholesky_hbm`, the HBM-streaming
// left-looking kernel, with the host recursion `_chol_recursive_tpu` above
// n = 4096), both behind `cholesky_blocked`. One factorization serves
// every n here: the matrix stays in device memory, in place.
//
// Right-looking over BS-wide panels j:
//   diag: the BS x BS diagonal tile is factored and inverted in shared
//       memory by one block (`diag_step`, below);
//   panel: L21 = A21 . L11^-T, one block per row tile, a tiled product
//       with the inverse; the block also zeroes the mirror tile above the
//       diagonal, so the upper triangle of the result is zero;
//   trailing: A22 -= L21 . L21^T on the lower tiles only, one block per
//       64 x 64 tile, a hand-written tiled product (not cuBLAS), as the
//       trailing matmul in the Pallas kernel's body.
// Look-ahead: block 0 of panel j's trailing launch owns tile (j+1, j+1);
// after its update it runs panel j+1's diagonal step itself, while the
// other blocks update the rest. A factorization is diag(0), then panel(j)
// and trailing+diag(j+1) for each j: 2 ceil(n/64) - 1 launches, not the
// 3 ceil(n/64) - 2 of a diagonal launch after each trailing one. On an
// H100 80GB HBM3 at 700 W (gpnf_tpu_torch/bench_cholesky.py, that version
// of this source as a --ref) the look-ahead takes 0.466 ms against 0.526
// at n = 1024 and 2.81 against 3.27 at n = 4096 in float32, 4.37 against
// 5.01 at n = 4096 in float64. Its cost: the trailing kernel takes the
// diagonal step's shared memory (33 KB, 66.5 KB in float64) and registers
// (64, 98 in float64, against 48 and 64) in every block, and a trailing
// launch ends no earlier than its block 0's diagonal step (17.0 us against
// 10.7 at n = 1024 in float32; 56.0 against 39.9 at n = 4096 in float64).
//
// The diagonal step (`diag_step`) has no block-wide barrier a column or a
// row:
//   factor: four 16-wide panels inside the tile. Warp 0 factors a panel in
//       registers (lane l holds rows o + l and o + 32 + l of its 16
//       columns; the pivot and the column entries pass by shuffles), then
//       all warps take the rank-16 update of the rest of the tile: two
//       barriers a panel, 7 in all;
//   inverse: by doubling, as the JAX package's `_newton_tril_inv` and
//       `_diag_chol_blocked`: warps 0-3 invert the four 16 x 16 diagonal
//       factors at once (registers and shuffles), then X21 = -X22 L21 X11
//       at 16 -> 32 and 32 -> 64, as two small products each, through a
//       scratch in the factor's upper triangle: 5 barriers.
// It takes 10.1 us in float32 and 19.1 us in float64 at n = 1024 (56.0 and
// 67.0 us for the design before, a barrier a column and a row). The time
// of the column-by-column step was not in its barriers (leaving them out
// saved 1-2 us of 56) nor in its sqrt and division, but in the dependent
// shared-memory chain of each column and row, with eight warps on one SM
// to hide it, and in a tile load whose global reads waited one by one (the
// loads and stores alone took 6.6 us). Of the new step (built with parts
// deleted), the launch with the tile's loads and stores alone takes 3.4
// us; the warp's panel factors 3.0 (the 64-column chain of shuffle, rsqrt
// and fma; 10.3 of 19.1 us in float64, where rsqrt is a software
// sequence), the inverse 2.5 (the doubling 1.5).
// A matrix that is not positive definite takes the reciprocal square root
// of a negative pivot: NaN, which spreads through the rest of the factor.
// No error is raised and nothing is read back by the host.
//
// What bounds it on the H100: operations, n^3/3 FMAs-worth (0.358 GFLOP at
// n = 1024: 5.3 us at 67 TFLOP/s fp32; 22.9 GFLOP at n = 4096: 342 us),
// the same in float64: the card's fp64 ceiling is 67 TFLOP/s on the tensor
// cores (DMMA), while this kernel's FMAs run on the fp64 units at half that
// rate. In practice the chain of 2 n/BS dependent launches (~10 us each for
// the panel and trailing kernels at n = 1024) sets the time at small n,
// and the trailing products (FMAs from shared memory, 4 x 4 register
// tiles, no tensor cores) at large n.
//
// trailing_precision="high" (`gpnf_cholesky_high_*`): also replaces the
// "high" mode of `_hbm_chol_kernel` (gpnf_tpu/ops/pallas/cholesky.py:291,
// its branch at :344 on `_dot_bf16x3` :54), where the trailing GEMM runs
// as three bf16 products, hi hi^T + hi lo^T + lo hi^T with float32 sums,
// while the diagonal factor and the panel solve stay at full precision.
// The JAX kernel is left-looking over P-wide panels (P the caller's panel
// width), so factor column c's contribution to entry (r, r') is a bf16x3
// product exactly when c's P-block precedes r''s. Here, right-looking over
// 64-wide panels, panel j's update of tile column J is bf16x3 iff
// floor(64 j / P) < floor(64 J / P), the float32 (float64) product
// otherwise: the same products as the JAX kernel's at the same P, summed
// in another order. The predicate is uniform in a block of the trailing
// launch (`chol_trailing_kernel<T, true>`), whose bf16x3 branch
// (`bf16x3_tile`) splits the two 64 x 64 panel tiles into hi and lo bf16
// tiles in shared memory as JAX splits them (hi = bf16(x), lo = bf16(x -
// hi), rounded to nearest even; a float64 x through float32, as JAX's and
// torch's casts go), runs the three products as mma.sync.m16n8k16 bf16
// products into float32 accumulators (mma_bf16.cuh: hi hi^T in one, hi
// lo^T and lo hi^T in another, added last, as JAX's (hh + hl) + lh), and
// subtracts the sum from the tile in the matrix's own dtype. Everything
// else, the look-ahead and the launch count included, is the "highest"
// factorization's; its instantiation (`<T, false>`) is unchanged.
// What bounds it on the H100: operations, the bf16x3 products three bf16
// products each at 989 TFLOP/s, the rest of the n^3 / 3 FLOPs (diagonal
// tiles, panel solves, products inside a P-block) at the fp32 rate
// (`cholesky_high_flops`): at n = 4096, P = 256, where 91% of the FLOPs
// cross P-blocks, 63.1 + 31.3 = 94.4 us, against 40.1 us for n^2 4 2 bytes.
// In practice, as for "highest", the chain of launches and the diagonal
// steps set the time at small n.
//
// Float32 and float64 (two instantiations each); the C entry points take
// the matrix (overwritten by L) and a BS x BS scratch for the inverse.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"
#include "tile_mm.cuh"

namespace {

using namespace gpnf;

constexpr int LDT = BS + 1;  // stride of a whole tile in shared memory
constexpr int SB = 16;       // sub-block edge inside the diagonal tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float rsqrt_(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_(double v) { return rsqrt(v); }
__device__ __forceinline__ float fma_(float x, float y, float z) {
  return __fmaf_rn(x, y, z);
}
__device__ __forceinline__ double fma_(double x, double y, double z) {
  return __fma_rn(x, y, z);
}

// Warp 0: factor the 16 columns o = 16 KB.. of rows o..BS-1 of Ls in
// registers. Lane l holds rows o + l and o + 32 + l. For column c the pivot
// is shuffled from lane c, every lane scales its entries by rsqrt(pivot),
// and each later column j takes its rank-1 update with L[j][c] shuffled
// from lane j. Lane c + 1's next pivot is computed first from its own
// L[c+1][c] (the same fma as its update), so one shuffle, one rsqrt and two
// multiplies make the chain from column to column.
template <typename T, int KB>
__device__ __forceinline__ void factor_panel(T* Ls) {
  constexpr int o = KB * SB;
  constexpr bool kTwo = o + 32 < BS;  // a second row per lane
  const int lane = threadIdx.x & 31;
  const int r0 = o + lane, r1 = o + 32 + lane;
  const bool v0 = r0 < BS, v1 = kTwo && r1 < BS;
  T a0[SB], a1[SB];
#pragma unroll
  for (int q = 0; q < SB; ++q) {
    a0[q] = v0 ? Ls[r0 * LDT + o + q] : T(0);
    a1[q] = v1 ? Ls[r1 * LDT + o + q] : T(0);
  }
  T pnext = a0[0];
#pragma unroll
  for (int c = 0; c < SB; ++c) {
    const T piv = __shfl_sync(kFull, pnext, c);
    const T rs = rsqrt_(piv);
    const T l0 = a0[c] * rs, l1 = a1[c] * rs;
    if (c + 1 < SB) pnext = fma_(-l0, l0, a0[c + 1 < SB ? c + 1 : c]);
#pragma unroll
    for (int j = c + 1; j < SB; ++j) {
      const T lj = __shfl_sync(kFull, l0, j);
      a0[j] = fma_(-l0, lj, a0[j]);
      if (kTwo) a1[j] = fma_(-l1, lj, a1[j]);
    }
    // rows above the diagonal (lane < c) are zero, whatever they carried
    a0[c] = lane > c ? l0 : (lane == c ? piv * rs : T(0));
    a1[c] = l1;
  }
#pragma unroll
  for (int q = 0; q < SB; ++q) {
    if (v0) Ls[r0 * LDT + o + q] = a0[q];
    if (v1) Ls[r1 * LDT + o + q] = a1[q];
  }
}

// All threads: Ls[i][j] -= sum_k L[i][o+k] L[j][o+k] for the lower part of
// rows and columns o + 16.. (o = 16 KB); thread (ti, tj) holds a register
// tile of rows o + 16 + ti + 16 a and columns o + 16 + tj + 16 b.
template <typename T, int KB>
__device__ __forceinline__ void update_tile(T* Ls) {
  constexpr int o = KB * SB, M = BS / SB - 1 - KB;
  const int ti = threadIdx.x / SB, tj = threadIdx.x % SB;
  T acc[M][M] = {};
#pragma unroll
  for (int k = 0; k < SB; ++k) {
    T li[M], lj[M];
#pragma unroll
    for (int x = 0; x < M; ++x) {
      li[x] = Ls[(o + SB + ti + SB * x) * LDT + o + k];
      lj[x] = Ls[(o + SB + tj + SB * x) * LDT + o + k];
    }
#pragma unroll
    for (int x = 0; x < M; ++x)
#pragma unroll
      for (int y = 0; y < M; ++y) acc[x][y] = fma_(li[x], lj[y], acc[x][y]);
  }
#pragma unroll
  for (int x = 0; x < M; ++x)
#pragma unroll
    for (int y = 0; y < M; ++y) {
      const int i = o + SB + ti + SB * x, j = o + SB + tj + SB * y;
      if (j <= i) Ls[i * LDT + j] -= acc[x][y];
    }
}

// The whole tile: L L^T = A in place, upper triangle zero. Ends with a
// barrier.
template <typename T>
__device__ __forceinline__ void factor_tile(T* Ls) {
  const int warp = threadIdx.x >> 5;
  if (warp == 0) factor_panel<T, 0>(Ls);
  __syncthreads();
  update_tile<T, 0>(Ls);
  __syncthreads();
  if (warp == 0) factor_panel<T, 1>(Ls);
  __syncthreads();
  update_tile<T, 1>(Ls);
  __syncthreads();
  if (warp == 0) factor_panel<T, 2>(Ls);
  __syncthreads();
  update_tile<T, 2>(Ls);
  __syncthreads();
  if (warp == 0) factor_panel<T, 3>(Ls);
  __syncthreads();
}

// Warps 0-3: warp w inverts the 16 x 16 diagonal factor w of Ls into Xs
// (its upper triangle zero). Lane r (and r + 16, which repeats it) holds
// row r of L and of X; row k of X is final once scaled by 1 / L[k][k], and
// the later rows subtract L[r][k] times it, shuffled from lane k.
template <typename T>
__device__ __forceinline__ void invert_diag_blocks(const T* Ls, T* Xs) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (w >= BS / SB) return;
  const int r = lane & (SB - 1), o = w * SB;
  T lr[SB], x[SB];
#pragma unroll
  for (int q = 0; q < SB; ++q) {
    lr[q] = Ls[(o + r) * LDT + o + q];
    x[q] = q == r ? T(1) : T(0);
  }
  const T inv_d = T(1) / Ls[(o + r) * LDT + o + r];
#pragma unroll
  for (int k = 0; k < SB; ++k) {
    if (r == k) {
#pragma unroll
      for (int q = 0; q <= k; ++q) x[q] *= inv_d;
    }
    if (k + 1 < SB) {
#pragma unroll
      for (int q = 0; q <= k; ++q) {
        const T xk = __shfl_sync(kFull, x[q], k);
        if (r > k) x[q] = fma_(-lr[k], xk, x[q]);
      }
    }
  }
  if (lane < SB) {
#pragma unroll
    for (int q = 0; q < SB; ++q) Xs[(o + r) * LDT + o + q] = x[q];
  }
}

// All threads: for each pair of H x H diagonal blocks (A, B) of the tile,
// X[B][A] = -X[B][B] (L[B][A] X[A][A]): first S = L[B][A] X[A][A] into the
// scratch Ls[A][B] (the factor's upper triangle, already written out),
// then X[B][A] = -X[B][B] S. Upper blocks of Xs stay zero; where a
// 16 x 16 block of X[A][A] or X[B][B] is one of them, its products are
// left out. Thread (ti, tj) holds a register tile of rows ti + 16 a and
// columns tj + 16 b of each pair's block.
template <typename T, int H>
__device__ __forceinline__ void double_inverse(T* Ls, T* Xs) {
  constexpr int P = BS / (2 * H), M = H / SB;
  const int ti = threadIdx.x / SB, tj = threadIdx.x % SB;
  T acc[P][M][M] = {};
#pragma unroll
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int oa = 2 * H * p, ob = oa + H;
      T li[M], xj[M];
#pragma unroll
      for (int x = 0; x < M; ++x) {
        li[x] = Ls[(ob + ti + SB * x) * LDT + oa + k];
        xj[x] = Xs[(oa + k) * LDT + oa + tj + SB * x];
      }
#pragma unroll
      for (int x = 0; x < M; ++x)
#pragma unroll
        for (int y = 0; y < M; ++y) {
          if (k / SB < y) continue;  // X[A][A]'s zero block
          acc[p][x][y] = fma_(li[x], xj[y], acc[p][x][y]);
        }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int x = 0; x < M; ++x)
#pragma unroll
      for (int y = 0; y < M; ++y) {
        const int oa = 2 * H * p, ob = oa + H;
        Ls[(oa + ti + SB * x) * LDT + ob + tj + SB * y] = acc[p][x][y];
        acc[p][x][y] = T(0);
      }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < H; ++k) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int oa = 2 * H * p, ob = oa + H;
      T xi[M], sj[M];
#pragma unroll
      for (int x = 0; x < M; ++x) {
        xi[x] = Xs[(ob + ti + SB * x) * LDT + ob + k];
        sj[x] = Ls[(oa + k) * LDT + ob + tj + SB * x];
      }
#pragma unroll
      for (int x = 0; x < M; ++x)
#pragma unroll
        for (int y = 0; y < M; ++y) {
          if (k / SB > x) continue;  // X[B][B]'s zero block
          acc[p][x][y] = fma_(xi[x], sj[y], acc[p][x][y]);
        }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int x = 0; x < M; ++x)
#pragma unroll
      for (int y = 0; y < M; ++y) {
        const int oa = 2 * H * p, ob = oa + H;
        Xs[(ob + ti + SB * x) * LDT + oa + tj + SB * y] = -acc[p][x][y];
      }
  __syncthreads();
}

// The diagonal step of the panel at row and column s (r = min(BS, n - s)
// rows): Ls holds the tile (lower triangle, upper triangle zero, identity
// beyond the ragged edge), Xs zero, and a barrier has passed. Writes L's
// tile into `a` (its upper triangle zero) and the inverse of the factor
// into `inv`.
template <typename T>
__device__ __forceinline__ void diag_step(T* Ls, T* Xs, T* __restrict__ a,
                                          T* __restrict__ inv, int n, int s,
                                          int r) {
  factor_tile(Ls);
  for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
    const int i = e / BS, k = e % BS;
    if (i < r && k < r) {
      a[static_cast<long long>(s + i) * n + s + k] = Ls[i * LDT + k];
    }
  }
  invert_diag_blocks(Ls, Xs);
  __syncthreads();
  double_inverse<T, SB>(Ls, Xs);
  double_inverse<T, 2 * SB>(Ls, Xs);
  for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
    inv[e] = Xs[(e / BS) * LDT + e % BS];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chol_diag_kernel(T* __restrict__ a, T* __restrict__ inv, int n, int j) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ls = reinterpret_cast<T*>(smem_raw);
  T* Xs = Ls + BS * LDT;
  const int s = j * BS;
  const int r = min(BS, n - s);
  // the lower triangle of the diagonal tile; identity beyond the edge. All
  // of a thread's loads are issued before its first store.
  constexpr int kPerThread = BS * BS / kThreads;
  T v[kPerThread];
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = threadIdx.x + kThreads * q, i = e / BS, k = e % BS;
    v[q] = (i < r && k < r)
               ? (k <= i ? a[static_cast<long long>(s + i) * n + s + k] : T(0))
               : (i == k ? T(1) : T(0));
  }
#pragma unroll
  for (int q = 0; q < kPerThread; ++q) {
    const int e = threadIdx.x + kThreads * q;
    Ls[(e / BS) * LDT + e % BS] = v[q];
    Xs[(e / BS) * LDT + e % BS] = T(0);
  }
  __syncthreads();
  diag_step(Ls, Xs, a, inv, n, s, r);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chol_panel_kernel(T* __restrict__ a, const T* __restrict__ inv, int n,
                      int j) {
  using S = TileShape<BS>;
  __shared__ T As[BS * LDA];
  __shared__ T Bs[KC * S::LDB];
  const int i = j + 1 + blockIdx.x;
  T acc[S::RPT][S::CPT] = {};
  for (int kc = 0; kc < BS; kc += KC) {
    load_direct(As, LDA, BS, KC, a, n, i * BS, j * BS + kc, n, n);
    // Bs[k][c] = inv[c][kc + k]: the product is A21 . inv^T
    load_transposed(Bs, S::LDB, KC, BS, inv, BS, 0, kc, BS, BS);
    __syncthreads();
    mma_chunk<T, BS>(As, Bs, acc);
    __syncthreads();
  }
  store_tile<T, BS>(a + static_cast<long long>(i) * BS * n + j * BS, n,
                    n - i * BS, BS, acc, false);
  // the mirror tile (j, i) above the diagonal is zero in L
  for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
    const int rr = j * BS + e / BS, cc = i * BS + e % BS;
    if (cc < n) a[static_cast<long long>(rr) * n + cc] = T(0);
  }
}

// the bf16 tiles of the bf16x3 branch: rows of BS values padded to
// BS + 8 (mma_bf16.cuh's conflict-free ldmatrix layout)
constexpr int LDH = BS + kBf16Pad;
constexpr int kSplitBytes = 4 * BS * LDH * static_cast<int>(sizeof(bf16));

// shared memory of the trailing kernel: the GEMM's staging buffers, and
// the diagonal step's two tiles over the same bytes; with HIGH also the
// bf16x3 branch's four bf16 tiles (hi and lo of both panel tiles), then
// its float32 product tile, over the same bytes
template <typename T, bool HIGH>
constexpr int trailing_smem() {
  const int gemm = (BS * LDA + KC * TileShape<BS>::LDB) * sizeof(T);
  const int diag = 2 * BS * LDT * sizeof(T);
  const int most = diag > gemm ? diag : gemm;
  return HIGH && kSplitBytes > most ? kSplitBytes : most;
}

// x as JAX's `_dot_bf16x3` splits it: hi = bf16(x), lo = bf16(x - hi),
// each rounded to nearest even; a double goes through float32 first, as
// JAX's and torch's float64 -> bf16 casts do (x - hi is exact in x's type).
template <typename T>
__device__ __forceinline__ void split_bf16(T x, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(static_cast<float>(x));
  lo = __float2bfloat16_rn(
      static_cast<float>(x - static_cast<T>(__bfloat162float(hi))));
}

// Rows row0 .. row0 + BS - 1, columns col0 .. col0 + BS - 1 of the (n, n)
// matrix `a` (zero past its edge) into the hi and lo bf16 tiles, two
// neighbouring values a thread at a time (coalesced reads).
template <typename T>
__device__ __forceinline__ void stage_split(bf16* hi, bf16* lo,
                                            const T* __restrict__ a, int n,
                                            int row0, int col0) {
  for (int e = 2 * threadIdx.x; e < BS * BS; e += 2 * kThreads) {
    const int r = e / BS, c = e % BS;
    const int gr = row0 + r, gc = col0 + c;
    const T* src = a + static_cast<long long>(gr) * n + gc;
    const T x0 = gr < n && gc < n ? src[0] : T(0);
    const T x1 = gr < n && gc + 1 < n ? src[1] : T(0);
    bf16 h0, l0, h1, l1;
    split_bf16(x0, h0, l0);
    split_bf16(x1, h1, l1);
    *reinterpret_cast<__nv_bfloat162*>(hi + r * LDH + c) =
        __halves2bfloat162(h0, h1);
    *reinterpret_cast<__nv_bfloat162*>(lo + r * LDH + c) =
        __halves2bfloat162(l0, l1);
  }
}

// acc = P_I . P_J^T in bf16x3 on the tensor cores, P_I = L[I tile][panel
// j], in TileShape<BS>'s register layout (so the SIMT branch's epilogue
// takes it as it is). Warp w owns rows 16 (w % 4) .. + 15 and columns
// 32 (w / 4) .. + 31 of the product: four n8 tiles, four k16 steps, three
// products each. Ends with a barrier after which all shared memory is free.
template <typename T>
__device__ __forceinline__ void bf16x3_tile(const T* __restrict__ a, int n,
                                            int I, int J, int j,
                                            unsigned char* smem,
                                            T (&acc)[4][4]) {
  using S = TileShape<BS>;
  bf16* ah = reinterpret_cast<bf16*>(smem);
  bf16* al = ah + BS * LDH;
  bf16* bh = al + BS * LDH;
  bf16* bl = bh + BS * LDH;
  stage_split(ah, al, a, n, I * BS, j * BS);
  stage_split(bh, bl, a, n, J * BS, j * BS);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float hh[4][4] = {}, cross[4][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < BS; k0 += 16) {
    uint32_t fh[4], fl[4];
    frag_a_bf16<LDH>(fh, ah, m0, k0, lane);
    frag_a_bf16<LDH>(fl, al, m0, k0, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t gh[4], gl[4];
      frag_b_bf16_pair<LDH>(gh, bh, n0 + 16 * np, k0, lane);
      frag_b_bf16_pair<LDH>(gl, bl, n0 + 16 * np, k0, lane);
      mma_bf16(hh[2 * np], fh, gh[0], gh[1]);
      mma_bf16(hh[2 * np + 1], fh, gh[2], gh[3]);
      mma_bf16(cross[2 * np], fh, gl[0], gl[1]);
      mma_bf16(cross[2 * np + 1], fh, gl[2], gl[3]);
      mma_bf16(cross[2 * np], fl, gh[0], gh[1]);
      mma_bf16(cross[2 * np + 1], fl, gh[2], gh[3]);
    }
  }
  __syncthreads();  // the bf16 tiles are read: the product goes over them
  float* ps = reinterpret_cast<float*>(smem);
  const int gr = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + 8 * nt + 2 * tg;
    ps[(m0 + gr) * LDT + c] = hh[nt][0] + cross[nt][0];
    ps[(m0 + gr) * LDT + c + 1] = hh[nt][1] + cross[nt][1];
    ps[(m0 + gr + 8) * LDT + c] = hh[nt][2] + cross[nt][2];
    ps[(m0 + gr + 8) * LDT + c + 1] = hh[nt][3] + cross[nt][3];
  }
  __syncthreads();
  const int cg = threadIdx.x % S::CG, rg = threadIdx.x / S::CG;
#pragma unroll
  for (int x = 0; x < S::RPT; ++x)
#pragma unroll
    for (int y = 0; y < S::CPT; ++y) {
      acc[x][y] = static_cast<T>(ps[(rg + S::RG * x) * LDT + cg + S::CG * y]);
    }
  __syncthreads();
}

// panel j's update of the lower tiles of the trailing matrix, the product
// of tile column J in bf16x3 where HIGH and floor(BS j / p) < floor(BS J /
// p) (p the caller's panel width), else in T on the SIMT units
template <typename T, bool HIGH>
__global__ void __launch_bounds__(kThreads)
    chol_trailing_kernel(T* __restrict__ a, T* __restrict__ inv, int n,
                         int j, int p) {
  using S = TileShape<BS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + BS * LDA;
  // blockIdx.x -> the lower tile (I, J), J <= I, of the trailing matrix;
  // block 0 is the next diagonal tile (j + 1, j + 1)
  const long long t = blockIdx.x;
  long long ti = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) / 2.0);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int I = j + 1 + static_cast<int>(ti);
  const int J = j + 1 + static_cast<int>(t - ti * (ti + 1) / 2);
  T acc[S::RPT][S::CPT] = {};
  if (HIGH && (j * BS) / p < (J * BS) / p) {
    bf16x3_tile(a, n, I, J, j, smem_raw, acc);
  } else {
    for (int kc = 0; kc < BS; kc += KC) {
      load_direct(As, LDA, BS, KC, a, n, I * BS, j * BS + kc, n, n);
      // Bs[k][c] = L[J * BS + c][j * BS + kc + k]: the product is
      // P_I . P_J^T
      load_transposed(Bs, S::LDB, KC, BS, a, n, J * BS, j * BS + kc, n, n);
      __syncthreads();
      mma_chunk<T, BS>(As, Bs, acc);
      __syncthreads();
    }
  }
  if (t == 0) {
    // the updated tile goes to shared memory (over the staging buffers, free
    // after the last barrier), and this block runs panel j + 1's diagonal
    // step
    T* Ls = reinterpret_cast<T*>(smem_raw);
    T* Xs = Ls + BS * LDT;
    const int s = I * BS, r = min(BS, n - s);
    const int cg = threadIdx.x % S::CG, rg = threadIdx.x / S::CG;
#pragma unroll
    for (int x = 0; x < S::RPT; ++x)
#pragma unroll
      for (int y = 0; y < S::CPT; ++y) {
        const int i = rg + S::RG * x, k = cg + S::CG * y;
        Ls[i * LDT + k] =
            (i < r && k < r)
                ? (k <= i ? a[static_cast<long long>(s + i) * n + s + k] -
                                acc[x][y]
                          : T(0))
                : (i == k ? T(1) : T(0));
      }
    for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
      Xs[(e / BS) * LDT + e % BS] = T(0);
    }
    __syncthreads();
    diag_step(Ls, Xs, a, inv, n, s, r);
    return;
  }
  store_tile<T, BS>(a + static_cast<long long>(I) * BS * n + J * BS, n,
                    n - I * BS, n - J * BS, acc, true);
}

// Attributes of the trailing kernel (its shared memory may exceed 48 KB)
// and the diagonal kernel.
template <typename T, bool HIGH>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      chol_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * BS * LDT * static_cast<int>(sizeof(T)));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chol_trailing_kernel<T, HIGH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              trailing_smem<T, HIGH>());
}

// The factorization: trailing updates by `chol_trailing_kernel<T, HIGH>`,
// p the "high" mode's panel width (a multiple of BS; unread without HIGH).
template <typename T, bool HIGH>
int cholesky(T* a, T* inv, int n, int p, cudaStream_t stream) {
  if (n <= 0 || (HIGH && (p <= 0 || p % BS != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int diag_smem = 2 * BS * LDT * static_cast<int>(sizeof(T));
  const int trail_smem = trailing_smem<T, HIGH>();
  cudaError_t err = set_smem<T, HIGH>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + BS - 1) / BS;
  chol_diag_kernel<T><<<1, kThreads, diag_smem, stream>>>(a, inv, n, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int j = 0; j + 1 < nb; ++j) {
    const int m = nb - j - 1;
    chol_panel_kernel<T><<<m, kThreads, 0, stream>>>(a, inv, n, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const unsigned tiles = static_cast<unsigned>(m) * (m + 1) / 2;
    chol_trailing_kernel<T, HIGH><<<tiles, kThreads, trail_smem, stream>>>(
        a, inv, n, j, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One launch of the "high" trailing kernel for panel j (0 <= j, j + 1 <
// ceil(n / BS)) on `a` as it stands: the lower tiles of rows and columns
// from BS (j + 1) take A -= P_I P_J^T, and tile (j + 1, j + 1) is then
// factored in place, its inverse written to `inv`. A test entry: it lets
// the card hold the bf16x3 product alone against its plain version.
template <typename T>
int trailing_high(T* a, T* inv, int n, int j, int p, cudaStream_t stream) {
  const int nb = (n + BS - 1) / BS;
  if (n <= 0 || j < 0 || j + 1 >= nb || p <= 0 || p % BS != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = set_smem<T, true>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int m = nb - j - 1;
  const unsigned tiles = static_cast<unsigned>(m) * (m + 1) / 2;
  chol_trailing_kernel<T, true><<<tiles, kThreads, trailing_smem<T, true>(),
                                  stream>>>(a, inv, n, j, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gpnf_cholesky_f32(float* a, float* inv, int n, void* stream) {
  return cholesky<float, false>(a, inv, n, 0,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int gpnf_cholesky_f64(double* a, double* inv, int n, void* stream) {
  return cholesky<double, false>(a, inv, n, 0,
                                 static_cast<cudaStream_t>(stream));
}

// trailing_precision="high" with panel width p (a multiple of 64)
extern "C" int gpnf_cholesky_high_f32(float* a, float* inv, int n, int p,
                                      void* stream) {
  return cholesky<float, true>(a, inv, n, p,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int gpnf_cholesky_high_f64(double* a, double* inv, int n, int p,
                                      void* stream) {
  return cholesky<double, true>(a, inv, n, p,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int gpnf_cholesky_trailing_high_f32(float* a, float* inv, int n,
                                               int j, int p, void* stream) {
  return trailing_high<float>(a, inv, n, j, p,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int gpnf_cholesky_trailing_high_f64(double* a, double* inv, int n,
                                               int j, int p, void* stream) {
  return trailing_high<double>(a, inv, n, j, p,
                               static_cast<cudaStream_t>(stream));
}
