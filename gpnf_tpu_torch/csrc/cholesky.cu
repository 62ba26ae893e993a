// Blocked lower Cholesky factorization, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/cholesky.py, `_chol_kernel` (launched by
// `pallas_cholesky`, the VMEM-resident kernel for n < 2048) and
// `_hbm_chol_kernel` (launched by `pallas_cholesky_hbm`, the HBM-streaming
// left-looking kernel, with the host recursion `_chol_recursive_tpu` above
// n = 4096), both behind `cholesky_blocked`. One factorization serves
// every n here: the matrix stays in device memory, in place.
//
// For each BS-wide panel j (right-looking, three launches):
//   (a) diag: one block factors the BS x BS diagonal tile in shared memory
//       (column by column, rank-1 updates, one barrier per column) and
//       inverts the factor by row-wise substitution (tile_mm.cuh), as
//       `_diag_chol_blocked` and `_newton_tril_inv` do inside the Pallas
//       kernels;
//   (b) panel: L21 = A21 . L11^-T, one block per row tile, a tiled product
//       with the inverse; the block also zeroes the mirror tile above the
//       diagonal, so the upper triangle of the result is zero;
//   (c) trailing: A22 -= L21 . L21^T on the lower tiles only, one block per
//       64 x 64 tile, a hand-written tiled product (not cuBLAS), as the
//       trailing matmul in the Pallas kernel's body.
// A matrix that is not positive definite takes the square root of a
// negative pivot: NaN, which spreads through the rest of the factor. No
// error is raised and nothing is read back by the host.
//
// What bounds it on the H100: operations, n^3/3 FMAs-worth (0.358 GFLOP at
// n = 1024: 5.3 us at 67 TFLOP/s fp32; 22.9 GFLOP at n = 4096: 342 us),
// the same in float64: the card's fp64 ceiling is 67 TFLOP/s on the tensor
// cores (DMMA), while this kernel's FMAs run on the fp64 units at half that
// rate. In practice the sequential chain of 3 * n/BS launches and the
// one-block diagonal step of each panel set the time at small n; the
// trailing products (FMAs from shared memory, 4 x 4 register tiles, no
// tensor cores) set it at large n.
//
// Float32 and float64 (two instantiations); the C entry points take the
// matrix (overwritten by L) and a BS x BS scratch for the inverse.
#include <cuda_runtime.h>
#include <math.h>

#include "tile_mm.cuh"

namespace {

using namespace gpnf;

constexpr int LDT = BS + 1;  // stride of a whole tile in shared memory

__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chol_diag_kernel(T* __restrict__ a, T* __restrict__ inv, int n, int j) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ls = reinterpret_cast<T*>(smem_raw);
  T* Xs = Ls + BS * LDT;
  const int s = j * BS;
  const int r = min(BS, n - s);
  // the lower triangle of the diagonal tile; identity beyond the edge
  for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
    const int i = e / BS, k = e % BS;
    T v;
    if (i < r && k < r) {
      v = (k <= i) ? a[static_cast<long long>(s + i) * n + s + k] : T(0);
    } else {
      v = (i == k) ? T(1) : T(0);
    }
    Ls[i * LDT + k] = v;
  }
  __syncthreads();
  // Right-looking, one barrier per column: thread t owns column l = t % BS
  // and rows t / BS + 4 q. Column k is left unscaled while the trailing part
  // takes its rank-1 update from the scaled values (a / sqrt(pivot)), and
  // the columns are scaled once at the end, so no thread writes what
  // another reads in the same step. A negative pivot gives NaN (sqrt), which
  // the updates carry into the rest of the tile.
  const int l = threadIdx.x % BS, i0 = threadIdx.x / BS;
  constexpr int kRowsPerThread = BS * BS / kThreads;
  for (int k = 0; k < BS - 1; ++k) {
    const T inv_d = T(1) / sqrt_(Ls[k * LDT + k]);
    if (l > k) {
      const T lk = Ls[l * LDT + k] * inv_d;
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int i = i0 + (kThreads / BS) * q;
        if (i >= l) Ls[i * LDT + l] -= (Ls[i * LDT + k] * inv_d) * lk;
      }
    }
    __syncthreads();
  }
  T fin[kRowsPerThread];
  const T d = sqrt_(Ls[l * LDT + l]);
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int i = i0 + (kThreads / BS) * q;
    fin[q] = i > l ? Ls[i * LDT + l] / d : (i == l ? d : T(0));
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    Ls[(i0 + (kThreads / BS) * q) * LDT + l] = fin[q];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
    const int i = e / BS, k = e % BS;
    if (i < r && k < r) {
      a[static_cast<long long>(s + i) * n + s + k] = Ls[i * LDT + k];
    }
  }
  invert_lower_tile(Ls, Xs);
  for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
    inv[e] = Xs[(e / BS) * LDT + e % BS];
  }
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chol_trailing_kernel(T* __restrict__ a, int n, int j) {
  using S = TileShape<BS>;
  __shared__ T As[BS * LDA];
  __shared__ T Bs[KC * S::LDB];
  // blockIdx.x -> the lower tile (I, J), J <= I, of the trailing matrix
  const long long t = blockIdx.x;
  long long ti = static_cast<long long>((sqrt(8.0 * t + 1.0) - 1.0) / 2.0);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int I = j + 1 + static_cast<int>(ti);
  const int J = j + 1 + static_cast<int>(t - ti * (ti + 1) / 2);
  T acc[S::RPT][S::CPT] = {};
  for (int kc = 0; kc < BS; kc += KC) {
    load_direct(As, LDA, BS, KC, a, n, I * BS, j * BS + kc, n, n);
    // Bs[k][c] = L[J * BS + c][j * BS + kc + k]: the product is P_I . P_J^T
    load_transposed(Bs, S::LDB, KC, BS, a, n, J * BS, j * BS + kc, n, n);
    __syncthreads();
    mma_chunk<T, BS>(As, Bs, acc);
    __syncthreads();
  }
  store_tile<T, BS>(a + static_cast<long long>(I) * BS * n + J * BS, n,
                    n - I * BS, n - J * BS, acc, true);
}

template <typename T>
int cholesky(T* a, T* inv, int n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int diag_smem = 2 * BS * LDT * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      chol_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      diag_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + BS - 1) / BS;
  for (int j = 0; j < nb; ++j) {
    chol_diag_kernel<T><<<1, kThreads, diag_smem, stream>>>(a, inv, n, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int m = nb - j - 1;
    if (m == 0) break;
    chol_panel_kernel<T><<<m, kThreads, 0, stream>>>(a, inv, n, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const unsigned tiles = static_cast<unsigned>(m) * (m + 1) / 2;
    chol_trailing_kernel<T><<<tiles, kThreads, 0, stream>>>(a, n, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" int gpnf_cholesky_f32(float* a, float* inv, int n, void* stream) {
  return cholesky<float>(a, inv, n, static_cast<cudaStream_t>(stream));
}

extern "C" int gpnf_cholesky_f64(double* a, double* inv, int n, void* stream) {
  return cholesky<double>(a, inv, n, static_cast<cudaStream_t>(stream));
}
