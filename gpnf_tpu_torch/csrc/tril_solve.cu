// Blocked lower-triangular solve L X = B or L^T X = B, hand-written for
// Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/trisolve.py, `_solve_kernel` (launched by
// `pallas_tril_solve` from `tril_solve`): block substitution with each
// 128 x 128 diagonal block inverted exactly (`_newton_tril_inv`) and the
// off-diagonal updates as matmuls, L and B resident in VMEM.
//
// Here, with BS-row blocks (tile_mm.cuh) and X overwritten in place (the
// wrapper passes a copy of B):
//   1. invert: one block per diagonal tile, L_jj^-1 by row-wise
//      substitution into a scratch of nb BS x BS tiles;
//   2. for each block row j in solve order (j ascending for L, descending
//      for L^T), two launches:
//        diag:   X_j = L_jj^-1 X_j   (or L_jj^-T X_j), one block per column
//                tile of X;
//        update: X_i -= L_ij X_j     (or L_ji^T X_j) for every later block
//                row i, one block per (column tile, row tile).
// The update step is parallel over rows and columns, so a single right-hand
// column (the NLML's y) still spreads over n/BS blocks, and an n x n one
// (the Cholesky VJP) over (n/BS)^2. Column tiles are 64 wide, or 4 wide
// when p < 32: at p = 1 a 64-wide tile spends its update launches on 63
// padded columns, and the solve took 40% longer with it on an H100
// (chip_smoke.py phase 10: 0.325 against 0.232 ms at n = 1024, 1.27
// against 0.90 ms at n = 4096).
//
// What bounds it on the H100: at p = n operations (n^2 p FMAs: 68.7 GFLOP
// at n = p = 4096, 1.03 ms at 67 TFLOP/s fp32); at p = 1 bytes (L read
// once, 33.5 MB at n = 4096 in fp32: 10 us at 3.35 TB/s). At p = 1 the
// 2 n/BS + 1 dependent launches (129 at n = 4096), each a few microseconds
// of launch and drain, dominate instead: the sequential dependence of the
// block rows is the limit, not the card.
//
// Float32 and float64 (two instantiations).
#include <cuda_runtime.h>

#include "tile_mm.cuh"

namespace {

using namespace gpnf;

constexpr int LDT = BS + 1;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    trsm_invert_diag_kernel(const T* __restrict__ l, T* __restrict__ inv,
                            int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ls = reinterpret_cast<T*>(smem_raw);
  T* Xs = Ls + BS * LDT;
  const int s = blockIdx.x * BS;
  const int r = min(BS, n - s);
  for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
    const int i = e / BS, k = e % BS;
    T v;
    if (i < r && k < r) {
      v = (k <= i) ? l[static_cast<long long>(s + i) * n + s + k] : T(0);
    } else {
      v = (i == k) ? T(1) : T(0);
    }
    Ls[i * LDT + k] = v;
  }
  __syncthreads();
  invert_lower_tile(Ls, Xs);
  T* out = inv + static_cast<long long>(blockIdx.x) * BS * BS;
  for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
    out[e] = Xs[(e / BS) * LDT + e % BS];
  }
}

// X_j[:, c0:c0+TP] = M X_j[:, c0:c0+TP] with M = inv_j or inv_j^T
template <typename T, int TP>
__global__ void __launch_bounds__(kThreads)
    trsm_diag_kernel(const T* __restrict__ inv, T* __restrict__ x, int n,
                     int p, int j, int trans) {
  using S = TileShape<TP>;
  __shared__ T As[BS * LDA];
  __shared__ T Bs[KC * S::LDB];
  const int c0 = blockIdx.x * TP;
  const T* inv_j = inv + static_cast<long long>(j) * BS * BS;
  T acc[S::RPT][S::CPT] = {};
  for (int kc = 0; kc < BS; kc += KC) {
    if (trans) {  // As[r][k] = inv_j[kc + k][r]
      load_transposed(As, LDA, BS, KC, inv_j, BS, kc, 0, BS, BS);
    } else {      // As[r][k] = inv_j[r][kc + k]
      load_direct(As, LDA, BS, KC, inv_j, BS, 0, kc, BS, BS);
    }
    load_direct(Bs, S::LDB, KC, TP, x, p, j * BS + kc, c0, n, p);
    __syncthreads();
    mma_chunk<T, TP>(As, Bs, acc);
    __syncthreads();
  }
  store_tile<T, TP>(x + static_cast<long long>(j) * BS * p + c0, p,
                    n - j * BS, p - c0, acc, false);
}

// X_i[:, c0:c0+TP] -= L_ij X_j (or L_ji^T X_j), i the blockIdx.y-th block
// row after j in solve order
template <typename T, int TP>
__global__ void __launch_bounds__(kThreads)
    trsm_update_kernel(const T* __restrict__ l, T* __restrict__ x, int n,
                       int p, int j, int trans) {
  using S = TileShape<TP>;
  __shared__ T As[BS * LDA];
  __shared__ T Bs[KC * S::LDB];
  const int c0 = blockIdx.x * TP;
  const int i = trans ? static_cast<int>(blockIdx.y)
                      : j + 1 + static_cast<int>(blockIdx.y);
  T acc[S::RPT][S::CPT] = {};
  for (int kc = 0; kc < BS; kc += KC) {
    if (trans) {  // As[r][k] = L[j*BS + kc + k][i*BS + r]
      load_transposed(As, LDA, BS, KC, l, n, j * BS + kc, i * BS, n, n);
    } else {      // As[r][k] = L[i*BS + r][j*BS + kc + k]
      load_direct(As, LDA, BS, KC, l, n, i * BS, j * BS + kc, n, n);
    }
    load_direct(Bs, S::LDB, KC, TP, x, p, j * BS + kc, c0, n, p);
    __syncthreads();
    mma_chunk<T, TP>(As, Bs, acc);
    __syncthreads();
  }
  store_tile<T, TP>(x + static_cast<long long>(i) * BS * p + c0, p,
                    n - i * BS, p - c0, acc, true);
}

template <typename T, int TP>
int sweep(const T* l, T* x, const T* inv, int n, int p, int trans,
          cudaStream_t stream) {
  const int nb = (n + BS - 1) / BS;
  const unsigned col_tiles = static_cast<unsigned>((p + TP - 1) / TP);
  cudaError_t err;
  for (int step = 0; step < nb; ++step) {
    const int j = trans ? nb - 1 - step : step;
    trsm_diag_kernel<T, TP><<<col_tiles, kThreads, 0, stream>>>(
        inv, x, n, p, j, trans);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int rows = trans ? j : nb - 1 - j;
    if (rows == 0) continue;
    trsm_update_kernel<T, TP><<<dim3(col_tiles, rows), kThreads, 0, stream>>>(
        l, x, n, p, j, trans);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename T>
int tril_solve(const T* l, T* x, T* inv, int n, int p, int trans,
               cudaStream_t stream) {
  if (n <= 0 || p <= 0 || (n + BS - 1) / BS > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = 2 * BS * LDT * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      trsm_invert_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + BS - 1) / BS;
  trsm_invert_diag_kernel<T><<<nb, kThreads, smem, stream>>>(l, inv, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return p >= 32 ? sweep<T, 64>(l, x, inv, n, p, trans, stream)
                 : sweep<T, 4>(l, x, inv, n, p, trans, stream);
}

}  // namespace

extern "C" int gpnf_tril_solve_f32(const float* l, float* x, float* inv, int n,
                                   int p, int trans, void* stream) {
  return tril_solve<float>(l, x, inv, n, p, trans,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int gpnf_tril_solve_f64(const double* l, double* x, double* inv,
                                   int n, int p, int trans, void* stream) {
  return tril_solve<double>(l, x, inv, n, p, trans,
                            static_cast<cudaStream_t>(stream));
}
