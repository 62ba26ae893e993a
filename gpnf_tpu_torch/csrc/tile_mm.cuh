// Shared pieces of the blocked GEMM kernels of cholesky.cu (its panel
// products and trailing update): tiles of BS x BS, staged through shared
// memory in k-chunks of KC, multiplied by 256 threads that each hold a
// small register tile of the output.
//
// An output tile is BS rows by TP columns. Thread t owns rows
// rg + RG * a (a < RPT) and columns cg + CG * b (b < CPT), with
// cg = t % CG and rg = t / CG: neighbouring lanes own neighbouring columns,
// so the tile's reads and writes in device memory are coalesced along its
// rows; the A chunk values a warp reads are broadcasts to the lanes of one
// row (a row stride of KC + 1 keeps different rows in different banks), the
// B chunk values consecutive words.
// Every load masks the ragged edge to zero, so any n and p are taken.
#pragma once

#include <cuda_runtime.h>

namespace gpnf {

constexpr int kThreads = 256;
constexpr int BS = 64;  // tile edge: diagonal blocks, panel width
constexpr int KC = 32;  // k-chunk staged in shared memory
constexpr int LDA = KC + 1;

template <int TP>
struct TileShape {
  static constexpr int RPT = TP >= 64 ? 4 : 1;  // rows per thread
  static constexpr int CPT = TP >= 64 ? 4 : 1;  // columns per thread
  static constexpr int RG = BS / RPT;
  static constexpr int CG = TP / CPT;
  static constexpr int LDB = TP + 1;
  static_assert(RG * CG == kThreads, "tile shape must use 256 threads");
};

// dst[r][c] = src[(row0 + r) * lds + col0 + c] for r < R, c < C, zero where
// row0 + r >= nrows or col0 + c >= ncols. Consecutive threads read
// consecutive c (coalesced).
template <typename T>
__device__ __forceinline__ void load_direct(T* dst, int ldd, int R, int C,
                                            const T* src, long long lds,
                                            int row0, int col0, int nrows,
                                            int ncols) {
  for (int e = threadIdx.x; e < R * C; e += kThreads) {
    const int r = e / C, c = e - (e / C) * C;
    const int gr = row0 + r, gc = col0 + c;
    dst[r * ldd + c] = (gr < nrows && gc < ncols)
                           ? src[static_cast<long long>(gr) * lds + gc]
                           : T(0);
  }
}

// dst[r][c] = src[(row0 + c) * lds + col0 + r] (a transposed tile), zero
// where row0 + c >= nrows or col0 + r >= ncols. Consecutive threads read
// consecutive r (coalesced) and write at the padded stride ldd.
template <typename T>
__device__ __forceinline__ void load_transposed(T* dst, int ldd, int R, int C,
                                                const T* src, long long lds,
                                                int row0, int col0, int nrows,
                                                int ncols) {
  for (int e = threadIdx.x; e < R * C; e += kThreads) {
    const int r = e % R, c = e / R;
    const int gr = row0 + c, gc = col0 + r;
    dst[r * ldd + c] = (gr < nrows && gc < ncols)
                           ? src[static_cast<long long>(gr) * lds + gc]
                           : T(0);
  }
}

// acc += As (BS x KC, stride LDA) . Bs (KC x TP, stride LDB)
template <typename T, int TP>
__device__ __forceinline__ void mma_chunk(const T* As, const T* Bs,
                                          T (&acc)[TileShape<TP>::RPT]
                                                  [TileShape<TP>::CPT]) {
  using S = TileShape<TP>;
  const int cg = threadIdx.x % S::CG, rg = threadIdx.x / S::CG;
#pragma unroll 8
  for (int k = 0; k < KC; ++k) {
    T a[S::RPT], b[S::CPT];
#pragma unroll
    for (int i = 0; i < S::RPT; ++i) a[i] = As[(rg + S::RG * i) * LDA + k];
#pragma unroll
    for (int j = 0; j < S::CPT; ++j) b[j] = Bs[k * S::LDB + cg + S::CG * j];
#pragma unroll
    for (int i = 0; i < S::RPT; ++i)
#pragma unroll
      for (int j = 0; j < S::CPT; ++j) acc[i][j] += a[i] * b[j];
  }
}

// out[r][c] = (subtract ? out[r][c] - acc : acc) for the thread's entries,
// masked to rows < nrows and columns < ncols. `out` points at the tile's
// (0, 0) entry with row stride ldo.
template <typename T, int TP>
__device__ __forceinline__ void store_tile(T* out, long long ldo, int rows_left,
                                           int cols_left,
                                           const T (&acc)[TileShape<TP>::RPT]
                                                         [TileShape<TP>::CPT],
                                           bool subtract) {
  using S = TileShape<TP>;
  const int cg = threadIdx.x % S::CG, rg = threadIdx.x / S::CG;
#pragma unroll
  for (int i = 0; i < S::RPT; ++i) {
    const int r = rg + S::RG * i;
    if (r >= rows_left) continue;
#pragma unroll
    for (int j = 0; j < S::CPT; ++j) {
      const int c = cg + S::CG * j;
      if (c >= cols_left) continue;
      T* o = out + static_cast<long long>(r) * ldo + c;
      *o = subtract ? *o - acc[i][j] : acc[i][j];
    }
  }
}

}  // namespace gpnf
