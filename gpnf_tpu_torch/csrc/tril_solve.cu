// Blocked lower-triangular solve L X = B or L^T X = B, hand-written for
// Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/trisolve.py, `_solve_kernel` (launched by
// `pallas_tril_solve` from `tril_solve`): block substitution with each
// 128 x 128 diagonal block inverted exactly (`_newton_tril_inv`) and the
// off-diagonal updates as matmuls, L and B resident in VMEM, one launch.
//
// Here one left-looking sweep launch, X (a copy of B) overwritten in
// place. One logical block per (row block i of BS rows, column tile c of
// TP columns: 4 wide when p < 32, else 64); its index is a ticket from an
// atomic counter, handed out row by row in solve order (i ascending for
// L, descending for L^T), so a block only ever waits on blocks that hold
// an earlier ticket and are running or done: no deadlock at any n or p,
// with no co-residency assumed. Block (i, c):
//   1. inverts its diagonal tile L_ii in registers (`invert_tile`);
//   2. acc = B_i - sum_j L_ij X_j over the row blocks j before i in solve
//      order, in that fixed order (for L^T the tiles L_ji^T, read along
//      the rows of L), each product summed on its own, then subtracted;
//      X_j is awaited on its ready flag. The L tiles depend on no flag:
//      they are prefetched with cp.async, double-buffered, and the next
//      X_j is loaded during the product when its flag is already set;
//   3. X_i = L_ii^-1 acc (or L_ii^-T acc), stored, then its flag released
//      (the stores, a fence, a release store; the waiter's acquire load,
//      a barrier, and loads of X at L2, around the SM's L1).
// The order of every sum is fixed, so two calls give the same bits. The
// row panel of L is read by the column tiles of one row at about the same
// time, from L2. A solve is one launch, beside the caller's zero fill of
// the flags (a 64-row block's tile chain was 2 launches, 2 n/64 in all).
//
// What bounds it on the H100: at p = n operations (n^2 p FMAs: 68.7 GFLOP
// at n = p = 4096, 1.03 ms at 67 TFLOP/s fp32); at p = 1 bytes (L read
// once, 33.5 MB at n = 4096 in fp32: 10 us at 3.35 TB/s). At p = 1 the
// chain of n/BS dependent steps sets the time instead, ~2.7 us a step:
// a flag's round trip through L2, the X_j tile's load at L2, a 64 x 64
// product with the tile already in shared memory, the inverse's product,
// the stores and the fence (0.15 us of it: a build without the fence took
// 0.0535 against 0.0570 ms at n = 1024). At p = n the 4 x 4 register tile
// fed from shared memory: 3.25 ms at n = 4096 is 21 TFLOP/s, two blocks
// an SM at 128 registers (80 bytes spilled); one block an SM (200
// registers, no spill) is 10% faster at n = 1024 and 20% slower at 4096.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (bench_linalg.py --kernel
// tril_solve, medians of 20 cold-L2 calls, each with the copy of B and the
// flags' zero fill), ms, this version / the 2 n/64-launch right-looking
// sweep before it / torch.linalg.solve_triangular, float32:
//   n = 1024, p = 1:     0.0557 / 0.2347 / 0.0745
//   n = 4096, p = 1:     0.182  / 0.909  / 0.260
//   n = 1024, p = 1024:  0.144  / 0.417  / 0.291
//   n = 4096, p = 4096:  3.25   / 5.38   / 2.85
// and 7.62 / 7.72 / 3.40 at n = p = 4096 in float64.
//
// Float32 and float64 (two instantiations). The C entry points take L, X
// (B on entry), a scratch of `tril_solve_scratch_words(n, p)` int32 words
// (ops/kernels/trisolve.py) zeroed by the caller, n, p, trans and the
// stream.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BS = 64;       // row-block height, the diagonal tile's edge
constexpr int LDT = BS + 1;  // stride of the diagonal tile being inverted
constexpr int LDA = BS + 4;  // stride of a k-major tile (16-byte rows)
constexpr unsigned kFull = 0xffffffffu;

// A thread's register tile of a BS x TP output tile: RPT consecutive rows
// from RPT (t / CG) and CPT consecutive columns from CPT (t % CG), so a
// k step reads both as 16-byte runs from k-major tiles in shared memory.
template <int TP>
struct Shape {
  static constexpr int RPT = TP >= 64 ? 4 : 1;
  static constexpr int CPT = TP >= 64 ? 4 : 1;
  static constexpr int CG = TP / CPT;
  static constexpr int LDX = TP >= 64 ? TP + 4 : TP;  // stride of an X tile
  static constexpr int XPT = BS * TP / kThreads;      // X loads a thread
  static_assert((BS / RPT) * CG == kThreads, "256 threads a tile");
};

// ---- ordering between blocks ------------------------------------------------
__device__ __forceinline__ int load_acquire(const int* f) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(f)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* f, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(f), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// one thread spins on the flag (acquire, with a short backoff), then the
// block's barrier: every thread may then read what the flag's producer
// stored before it (at L2: L1 is not coherent across SMs). A flag still
// unset after 10 s (a scratch that was not zeroed) traps: the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void wait_flag(const int* f) {
  if (threadIdx.x == 0 && load_acquire(f) == 0) {
    const unsigned long long t0 = global_ns();
    unsigned ns = 16;
    do {
      __nanosleep(ns);
      ns = ns < 128 ? 2 * ns : ns;
      if (global_ns() - t0 > 10000000000ull) __trap();
    } while (load_acquire(f) == 0);
  }
  __syncthreads();
}

// a load at L2, around L1 (ld.global.cg), never moved across a barrier
__device__ __forceinline__ float load_cg(const float* a) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(a) : "memory");
  return v;
}

__device__ __forceinline__ double load_cg(const double* a) {
  double v;
  asm volatile("ld.global.cg.f64 %0, [%1];" : "=d"(v) : "l"(a) : "memory");
  return v;
}

// ---- tiles in shared memory -----------------------------------------------
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d),
               "l"(src), "n"(sizeof(T)),
               "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The BS x BS tile of L at (row0, col0) into shared memory with cp.async:
// element (a, b) to dst[b * ld + a] when `transpose`, else dst[a * ld + b];
// zero outside the n x n matrix, and above the diagonal when `lower`.
// Consecutive threads read consecutive columns of L (coalesced).
template <typename T>
__device__ __forceinline__ void load_l_tile(T* dst, int ld, const T* l, int n,
                                            int row0, int col0, bool transpose,
                                            bool lower) {
  for (int e = threadIdx.x; e < BS * BS; e += kThreads) {
    const int a = e / BS, b = e % BS;
    const int gr = row0 + a, gc = col0 + b;
    const bool ok = gr < n && gc < n && (!lower || b <= a);
    cp_async(transpose ? &dst[b * ld + a] : &dst[a * ld + b],
             ok ? l + static_cast<long long>(gr) * n + gc : l, ok);
  }
}

// a run of 4 consecutive values from shared memory, in 16-byte loads
__device__ __forceinline__ void load_run(const float* s, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(s);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__device__ __forceinline__ void load_run(const double* s, double (&v)[4]) {
  const double2 q0 = *reinterpret_cast<const double2*>(s);
  const double2 q1 = *reinterpret_cast<const double2*>(s + 2);
  v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
}

// acc += A . X for the thread's register tile; At is A k-major (At[k][r],
// stride LDA), Xs the BS x TP tile (stride LDX); k in a fixed order. A
// thread with one output (TP = 4) keeps four partial sums over k mod 4,
// added in a fixed order at the end: a chain of 16 dependent FMAs, not
// 64, on the p = 1 solve's critical path.
template <typename T, int TP>
__device__ __forceinline__ void tile_product(
    const T* At, const T* Xs, T (&acc)[Shape<TP>::RPT][Shape<TP>::CPT]) {
  using S = Shape<TP>;
  const int r0 = S::RPT * (threadIdx.x / S::CG);
  const int c0 = S::CPT * (threadIdx.x % S::CG);
  if constexpr (S::RPT * S::CPT == 1) {
    T sum[4] = {};
#pragma unroll 4
    for (int k = 0; k < BS; k += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sum[q] = fma(At[(k + q) * LDA + r0], Xs[(k + q) * S::LDX + c0], sum[q]);
    }
    acc[0][0] += (sum[0] + sum[1]) + (sum[2] + sum[3]);
  } else {
#pragma unroll 8
    for (int k = 0; k < BS; ++k) {
      T a[S::RPT], b[S::CPT];
      load_run(At + k * LDA + r0, a);
      load_run(Xs + k * S::LDX + c0, b);
#pragma unroll
      for (int i = 0; i < S::RPT; ++i)
#pragma unroll
        for (int j = 0; j < S::CPT; ++j)
          acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
  }
}

// The k-major inverse (stride LDA) of the lower tile Ls (stride LDT, zero
// above the diagonal, the identity's rows from `rows` on): Inv[k][r] =
// Ls^-1[r][k], or Ls^-1[k][r] when `transpose` (the inverse of L_ii^T).
// Warp w solves columns 8w..8w+7 by forward substitution in registers:
// lane l holds rows l and l + 32 of its eight columns; at step k the lane
// of row k scales its entries by 1 / L_kk and passes them by shuffle, and
// every lane subtracts L[row][k] times them from its rows below k. No
// block barrier: the eight columns of a warp interleave to hide the chain.
template <typename T>
__device__ __forceinline__ void invert_tile(const T* Ls, T* Inv, int rows,
                                            bool transpose) {
  const int lane = threadIdx.x & 31, col0 = (threadIdx.x >> 5) * 8;
  const T d0 = lane < rows ? T(1) / Ls[lane * LDT + lane] : T(1);
  const T d1 =
      lane + 32 < rows ? T(1) / Ls[(lane + 32) * LDT + lane + 32] : T(1);
  T r[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q)
      r[h][q] = (lane + 32 * h == col0 + q) ? T(1) : T(0);
#pragma unroll
  for (int k = 0; k < BS; ++k) {
    const int hk = k >> 5, src = k & 31;
    const T dk = __shfl_sync(kFull, hk ? d1 : d0, src);
    T xk[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      xk[q] = __shfl_sync(kFull, r[hk][q], src) * dk;
#pragma unroll
    for (int h = hk; h < 2; ++h) {  // rows l + 32 h below k, or row k
      const T lk = Ls[(lane + 32 * h) * LDT + k];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        r[h][q] = (h == hk && lane == src) ? xk[q] : fma(-lk, xk[q], r[h][q]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int row = lane + 32 * h, col = col0 + q;
      Inv[transpose ? row * LDA + col : col * LDA + row] = r[h][q];
    }
}

template <typename T, int TP>
constexpr int sweep_smem_bytes() {
  return (3 * BS * LDA + BS * Shape<TP>::LDX) * static_cast<int>(sizeof(T));
}

// Two blocks an SM in float32 at TP = 64: 128 registers a thread at most
// (unbounded, ptxas took 171: one block an SM) and 70 KB of shared memory
// each. Float64's 64-wide tile takes 139 KB: one block an SM.
template <typename T, int TP>
constexpr int kMinBlocks = sizeof(T) == 4 && TP >= 64 ? 2 : 1;

// One logical block of the sweep (see the header). sync[0] is the ticket
// counter, sync[1 + i * ct + c] the ready flag of column tile c of X_i;
// all zero at launch.
template <typename T, int TP>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T, TP>)
    trsm_sweep_kernel(const T* __restrict__ l, T* __restrict__ x,
                      int* __restrict__ sync, int n, int p, int trans) {
  using S = Shape<TP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const lbuf = reinterpret_cast<T*>(smem_raw);  // two L tiles
  T* const inv = lbuf + 2 * BS * LDA;
  T* const xs = inv + BS * LDA;
  __shared__ int ticket, next_ready;
  if (threadIdx.x == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int nb = (n + BS - 1) / BS, ct = (p + TP - 1) / TP;
  const int m = ticket / ct;  // row blocks before this one in solve order
  const int tile = ticket - m * ct;
  const int cc0 = tile * TP;
  const int i = trans ? nb - 1 - m : m;
  const int* flags = sync + 1 + tile;  // flags[j * ct]: X_j's tile
  auto block_j = [&](int s) { return trans ? nb - 1 - s : s; };
  // step s's tile of op(L), k-major: L_ij^T, or for L^T the tile L_ji
  auto load_step = [&](int s) {
    const int j = block_j(s);
    load_l_tile(lbuf + (s & 1) * BS * LDA, LDA, l, n,
                trans ? j * BS : i * BS, trans ? i * BS : j * BS, !trans,
                false);
  };
  T xr[S::XPT];  // the next X_j tile, in flight
  auto load_x = [&](int s) {
    const int j = block_j(s);
#pragma unroll
    for (int e = 0; e < S::XPT; ++e) {
      const int idx = threadIdx.x + kThreads * e;
      const int gr = j * BS + idx / TP, gc = cc0 + idx % TP;
      xr[e] = (gr < n && gc < p)
                  ? load_cg(x + static_cast<long long>(gr) * p + gc)
                  : T(0);
    }
  };

  // the diagonal tile (stride LDT) into the buffer of step 1
  load_l_tile(lbuf + BS * LDA, LDT, l, n, i * BS, i * BS, false, true);
  cp_async_commit();
  if (m > 0) load_step(0);
  cp_async_commit();
  const int r0 = S::RPT * (threadIdx.x / S::CG);
  const int c0 = S::CPT * (threadIdx.x % S::CG);
  T acc[S::RPT][S::CPT];
#pragma unroll
  for (int a = 0; a < S::RPT; ++a)
#pragma unroll
    for (int b = 0; b < S::CPT; ++b) {
      const int gr = i * BS + r0 + a, gc = cc0 + c0 + b;
      acc[a][b] = (gr < n && gc < p) ? x[static_cast<long long>(gr) * p + gc]
                                     : T(0);
    }
  cp_async_wait<1>();
  __syncthreads();
  invert_tile(lbuf + BS * LDA, inv, min(BS, n - i * BS), trans != 0);
  if (m > 0) {
    wait_flag(flags + block_j(0) * ct);
    load_x(0);
  }
  __syncthreads();

  for (int s = 0; s < m; ++s) {
#pragma unroll
    for (int e = 0; e < S::XPT; ++e) {
      const int idx = threadIdx.x + kThreads * e;
      xs[(idx / TP) * S::LDX + idx % TP] = xr[e];
    }
    if (s + 1 < m) load_step(s + 1);
    cp_async_commit();
    if (threadIdx.x == 0) {
      next_ready = s + 1 < m && load_acquire(flags + block_j(s + 1) * ct);
    }
    cp_async_wait<1>();
    __syncthreads();
    const bool ready = next_ready;
    if (ready) load_x(s + 1);  // lands during the product
    T part[S::RPT][S::CPT] = {};
    tile_product<T, TP>(lbuf + (s & 1) * BS * LDA, xs, part);
#pragma unroll
    for (int a = 0; a < S::RPT; ++a)
#pragma unroll
      for (int b = 0; b < S::CPT; ++b) acc[a][b] -= part[a][b];
    if (s + 1 < m && !ready) {
      wait_flag(flags + block_j(s + 1) * ct);
      load_x(s + 1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < S::RPT; ++a)
#pragma unroll
    for (int b = 0; b < S::CPT; ++b) xs[(r0 + a) * S::LDX + c0 + b] = acc[a][b];
  __syncthreads();
  T out[S::RPT][S::CPT] = {};
  tile_product<T, TP>(inv, xs, out);
#pragma unroll
  for (int a = 0; a < S::RPT; ++a)
#pragma unroll
    for (int b = 0; b < S::CPT; ++b) {
      const int gr = i * BS + r0 + a, gc = cc0 + c0 + b;
      if (gr < n && gc < p) x[static_cast<long long>(gr) * p + gc] = out[a][b];
    }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    store_release(sync + 1 + tile + i * ct, 1);
  }
}

template <typename T, int TP>
int sweep(const T* l, T* x, int* sync, int n, int p, int trans,
          cudaStream_t stream) {
  const long long blocks = static_cast<long long>((n + BS - 1) / BS) *
                           ((p + TP - 1) / TP);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = sweep_smem_bytes<T, TP>();
  cudaError_t err = cudaFuncSetAttribute(
      trsm_sweep_kernel<T, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  trsm_sweep_kernel<T, TP><<<static_cast<unsigned>(blocks), kThreads, smem,
                             stream>>>(l, x, sync, n, p, trans);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int tril_solve(const T* l, T* x, int* sync, int n, int p, int trans,
               cudaStream_t stream) {
  if (n <= 0 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return p >= 32 ? sweep<T, 64>(l, x, sync, n, p, trans, stream)
                 : sweep<T, 4>(l, x, sync, n, p, trans, stream);
}

}  // namespace

extern "C" int gpnf_tril_solve_f32(const float* l, float* x, int* sync, int n,
                                   int p, int trans, void* stream) {
  return tril_solve<float>(l, x, sync, n, p, trans,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int gpnf_tril_solve_f64(const double* l, double* x, int* sync,
                                   int n, int p, int trans, void* stream) {
  return tril_solve<double>(l, x, sync, n, p, trans,
                            static_cast<cudaStream_t>(stream));
}
