// The qkv projection of GatedAttn and its backward (dseq, dW) around the
// key-tiled attention kernels, for S <= 512, hand-written for Hopper
// (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py, the products that
// `_fwd_kernel_proj` (`_kernel_proj_qkv`: qkv = seq w^T) and
// `_bwd_kernel_proj` (dseq = dqkv w, dW = dqkv^T seq) compute in their own
// body. For S <= 512 the JAX package runs those kernels at every width. The
// port runs the proj forward in one kernel (fused_attention_proj.cu) at the
// shapes `attention_route` names "proj". Everywhere else at S <= 512 the
// forward, and at every S <= 512 the backward, are these products around the
// key-tiled kernels of fused_attention_long.cu, which take qkv and give
// dqkv. Above S = 512 the JAX package's `fused_attention_long` leaves the
// products to XLA, and so does the port (torch.matmul).
//
// One kernel, c (M x N) = A (M x K) B (K x N) in float32, c row-major:
//   qkv  = seq w^T:    A = seq (B S x C),  B = w^T (w is 3C x C),  N = 3C
//   dseq = dqkv w:     A = dqkv (B S x 3C), B = w,                  N = C
//   dW   = dqkv^T seq: A = dqkv^T,          B = seq,                K = B S
// TRANS_A reads A from a (K x M) array, TRANS_B reads B from an (N x K) one.
//
// What bounds it on the H100: operations. At the CLIs' width (C = 512) and
// the 32-px level 0 (B = 16, S = 256) each of the three products is 2 x 4096
// x 1536 x 512 = 6.4 GFLOP, >= ~96 us at the fp32 rate outside the tensor
// cores (67 TFLOP/s); the bytes (at most 4 (4096 x 1536 + 4096 x 512 +
// 1536 x 512) = 36.7 MB) need ~11 us. At the flagship's widths (C = 96)
// each product is 0.06-0.9 GFLOP: 1-14 us.
//
// Design: tile_mm.cuh's tiles (the Cholesky's GEMM): a block of 256 threads
// per 64 x 64 tile of c, the K axis staged through shared memory in chunks
// of 32, each thread a 4 x 4 register tile. A transposed operand is read
// along its contiguous axis and written transposed into shared memory, so
// every load from device memory is coalesced.
// Few output tiles and a long K (dW at C = 96 has 10 tiles and K = B S up
// to 16,384; dseq at small B S) would leave most SMs idle while a few
// blocks walk the whole K axis. So K is split: `splits` blocks
// (blockIdx.z) per tile, split z summing the K rows [z chunk, min(K,
// (z + 1) chunk)), chunk a multiple of 32. The wrapper picks `splits` from
// the shape alone (fused_attention.py, `gemm_splits`). With one split the
// block writes c; with more, each writes its (M x N) partial and a second
// kernel adds the partials in split order. Every c entry sums its products
// in one fixed order, so two calls give the same bits; no atomics.
#include <cuda_runtime.h>

#include "tile_mm.cuh"

namespace {

using gpnf::BS;
using gpnf::KC;
using gpnf::LDA;
using gpnf::kThreads;
using Tile = gpnf::TileShape<gpnf::BS>;

// Split z = blockIdx.z of c = A B: the K rows [z chunk, min(k, (z + 1)
// chunk)) into out + z m n. Without SPLIT, the whole K axis into c, with
// the loop bounds of a GEMM that has no split: computed bounds made the
// unsplit projection 7% slower on the H100 (0.0613 against 0.0572 ms at
// C = 96, B S = 16384; 0.3369 against 0.3183 at C = 512, B S = 4096).
template <bool TRANS_A, bool TRANS_B, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int m, int n, int k, int chunk) {
  __shared__ float As[BS * LDA];
  __shared__ float Bs[KC * Tile::LDB];
  const int m0 = blockIdx.y * BS, n0 = blockIdx.x * BS;
  const int k_begin = SPLIT ? blockIdx.z * chunk : 0;
  const int k_end = SPLIT ? min(k, k_begin + chunk) : k;
  float acc[Tile::RPT][Tile::CPT] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += KC) {
    if (TRANS_A) {
      gpnf::load_transposed(As, LDA, BS, KC, a, m, k0, m0, k_end, m);
    } else {
      gpnf::load_direct(As, LDA, BS, KC, a, k, m0, k0, m, k_end);
    }
    if (TRANS_B) {
      gpnf::load_transposed(Bs, Tile::LDB, KC, BS, b, k, n0, k0, n, k_end);
    } else {
      gpnf::load_direct(Bs, Tile::LDB, KC, BS, b, n, k0, n0, k_end, n);
    }
    __syncthreads();
    gpnf::mma_chunk<float, BS>(As, Bs, acc);
    __syncthreads();
  }
  float* part =
      SPLIT ? out + static_cast<long long>(blockIdx.z) * m * n : out;
  gpnf::store_tile<float, BS>(part + static_cast<long long>(m0) * n + n0, n,
                              m - m0, n - n0, acc, false);
}

// c[i] = sum over z of partial[z][i], z in order: the splits' fixed-order
// sum.
__global__ void __launch_bounds__(kThreads)
    sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ c,
                      long long count, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= count) return;
  float acc = partial[i];
  for (int z = 1; z < splits; ++z) acc += partial[z * count + i];
  c[i] = acc;
}

template <bool TRANS_A, bool TRANS_B>
cudaError_t launch(const float* a, const float* b, float* c, float* partial,
                   int m, int n, int k, int splits, int chunk,
                   cudaStream_t stream) {
  const dim3 grid((n + BS - 1) / BS, (m + BS - 1) / BS, splits);
  if (splits == 1) {
    gemm_kernel<TRANS_A, TRANS_B, false><<<grid, kThreads, 0, stream>>>(
        a, b, c, m, n, k, chunk);
    return cudaGetLastError();
  }
  gemm_kernel<TRANS_A, TRANS_B, true><<<grid, kThreads, 0, stream>>>(
      a, b, partial, m, n, k, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(m) * n;
  sum_splits_kernel<<<static_cast<unsigned>((count + kThreads - 1) / kThreads),
                      kThreads, 0, stream>>>(partial, c, count, splits);
  return cudaGetLastError();
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
  if (m <= 0 || n <= 0 || k <= 0 || (m + BS - 1) / BS > 65535 ||
      (trans_a && trans_b) || splits <= 0 || splits > 65535 ||
      static_cast<long long>(splits - 1) * chunk >= k ||
      (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      trans_a   ? launch<true, false>(a, b, c, partial, m, n, k, splits, chunk, s)
      : trans_b ? launch<false, true>(a, b, c, partial, m, n, k, splits, chunk, s)
                : launch<false, false>(a, b, c, partial, m, n, k, splits, chunk,
                                       s);
  return static_cast<int>(err);
}
