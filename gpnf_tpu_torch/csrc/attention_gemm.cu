// The qkv projection of GatedAttn's wide route and its backward (dseq, dW),
// for S <= 512, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_attention.py, the products that
// `_fwd_kernel_proj` (`_kernel_proj_qkv`: qkv = seq w^T) and
// `_bwd_kernel_proj` (dseq = dqkv w, dW = dqkv^T seq) compute in their own
// body. For S <= 512 the JAX package runs those kernels at every width; the
// port's proj kernel (fused_attention_proj.cu) keeps a whole head and its
// 3 Dh weight rows in shared memory and so takes only the shapes
// `attention_route` names "proj". Everywhere else at S <= 512 GatedAttn
// takes the wide route: these products around the key-tiled kernels of
// fused_attention_long.cu, which take qkv and give dqkv. Above S = 512 the
// JAX package's `fused_attention_long` leaves the products to XLA, and so
// does the port (torch.matmul).
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
// 1536 x 512) = 36.7 MB) need ~11 us.
//
// Design: tile_mm.cuh's tiles (the Cholesky's and the solve's GEMM): a
// block of 256 threads per 64 x 64 tile of c, the K axis staged through
// shared memory in chunks of 32, each thread a 4 x 4 register tile. A
// transposed operand is read along its contiguous axis and written
// transposed into shared memory, so every load from device memory is
// coalesced. Each c entry sums its K products in one fixed order, so two
// calls give the same bits (dW needs no partial sums across blocks).
#include <cuda_runtime.h>

#include "tile_mm.cuh"

namespace {

using gpnf::BS;
using gpnf::KC;
using gpnf::LDA;
using gpnf::kThreads;
using Tile = gpnf::TileShape<gpnf::BS>;

template <bool TRANS_A, bool TRANS_B>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int m, int n, int k) {
  __shared__ float As[BS * LDA];
  __shared__ float Bs[KC * Tile::LDB];
  const int m0 = blockIdx.y * BS, n0 = blockIdx.x * BS;
  float acc[Tile::RPT][Tile::CPT] = {};
  for (int k0 = 0; k0 < k; k0 += KC) {
    if (TRANS_A) {
      gpnf::load_transposed(As, LDA, BS, KC, a, m, k0, m0, k, m);
    } else {
      gpnf::load_direct(As, LDA, BS, KC, a, k, m0, k0, m, k);
    }
    if (TRANS_B) {
      gpnf::load_transposed(Bs, Tile::LDB, KC, BS, b, k, n0, k0, n, k);
    } else {
      gpnf::load_direct(Bs, Tile::LDB, KC, BS, b, n, k0, n0, k, n);
    }
    __syncthreads();
    gpnf::mma_chunk<float, BS>(As, Bs, acc);
    __syncthreads();
  }
  gpnf::store_tile<float, BS>(c + static_cast<long long>(m0) * n + n0, n,
                              m - m0, n - n0, acc, false);
}

template <bool TRANS_A, bool TRANS_B>
cudaError_t launch(const float* a, const float* b, float* c, int m, int n,
                   int k, cudaStream_t stream) {
  const dim3 grid((n + BS - 1) / BS, (m + BS - 1) / BS);
  gemm_kernel<TRANS_A, TRANS_B><<<grid, kThreads, 0, stream>>>(a, b, c, m, n,
                                                                k);
  return cudaGetLastError();
}

}  // namespace

// c (m x n) = A B as above; trans_a and trans_b are 0 or 1, not both 1
// (no product of the three reads both operands transposed).
extern "C" int gpnf_attention_gemm(const float* a, const float* b, float* c,
                                   int m, int n, int k, int trans_a,
                                   int trans_b, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + BS - 1) / BS > 65535 ||
      (trans_a && trans_b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      trans_a   ? launch<true, false>(a, b, c, m, n, k, s)
      : trans_b ? launch<false, true>(a, b, c, m, n, k, s)
                : launch<false, false>(a, b, c, m, n, k, s);
  return static_cast<int>(err);
}
