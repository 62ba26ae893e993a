// Lane groups over the K mixture components: the device code that the two
// mixture kernels share (mixture_inverse.cu, mixlogcdf_forward.cu).
//
// One element (b, d) of a (B, K, D) mixture is owned by a group of kGroup
// consecutive lanes of a warp. Component k lives in lane k mod kGroup,
// slot k / kGroup: at kGroup = 4 and K = 32 a lane holds 8 components.
// Where K is not a multiple of kGroup, the lanes past K in the last slot
// hold pad values whose terms are -inf: nothing for the max, an exact 0
// for the sum.
//
// Reductions over k run in one fixed order: over the lane's slots in slot
// order, from 0 (so the first slot's term exactly), then a butterfly of
// __shfl_xor_sync over the offsets kGroup / 2, ..., 1. fp32 addition is
// commutative, so at every step lane j and lane j ^ offset add the same two
// numbers and every lane of the group ends with the same bits: a compare on
// the result (the inverse's bisection) is the same in every lane, with no
// broadcast. No atomics: two calls give the same bits. The sum is the
// plain version's `_sum_k` (ops/kernels/fused_mixture_inverse.py): the
// lanes' sums in slot order, then lane j + lane j + h for h = kGroup / 2,
// ..., 1; tests/test_torch_mixture_lanes.py emulates it lane by lane.
//
// Staging. A block of kThreads takes one batch row and kTileD = kThreads /
// kGroup consecutive d, and copies its (K, kTileD) slabs of pi, mu and
// log s into shared memory with cp.async (16-byte copies where D and the
// three base addresses allow it, else 4-byte ones): every warp-wide copy
// reads consecutive d of one or a few k, so device memory is read in
// whole 32-byte sectors, which lanes mapped to (k, d) for the compute
// would not do. A lane then reads its slots from rows of kLd floats: at
// one slot the lanes of a warp read k = j + kGroup i (j < kGroup) at 32 /
// kGroup consecutive d e, banks kLd j + e (mod 32), and kLd = 32 / kGroup
// times an odd number (mod 32; 8 * 9 at kGroup 4) makes those 32 banks
// distinct (at kGroup 16 two lanes would share a bank: kLd stays a
// multiple of 4 for the 16-byte copies).
//
// kGroup 4 against 2, 8 and 16 (gpnf_tpu_torch/bench_mixture.py, the
// inverse on an H100 80GB HBM3 at 700 W, B 64, K 32): 0.1969 / 0.1049 /
// 0.0583 ms at D 1536 / 768 / 384; kGroup 2 0.1953 / 0.1080 / 0.0714, 8
// 0.2210 / 0.1165 / 0.0639, 16 0.2749 / 0.1458 / 0.0779. Fewer lanes a
// group spend fewer shuffles and per-element instructions on each
// component, more keep enough elements in flight at D 384; the kernel
// runs ~58 instructions a component and evaluation (the accurate expf,
// log1pf and expf; mixture_inverse.cu), and at these shapes the
// instruction throughput of the card, not memory, is its limit.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"  // cp_async16 / cp_async4

namespace mixture {

constexpr int kGroup = 4;        // lanes an element's components spread over
constexpr int kThreads = 256;    // a block
constexpr int kTileD = kThreads / kGroup;  // elements (consecutive d) a block
constexpr int kMaxK = 128;       // components a lane's registers hold
constexpr int kMaxSlots = kMaxK / kGroup;
constexpr int kLd = kTileD + ((32 / kGroup) % 4 == 0 ? 32 / kGroup : 4);
static_assert(32 % kGroup == 0 && kGroup > 1, "a group within a warp");
static_assert(kTileD % 4 == 0 && kLd % 4 == 0, "16-byte staged rows");

// 16-byte copies: D a multiple of 4 floats and every base 16-byte aligned.
inline bool vector_copies(int dim, const void* a, const void* b,
                          const void* c) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return dim % 4 == 0 && bits % 16 == 0;
}

// The (num_k, kTileD) slab src[k * dim + d0 + c] into dst[k * kLd + c],
// zeros where d0 + c >= dim. kPer = 4: 16-byte copies (a chunk is all in
// or all out); 1: 4-byte copies. A thread keeps one column and walks the
// rows kThreads / (kTileD / kPer) apart, so a copy costs two pointer
// increments. Asynchronous: the caller commits and waits.
template <int kPer>
__device__ __forceinline__ void stage_slab(float* dst, const float* src,
                                           int num_k, int dim, int d0) {
  constexpr int kRow = kTileD / kPer;   // copies a row
  constexpr int kRows = kThreads / kRow;  // rows a pass of the block
  static_assert(kThreads % kRow == 0, "whole rows a pass");
  const int c = kPer * (threadIdx.x % kRow);
  const int k0 = threadIdx.x / kRow;
  const bool valid = d0 + c < dim;
  // where !valid nothing is read, but the address must be mapped: src
  const float* from = valid ? src + static_cast<size_t>(k0) * dim + d0 + c
                            : src;
  const size_t step = valid ? static_cast<size_t>(kRows) * dim : 0;
  float* to = dst + k0 * kLd + c;
  for (int k = k0; k < num_k; k += kRows, from += step, to += kRows * kLd) {
    if (kPer == 4) {
      gpnf::cp_async16(to, from, valid);
    } else {
      gpnf::cp_async4(to, from, valid);
    }
  }
}

// Start the copies of one tile (batch row `row`, d from d0) of pi, mu and
// log s into dst: three (K, kLd) slabs, pi's, mu's and log s's in turn.
// The caller commits, waits and synchronizes.
__device__ __forceinline__ void stage_tile(float* dst, const float* pi,
                                           const float* mu,
                                           const float* log_s, int row,
                                           int d0, int num_k, int dim,
                                           bool vec) {
  const size_t base = static_cast<size_t>(row) * num_k * dim;
  const float* src[3] = {pi + base, mu + base, log_s + base};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (vec) {
      stage_slab<4>(dst + a * num_k * kLd, src[a], num_k, dim, d0);
    } else {
      stage_slab<1>(dst + a * num_k * kLd, src[a], num_k, dim, d0);
    }
  }
}

// v reduced over the group by op (Max, Min or Sum below): the butterfly
// over the offsets kGroup / 2, ..., 1, the same bits in every lane. Every
// lane of the warp must call.
template <class Op>
__device__ __forceinline__ float group_reduce(float v, Op op) {
#pragma unroll
  for (int o = kGroup / 2; o > 0; o /= 2) {
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// The slots a lane holds: ceil(K / kGroup). Each kernel is instantiated
// for every count up to kMaxSlots; in the last slot, lanes past K hold pad
// values whose terms are -inf (nothing for the max, an exact 0 for the
// sum), so the slot loops run with no branch.
inline int slots_for(int num_k) { return (num_k + kGroup - 1) / kGroup; }

// launch(std::integral_constant<int, SLOTS>) at SLOTS = slots.
template <int SLOTS = 1, class Launch>
int dispatch_slots(int slots, Launch&& launch) {
  if constexpr (SLOTS < kMaxSlots) {
    if (slots > SLOTS) return dispatch_slots<SLOTS + 1>(slots, launch);
  }
  return launch(std::integral_constant<int, SLOTS>{});
}

// One block of kThreads a tile (batch row, kTileD consecutive d), with one
// stage of staged slabs in dynamic shared memory: kernel_for(slots)(args...,
// num_k, dim, vec) at slots = ceil(K / kGroup). pi, mu and log s decide the
// copies' width. Returns a cudaError_t.
template <class KernelFor, class... Args>
int launch_tiles(KernelFor kernel_for, int batch, int num_k, int dim,
                 const float* pi, const float* mu, const float* log_s,
                 void* stream, Args... args) {
  const long long tiles =
      static_cast<long long>(batch) * ((dim + kTileD - 1) / kTileD);
  if (batch <= 0 || dim <= 0 || num_k <= 0 || num_k > kMaxK ||
      tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = vector_copies(dim, pi, mu, log_s);
  const size_t smem = sizeof(float) * 3 * num_k * kLd;
  return dispatch_slots(slots_for(num_k), [&](auto slots) {
    const auto kernel = kernel_for(slots);
    if (smem > 48 * 1024) {  // opt in above the default 48 KB
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
             static_cast<cudaStream_t>(stream)>>>(args..., num_k, dim, vec);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace mixture
