// The PixelCNN++ gated residual conv of the coupling networks, forward with
// in-kernel Dropout2d and backward, hand-written for Hopper (sm_90a).
//
// Replaces: gpnf_tpu/ops/pallas/fused_gated_conv.py, `_fwd_kernel` and
// `_bwd_kernel` (both launched by `_run`, from `fused_gated_conv`).
//
// Per pixel of x (B, H, W, C), channel-last, with w1 (3, 3, 2C, C) the 3x3
// taps input-major and wg (2C, 2C) the 1x1 gate input-major:
//   h1 = concat_elu(x) = elu([x, -x]),  elu(z) = z > 0 ? z : exp(z) - 1
//   h  = conv3x3_same(h1, w1) + b1                       (C)
//   h2 = concat_elu(h) * s,  s[b, j] = keep ? 1 / (1 - rate) : 0   (2C)
//   [a | g] = h2 @ wg + bg;  out = a * sigmoid(g) + x
// The keep bit of channel j of batch row b is `bits >= threshold`, bits
// from philox.cuh as a pure function of (seed, b, j), one per (b, channel)
// and constant over space, as torch's Dropout2d; the seed is read on the
// device. Backward (the Pallas `_bwd_kernel`), with G = d out:
//   da = G sig;  dg = G a sig (1 - sig);  dG2 = [da | dg]
//   dwg = sum over pixels of h2^T dG2;  dbg = sum of dG2
//   dh2 = (dG2 @ wg^T) * s;  dh = dh2[:C] elu'(h) - dh2[C:] elu'(-h)
//   db1 = sum of dh;  dw1[ky, kx] = sum over pixels of h1(shifted)^T dh
//   dh1 = conv3x3_transposed(dh, w1);  dx = dh1[:C] elu'(x) - dh1[C:] elu'(-x) + G
// All arithmetic is fp32.
//
// What bounds it on the H100: operations. The forward is 2 * (9 * 2C * C +
// 2C * 2C) = 405,504 FLOP a pixel at C = 96 (the conv 331,776, the gate
// 73,728): at batch 64, 99.2 / 24.8 / 6.2 us at the 32-px levels and
// 396.6 us at the 64-px level 0 at 67 TFLOP/s, against 3.8 us for the bytes
// of x and out at level 0. The backward is three times that (recompute,
// dh2 and dwg, dw1 and dh1): 1,216,512 FLOP a pixel.
//
// Design (simple and exact first; tensor cores and TMA are later work). The
// Pallas kernel holds a batch block, both weights whole and every
// intermediate in 16 MB of VMEM; here w1 alone (663 KB at C = 96) is three
// times a block's shared memory, and the conv needs all C channels of h at
// a pixel before the second concat-ELU and the gate can run. So:
//   - forward, one block of 256 threads per (image, 8 x 8 output tile): the
//     tile's concat-ELU(x) with a one-pixel halo in shared memory
//     (10 x 10 x 2C), w1 streamed through shared memory in chunks of 8
//     input channels (all 9 taps), then wg in chunks of 8 rows. Thread t
//     owns pixels t / 16 + 16 a (a < 4) and channels t % 16 + 16 j: h (4 x
//     C/16 values) stays in registers, h2 goes to shared memory over the
//     halo's place, and the thread holds both gate halves (a and g) of its
//     channels, so the GLU and the residual run in registers. Between x
//     and out nothing goes to device memory. Shared memory: 4 * (100 * 2C
//     + 72 C + 2C) bytes, 105 KB at C = 96 (two blocks an SM);
//   - backward, kernel 1 per tile: the forward again up to [a | g], then
//     dG2 (into shared memory), dh2 = dG2 @ wg^T with wg^T streamed, and
//     dh in registers, next to the h it needs. It writes dh (B, H, W, C),
//     dG2 and h2 (B, H, W, 2C each) to scratch in device memory;
//   - backward, kernel 2 per tile: dh1 as the transposed conv of dh read
//     with its one-pixel halo from the scratch (the halo of dh is why this
//     is a second launch), w1 streamed in chunks of 8 output channels,
//     then dx, as kernel 1's layout;
//   - the weight gradients are sums over every pixel. A plain fp32 GEMM
//     (64 x 64 output tiles, 4 x 4 outputs a thread) splits the pixels into
//     fixed chunks and writes one partial per chunk: dwg from h2^T dG2, dw1
//     from im2col(concat_elu(x))^T dh, computed from x as it is loaded
//     (the Pallas kernel's nine shifted products as one), each with a row
//     of ones that gives the bias gradient. A last kernel adds the partials
//     in chunk order: no atomics, the gradients repeat bit for bit.
// Small grids: at the 32-px level 2 (4 x 4 images) a block's 8 x 8 tile
// holds 16 live pixels, so batch 64 gives 64 blocks with a quarter of
// their threads' pixels live; level 1 (8 x 8) 64 full blocks; level 0
// (16 x 16) 256; the 64-px level 0 (32 x 32) 1,024. Not tuned here.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;                 // output tile edge, pixels
constexpr int kHalo = kTile + 2;         // the tile with a one-pixel halo
constexpr int kPix = kTile * kTile;      // 64 output pixels a block
constexpr int kHaloPix = kHalo * kHalo;  // 100
constexpr int kKc = 8;                   // channels a staged weight chunk
constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90

template <int C>
struct Shape {
  static constexpr int C2 = 2 * C;
  static constexpr int OPT = (C + 15) / 16;  // channels a thread owns
  static constexpr bool kFull = C % 16 == 0;
  // floats of shared memory of each kernel
  static constexpr int kFwd = kHaloPix * C2 + 9 * kKc * C + C2;
  static constexpr int kBwdTile = kFwd + kPix * C2;
  static constexpr int kBwdDx = kHaloPix * C + 9 * kKc * C2;
  static_assert(kBwdTile * 4 <= kMaxSharedBytes &&
                    kBwdDx * 4 <= kMaxSharedBytes,
                "a width whose tiles exceed a block's shared memory");
  static_assert(C % kKc == 0, "C must be a multiple of the weight chunk");
};

__device__ __forceinline__ float elu(float z) {
  return z > 0.f ? z : expf(z) - 1.f;
}

__device__ __forceinline__ float delu(float z) {
  return z > 0.f ? 1.f : expf(z);
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(int block, int height, int width) {
  const int tiles_x = (width + kTile - 1) / kTile;
  const int tiles = tiles_x * ((height + kTile - 1) / kTile);
  const int r = block % tiles;
  return Tile{block / tiles, (r / tiles_x) * kTile, (r % tiles_x) * kTile};
}

// The thread's pixel a (< 4) of the tile: its index in the tile, in the
// image (-1 when outside it) and in the halo (at tap (0, 0)).
struct Pixels {
  int global[4];
  int halo[4];
};

__device__ __forceinline__ Pixels pixels_of(Tile t, int height, int width) {
  Pixels px;
  const int pg = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = pg + 16 * a;
    const int py = p / kTile, pxx = p % kTile;
    const int y = t.y0 + py, x = t.x0 + pxx;
    px.global[a] = (y < height && x < width)
                       ? (t.b * height + y) * width + x
                       : -1;
    px.halo[a] = py * kHalo + pxx;
  }
  return px;
}

// s[j] = the Dropout2d scale of channel j of batch row b.
__device__ void drop_scales(const int* seed_ptr, int b, int c2,
                            uint32_t threshold, float keep_scale, float* s) {
  const uint32_t seed = seed_ptr ? static_cast<uint32_t>(*seed_ptr) : 0u;
  for (int j = threadIdx.x; j < c2; j += kThreads) {
    float v = 1.f;
    if (seed_ptr) {
      const uint4 r = gpnf::gated_conv_dropout_bits(seed, b, j >> 2);
      v = gpnf::philox_word(r, j & 3) >= threshold ? keep_scale : 0.f;
    }
    s[j] = v;
  }
}

// h1_s (kHaloPix, 2C) = concat_elu(x) over the tile and its halo, zero
// outside the image (the SAME padding of the conv's input).
template <int C>
__device__ void load_h1_halo(const float* __restrict__ x, Tile t, int height,
                             int width, float* h1_s) {
  constexpr int C2 = 2 * C;
  for (int e = threadIdx.x; e < kHaloPix * C; e += kThreads) {
    const int hp = e / C, c = e - hp * C;
    const int y = t.y0 + hp / kHalo - 1, xx = t.x0 + hp % kHalo - 1;
    const bool in = y >= 0 && y < height && xx >= 0 && xx < width;
    const float v =
        in ? x[(static_cast<size_t>(t.b * height + y) * width + xx) * C + c]
           : 0.f;
    h1_s[hp * C2 + c] = in ? elu(v) : 0.f;
    h1_s[hp * C2 + C + c] = in ? elu(-v) : 0.f;
  }
}

// acc[a][j] += sum over taps (ky, kx) and input channels i of
// h1_s[halo of pixel a + (ky, kx)][i] * w1[ky][kx][i][og + 16 j].
// w_s holds 9 * kKc * C floats. Ends with the last chunk read (no barrier).
template <int C>
__device__ void conv3x3_tile(const float* h1_s, const float* __restrict__ w1,
                             float* w_s, const Pixels& px,
                             float (&acc)[4][Shape<C>::OPT]) {
  using S = Shape<C>;
  constexpr int C2 = S::C2;
  const int og = threadIdx.x % 16;
  for (int i0 = 0; i0 < C2; i0 += kKc) {
    __syncthreads();  // the previous chunk consumed, h1_s written
    for (int e = threadIdx.x; e < 9 * kKc * C; e += kThreads) {
      const int tap = e / (kKc * C);
      const int r = e - tap * kKc * C;  // k * C + o: contiguous in w1
      w_s[e] = w1[(static_cast<size_t>(tap) * C2 + i0) * C + r];
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * kHalo + tap % 3;
#pragma unroll 4
      for (int k = 0; k < kKc; ++k) {
        float hv[4], wv[S::OPT];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          hv[a] = h1_s[(px.halo[a] + shift) * C2 + i0 + k];
#pragma unroll
        for (int j = 0; j < S::OPT; ++j) {
          const int o = og + 16 * j;
          wv[j] = (S::kFull || o < C) ? w_s[(tap * kKc + k) * C + o] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < S::OPT; ++j)
            acc[a][j] = fmaf(hv[a], wv[j], acc[a][j]);
      }
    }
  }
}

// ga / gb[a][j] += sum over i of in_s[pixel a][i] * wt[i][o] / wt[i][C + o],
// o = og + 16 j, with wt = wg (transposed = false) or wg^T (true), streamed
// through w_s (kKc * 2C floats). in_s is (kPix, 2C). Starts with a barrier,
// ends with the last chunk read.
template <int C, bool TRANSPOSED>
__device__ void gate_tile(const float* in_s, const float* __restrict__ wg,
                          float* w_s, float (&ga)[4][Shape<C>::OPT],
                          float (&gb)[4][Shape<C>::OPT]) {
  using S = Shape<C>;
  constexpr int C2 = S::C2;
  const int pg = threadIdx.x / 16, og = threadIdx.x % 16;
  for (int i0 = 0; i0 < C2; i0 += kKc) {
    __syncthreads();
    for (int e = threadIdx.x; e < kKc * C2; e += kThreads) {
      if (TRANSPOSED) {  // w_s[k][n] = wg[n][i0 + k]
        const int k = e % kKc, n = e / kKc;
        w_s[k * C2 + n] = wg[static_cast<size_t>(n) * C2 + i0 + k];
      } else {  // w_s[k][n] = wg[i0 + k][n]: contiguous
        w_s[e] = wg[static_cast<size_t>(i0) * C2 + e];
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kKc; ++k) {
      float hv[4], wa[S::OPT], wb[S::OPT];
#pragma unroll
      for (int a = 0; a < 4; ++a) hv[a] = in_s[(pg + 16 * a) * C2 + i0 + k];
#pragma unroll
      for (int j = 0; j < S::OPT; ++j) {
        const int o = og + 16 * j;
        const bool ok = S::kFull || o < C;
        wa[j] = ok ? w_s[k * C2 + o] : 0.f;
        wb[j] = ok ? w_s[k * C2 + C + o] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < S::OPT; ++j) {
          ga[a][j] = fmaf(hv[a], wa[j], ga[a][j]);
          gb[a][j] = fmaf(hv[a], wb[j], gb[a][j]);
        }
    }
  }
}

template <int C>
__device__ __forceinline__ void zero(float (&acc)[4][Shape<C>::OPT]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < Shape<C>::OPT; ++j) acc[a][j] = 0.f;
}

// The forward up to the gate: h (+ b1) in h, h2 (dropped) in h2_s over
// h1_s's place (and into h2_out when it is given), the gate's two halves
// without bg in ga / gb.
template <int C>
__device__ void forward_tile(const int* seed, const float* __restrict__ x,
                             const float* __restrict__ w1,
                             const float* __restrict__ b1,
                             const float* __restrict__ wg, Tile t, int height,
                             int width, uint32_t threshold, float keep_scale,
                             const Pixels& px, float* h1_s, float* w_s,
                             float* s_s, float* __restrict__ h2_out,
                             float (&h)[4][Shape<C>::OPT],
                             float (&ga)[4][Shape<C>::OPT],
                             float (&gb)[4][Shape<C>::OPT]) {
  using S = Shape<C>;
  constexpr int C2 = S::C2;
  const int pg = threadIdx.x / 16, og = threadIdx.x % 16;
  drop_scales(seed, t.b, C2, threshold, keep_scale, s_s);
  load_h1_halo<C>(x, t, height, width, h1_s);
  zero<C>(h);
  conv3x3_tile<C>(h1_s, w1, w_s, px, h);
  __syncthreads();  // h1_s consumed: h2 takes its place
  float* h2_s = h1_s;
#pragma unroll
  for (int j = 0; j < S::OPT; ++j) {
    const int o = og + 16 * j;
    if (!S::kFull && o >= C) continue;
    const float bias = b1[o];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      h[a][j] += bias;
      const int p = pg + 16 * a;
      const float lo = elu(h[a][j]) * s_s[o];
      const float hi = elu(-h[a][j]) * s_s[C + o];
      h2_s[p * C2 + o] = lo;
      h2_s[p * C2 + C + o] = hi;
      if (h2_out && px.global[a] >= 0) {
        h2_out[static_cast<size_t>(px.global[a]) * C2 + o] = lo;
        h2_out[static_cast<size_t>(px.global[a]) * C2 + C + o] = hi;
      }
    }
  }
  zero<C>(ga);
  zero<C>(gb);
  gate_tile<C, false>(h2_s, wg, w_s, ga, gb);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    gated_conv_fwd_kernel(const int* __restrict__ seed,
                          const float* __restrict__ x,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ wg,
                          const float* __restrict__ bg, float* __restrict__ out,
                          int height, int width, uint32_t threshold,
                          float keep_scale) {
  using S = Shape<C>;
  extern __shared__ float smem[];
  float* h1_s = smem;                      // (kHaloPix, 2C); then h2 (kPix, 2C)
  float* w_s = h1_s + kHaloPix * S::C2;    // weight chunk, 9 * kKc * C
  float* s_s = w_s + 9 * kKc * C;          // (2C) dropout scales
  const Tile t = tile_of(blockIdx.x, height, width);
  const Pixels px = pixels_of(t, height, width);
  float h[4][S::OPT], ga[4][S::OPT], gb[4][S::OPT];
  forward_tile<C>(seed, x, w1, b1, wg, t, height, width, threshold,
                  keep_scale, px, h1_s, w_s, s_s, nullptr, h, ga, gb);
  const int og = threadIdx.x % 16;
#pragma unroll
  for (int j = 0; j < S::OPT; ++j) {
    const int o = og + 16 * j;
    if (!S::kFull && o >= C) continue;
    const float ba = bg[o], bb = bg[C + o];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (px.global[a] < 0) continue;
      const size_t i = static_cast<size_t>(px.global[a]) * C + o;
      out[i] = (ga[a][j] + ba) * sigmoid(gb[a][j] + bb) + x[i];
    }
  }
}

// Backward, kernel 1: the forward again, then dG2, dh2 = dG2 @ wg^T and dh.
// Writes dh (B, H, W, C), dG2 and h2 (B, H, W, 2C).
template <int C>
__global__ void __launch_bounds__(kThreads)
    gated_conv_bwd_tile_kernel(const int* __restrict__ seed,
                               const float* __restrict__ x,
                               const float* __restrict__ w1,
                               const float* __restrict__ b1,
                               const float* __restrict__ wg,
                               const float* __restrict__ bg,
                               const float* __restrict__ gout,
                               float* __restrict__ dh_out,
                               float* __restrict__ dg_out,
                               float* __restrict__ h2_out, int height,
                               int width, uint32_t threshold,
                               float keep_scale) {
  using S = Shape<C>;
  constexpr int C2 = S::C2;
  extern __shared__ float smem[];
  float* h1_s = smem;
  float* w_s = h1_s + kHaloPix * C2;
  float* s_s = w_s + 9 * kKc * C;
  float* dg_s = s_s + C2;                  // (kPix, 2C)
  const Tile t = tile_of(blockIdx.x, height, width);
  const Pixels px = pixels_of(t, height, width);
  float h[4][S::OPT], ga[4][S::OPT], gb[4][S::OPT];
  forward_tile<C>(seed, x, w1, b1, wg, t, height, width, threshold,
                  keep_scale, px, h1_s, w_s, s_s, h2_out, h, ga, gb);
  const int pg = threadIdx.x / 16, og = threadIdx.x % 16;
#pragma unroll
  for (int j = 0; j < S::OPT; ++j) {
    const int o = og + 16 * j;
    if (!S::kFull && o >= C) continue;
    const float ba = bg[o], bb = bg[C + o];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int p = pg + 16 * a;
      const float av = ga[a][j] + ba;
      const float sig = sigmoid(gb[a][j] + bb);
      const float go =
          px.global[a] >= 0 ? gout[static_cast<size_t>(px.global[a]) * C + o]
                            : 0.f;
      const float da = go * sig;
      const float db = go * av * sig * (1.f - sig);
      dg_s[p * C2 + o] = da;
      dg_s[p * C2 + C + o] = db;
      if (px.global[a] >= 0) {
        dg_out[static_cast<size_t>(px.global[a]) * C2 + o] = da;
        dg_out[static_cast<size_t>(px.global[a]) * C2 + C + o] = db;
      }
    }
  }
  // dh2 = dG2 @ wg^T: the same loop with the gate's transpose
  zero<C>(ga);
  zero<C>(gb);
  gate_tile<C, true>(dg_s, wg, w_s, ga, gb);
#pragma unroll
  for (int j = 0; j < S::OPT; ++j) {
    const int o = og + 16 * j;
    if (!S::kFull && o >= C) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (px.global[a] < 0) continue;
      dh_out[static_cast<size_t>(px.global[a]) * C + o] =
          ga[a][j] * s_s[o] * delu(h[a][j]) -
          gb[a][j] * s_s[C + o] * delu(-h[a][j]);
    }
  }
}

// Backward, kernel 2: dh1 = the transposed 3x3 conv of dh (read with its
// halo), then dx = dh1[:C] elu'(x) - dh1[C:] elu'(-x) + G.
template <int C>
__global__ void __launch_bounds__(kThreads)
    gated_conv_bwd_dx_kernel(const float* __restrict__ x,
                             const float* __restrict__ w1,
                             const float* __restrict__ gout,
                             const float* __restrict__ dh,
                             float* __restrict__ dx, int height, int width) {
  using S = Shape<C>;
  constexpr int C2 = S::C2;
  extern __shared__ float smem[];
  float* dh_s = smem;                  // (kHaloPix, C)
  float* w_s = dh_s + kHaloPix * C;    // (9, kKc, 2C): w1[tap][i][o0 + k]
  const Tile t = tile_of(blockIdx.x, height, width);
  const Pixels px = pixels_of(t, height, width);
  for (int e = threadIdx.x; e < kHaloPix * C; e += kThreads) {
    const int hp = e / C, c = e - hp * C;
    const int y = t.y0 + hp / kHalo - 1, xx = t.x0 + hp % kHalo - 1;
    const bool in = y >= 0 && y < height && xx >= 0 && xx < width;
    dh_s[e] = in ? dh[(static_cast<size_t>(t.b * height + y) * width + xx) *
                          C + c]
                 : 0.f;
  }
  const int og = threadIdx.x % 16;
  float da[4][S::OPT], db[4][S::OPT];
  zero<C>(da);
  zero<C>(db);
  for (int o0 = 0; o0 < C; o0 += kKc) {
    __syncthreads();
    for (int e = threadIdx.x; e < 9 * kKc * C2; e += kThreads) {
      const int k = e % kKc;
      const int ti = e / kKc;  // tap * 2C + i
      const int tap = ti / C2, i = ti - tap * C2;
      w_s[(tap * kKc + k) * C2 + i] = w1[static_cast<size_t>(ti) * C + o0 + k];
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      // dh1[q] += dh[q - (ky - 1, kx - 1)] w1[ky][kx]^T
      const int shift = (2 - tap / 3) * kHalo + (2 - tap % 3);
#pragma unroll 4
      for (int k = 0; k < kKc; ++k) {
        float dv[4], wa[S::OPT], wb[S::OPT];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          dv[a] = dh_s[(px.halo[a] + shift) * C + o0 + k];
#pragma unroll
        for (int j = 0; j < S::OPT; ++j) {
          const int c = og + 16 * j;
          const bool ok = S::kFull || c < C;
          wa[j] = ok ? w_s[(tap * kKc + k) * C2 + c] : 0.f;
          wb[j] = ok ? w_s[(tap * kKc + k) * C2 + C + c] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < S::OPT; ++j) {
            da[a][j] = fmaf(dv[a], wa[j], da[a][j]);
            db[a][j] = fmaf(dv[a], wb[j], db[a][j]);
          }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < S::OPT; ++j) {
    const int c = og + 16 * j;
    if (!S::kFull && c >= C) continue;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (px.global[a] < 0) continue;
      const size_t i = static_cast<size_t>(px.global[a]) * C + c;
      const float xv = x[i];
      dx[i] = da[a][j] * delu(xv) - db[a][j] * delu(-xv) + gout[i];
    }
  }
}

// partial[z] (m_size, n_size) = sum over the pixels k of chunk z of
// A(k, m) * B(k, n), B = b_src (pixels, n_size). Rows m < m_size - 1:
// IM2COL, A(k, tap * 2C + i) = concat_elu(x)[k's neighbour at tap][i] (zero
// outside the image), with x = a_src (B, H, W, C); else A = a_src (pixels,
// m_size - 1). Row m_size - 1 is all ones: the bias gradient. A plain fp32
// GEMM: 64 x 64 output tile, 16 pixels deep, 256 threads of 4 x 4 outputs.
constexpr int kBM = 64, kBN = 64, kBK = 16;

template <bool IM2COL>
__global__ void __launch_bounds__(256)
    wgrad_kernel(const float* __restrict__ a_src,
                 const float* __restrict__ b_src, float* __restrict__ partial,
                 int m_size, int n_size, int pixels, int height, int width,
                 int channels, int k_chunk) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN + 4];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(pixels, kbeg + k_chunk);
  const int rows = m_size - 1;
  const int c2 = 2 * channels;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += blockDim.x) {
      const int mm = e % kBM, kk = e / kBM;  // lanes along m: unit stride
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.f;
      if (gm < m_size && gk < kend) {
        if (gm == rows) {
          v = 1.f;
        } else if (IM2COL) {
          const int tap = gm / c2, i = gm - tap * c2;
          const int xx = gk % width, y = (gk / width) % height;
          const int b = gk / (width * height);
          const int sy = y + tap / 3 - 1, sx = xx + tap % 3 - 1;
          if (sy >= 0 && sy < height && sx >= 0 && sx < width) {
            const float xv =
                a_src[(static_cast<size_t>(b * height + sy) * width + sx) *
                          channels + (i < channels ? i : i - channels)];
            v = elu(i < channels ? xv : -xv);
          }
        } else {
          v = a_src[static_cast<size_t>(gk) * rows + gm];
        }
      }
      as[kk][mm] = v;
    }
    for (int e = threadIdx.x; e < kBN * kBK; e += blockDim.x) {
      const int nn = e % kBN, kk = e / kBN;
      const int gn = n0 + nn, gk = k0 + kk;
      bs[kk][nn] = (gn < n_size && gk < kend)
                       ? b_src[static_cast<size_t>(gk) * n_size + gn]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* cz = partial + static_cast<size_t>(blockIdx.z) * m_size * n_size;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m_size) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n_size) cz[static_cast<size_t>(gm) * n_size + gn] = acc[i][j];
    }
  }
}

// The partials' sum over z in order: rows < `rows` into w_out, the last row
// (the ones row's products) into b_out.
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ w_out,
                                       float* __restrict__ b_out, int rows,
                                       int n_size, int parts) {
  const int n = (rows + 1) * n_size;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = partial[i];
  for (int z = 1; z < parts; ++z) acc += partial[static_cast<size_t>(z) * n + i];
  if (i < rows * n_size) {
    w_out[i] = acc;
  } else {
    b_out[i - rows * n_size] = acc;
  }
}

template <typename Kernel>
cudaError_t set_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int tiles(int batch, int height, int width) {
  return batch * ((height + kTile - 1) / kTile) * ((width + kTile - 1) / kTile);
}

template <int C>
cudaError_t launch_fwd(const int* seed, const float* x, const float* w1,
                       const float* b1, const float* wg, const float* bg,
                       float* out, int batch, int height, int width,
                       uint32_t threshold, float keep_scale,
                       cudaStream_t stream) {
  const size_t bytes = Shape<C>::kFwd * sizeof(float);
  cudaError_t err = set_shared(gated_conv_fwd_kernel<C>, bytes);
  if (err != cudaSuccess) return err;
  gated_conv_fwd_kernel<C><<<tiles(batch, height, width), kThreads, bytes,
                             stream>>>(seed, x, w1, b1, wg, bg, out, height,
                                       width, threshold, keep_scale);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(bool im2col, const float* a_src, const float* b_src,
                         float* partial, float* w_out, float* b_out, int rows,
                         int n_size, int pixels, int height, int width,
                         int channels, int k_chunk, cudaStream_t stream) {
  const int parts = (pixels + k_chunk - 1) / k_chunk;
  const int m_size = rows + 1;
  dim3 grid((n_size + kBN - 1) / kBN, (m_size + kBM - 1) / kBM, parts);
  if (im2col) {
    wgrad_kernel<true><<<grid, 256, 0, stream>>>(
        a_src, b_src, partial, m_size, n_size, pixels, height, width,
        channels, k_chunk);
  } else {
    wgrad_kernel<false><<<grid, 256, 0, stream>>>(
        a_src, b_src, partial, m_size, n_size, pixels, height, width,
        channels, k_chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = m_size * n_size;
  reduce_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      partial, w_out, b_out, rows, n_size, parts);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bwd(const int* seed, const float* x, const float* w1,
                       const float* b1, const float* wg, const float* bg,
                       const float* g, float* dx, float* dw1, float* db1,
                       float* dwg, float* dbg, float* dh, float* dg, float* h2,
                       float* partial, int batch, int height, int width,
                       uint32_t threshold, float keep_scale, int k_chunk,
                       cudaStream_t stream) {
  const int grid = tiles(batch, height, width);
  size_t bytes = Shape<C>::kBwdTile * sizeof(float);
  cudaError_t err = set_shared(gated_conv_bwd_tile_kernel<C>, bytes);
  if (err != cudaSuccess) return err;
  gated_conv_bwd_tile_kernel<C><<<grid, kThreads, bytes, stream>>>(
      seed, x, w1, b1, wg, bg, g, dh, dg, h2, height, width, threshold,
      keep_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bytes = Shape<C>::kBwdDx * sizeof(float);
  err = set_shared(gated_conv_bwd_dx_kernel<C>, bytes);
  if (err != cudaSuccess) return err;
  gated_conv_bwd_dx_kernel<C><<<grid, kThreads, bytes, stream>>>(
      x, w1, g, dh, dx, height, width);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pixels = batch * height * width;
  // dwg, dbg from h2^T dG2; then dw1, db1 from im2col(concat_elu(x))^T dh,
  // reusing the partials once the first reduction has read them (one stream)
  err = launch_wgrad(false, h2, dg, partial, dwg, dbg, 2 * C, 2 * C, pixels,
                     height, width, C, k_chunk, stream);
  if (err != cudaSuccess) return err;
  return launch_wgrad(true, x, dh, partial, dw1, db1, 18 * C, C, pixels,
                      height, width, C, k_chunk, stream);
}

bool valid_shape(int batch, int height, int width) {
  return batch > 0 && height > 0 && width > 0;
}

}  // namespace

// out (B, H, W, C) from x and the weights; seed null means no dropout.
extern "C" int gpnf_gated_conv_fwd(const int* seed, const float* x,
                                   const float* w1, const float* b1,
                                   const float* wg, const float* bg,
                                   float* out, int batch, int height,
                                   int width, int channels, uint32_t threshold,
                                   float keep_scale, void* stream) {
  if (!valid_shape(batch, height, width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPNF_FWD(CH)                                                        \
  launch_fwd<CH>(seed, x, w1, b1, wg, bg, out, batch, height, width,        \
                 threshold, keep_scale, s)
  cudaError_t err;
  switch (channels) {
    case 8: err = GPNF_FWD(8); break;
    case 16: err = GPNF_FWD(16); break;
    case 96: err = GPNF_FWD(96); break;
    default: err = cudaErrorInvalidValue;
  }
#undef GPNF_FWD
  return static_cast<int>(err);
}

// dx (B, H, W, C), dw1 (3, 3, 2C, C), db1 (C), dwg (2C, 2C), dbg (2C) from
// the forward's inputs and the cotangent g. Scratch from the caller: dh
// (B, H, W, C), dg and h2 (B, H, W, 2C), partial (ceil(B*H*W / k_chunk),
// 18C + 1, C).
extern "C" int gpnf_gated_conv_bwd(const int* seed, const float* x,
                                   const float* w1, const float* b1,
                                   const float* wg, const float* bg,
                                   const float* g, float* dx, float* dw1,
                                   float* db1, float* dwg, float* dbg,
                                   float* dh, float* dg, float* h2,
                                   float* partial, int batch, int height,
                                   int width, int channels, uint32_t threshold,
                                   float keep_scale, int k_chunk,
                                   void* stream) {
  if (!valid_shape(batch, height, width) || k_chunk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPNF_BWD(CH)                                                        \
  launch_bwd<CH>(seed, x, w1, b1, wg, bg, g, dx, dw1, db1, dwg, dbg, dh,    \
                 dg, h2, partial, batch, height, width, threshold,          \
                 keep_scale, k_chunk, s)
  cudaError_t err;
  switch (channels) {
    case 8: err = GPNF_BWD(8); break;
    case 16: err = GPNF_BWD(16); break;
    case 96: err = GPNF_BWD(96); break;
    default: err = cudaErrorInvalidValue;
  }
#undef GPNF_BWD
  return static_cast<int>(err);
}
