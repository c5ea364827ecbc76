// The level-0 encoder chain as three stage kernels for Hopper (sm_90a).
//
// Replaces the Pallas piece kernels of the two Mosaic probes, which compile
// K4's pieces one at a time at block [8, 512, 64]:
//   scripts/tpu_mosaic_probe.py::main:  k_conv1, k_pair, k_pool, k_q8, k_multi
//   scripts/tpu_mosaic_probe3.py::main: k_conv1_dot (A), k_conv2_nconcat (B),
//     k_conv2_rows3 (C), k_conv2_im2col (D), k_pool_reshape (E),
//     k_pool_scratch (F), k_chain (G), k_chain_q (H)
// What they compute comes to three functions, one entry each:
//
//   enc0_conv1_stage      h1 = bf16(relu(sum_t x_t * w9[t] + b))   f32 sums of f32
//                         products, taps t = 3*dy + dx in that order (fmaf), one
//                         bf16 rounding; x_t is the shifted image (k_conv1) or
//                         tap t of a 9-tap slab (A)
//   enc0_conv2_stage      y = conv3x3(h, w) valid, bf16 x bf16 products, f32 sums;
//                         stored as f32 (B, C, D) or as bf16(relu(y)) (k_pair)
//   enc0_pool_quant_stage one pass over h (f32 or bf16) writing any of: the skip
//                         as bf16(h) (k_multi, G), the skip as int8
//                         clamp(rint(h * s), 0, 127) (k_q8, H), and the 2x2/2
//                         max-pool as bf16 (k_pool, E, F, G and H's pooled map)
//
// What bounds them on the H100 at K4's serving chunk (x [16, 572, 572, 1],
// C = 64): conv1 does 9 FMAs per output value against 2 bytes written, and
// the pool/quantize pass no arithmetic to speak of, so both are bound by
// bytes. conv2 does 2 * 9 * 64 = 1152 operations per output value against
// 2 bytes read and 4 (f32) or 2 (bf16) written: 0.385 ms of bf16 tensor-core
// work against 0.59 ms (f32 out) or 0.40 ms (bf16 out) of traffic, so bytes
// bound it too, barely. The designs:
//   * conv1: the conv1 producer of enc0_conv1.cuh, which K4's sm90 route
//     runs too: a thread owns one group of 8 output channels and a run of
//     16 adjacent pixels of one output row (9-tap slab: of the flat pixel
//     order), loads its 72 weights and 8 biases once into registers, reads
//     the run's three input rows once (18 values each) and stores one
//     16-byte chunk per pixel; adjacent lanes take adjacent channel groups,
//     so 8 lanes (C = 64) store one whole 128-byte pixel row;
//   * conv2: the strip loop of conv3x3_sm90.cuh (K1's bf16 route takes it
//     at enc0_conv2 and dec0_conv2) with the f32 or ReLU -> bf16 epilogue:
//     persistent blocks, the 9 x 64 x 64 weights resident in shared
//     memory, a tile of 2 output rows x 88 columns whose input strip (4
//     rows x 90 pixels x 64 channels, channels past Cin zero-filled) is
//     copied once, a ring of 3 strips with 2 in flight under the current
//     tile's 72 wgmma m64n88k16 (channels x pixels: fewer shared-memory
//     operand bytes per flop than m64n64), and 16-byte stores through a
//     transposed staging tile. So each input row is read twice (the second
//     time mostly from L2, by the tile below) instead of 9 times, and the
//     output written once. Its MMA step (`strip_mma`) is the one K4's sm90
//     route issues, so the staged chain's f32 sums equal K4's;
//   * pool/quantize: a thread owns 8 channels of one 2x2 window: it reads
//     the window once (16- or 32-byte loads) and writes the four skip values
//     and the pooled value.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "conv3x3_sm90.cuh"
#include "enc0_conv1.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C2 = 64;                // conv2: the strip loop's resident weights

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

using enc0::pack_bf16x2;

// ---- conv1 -----------------------------------------------------------------
// The conv1 producer of enc0_conv1.cuh, one run of RUN1 pixels (of two
// output rows, from a 2D image) per thread, two blocks per SM (16 warps:
// more warps in flight than registers for one block allow).
// w9 f32 [9, C], b f32 [C] (16-byte aligned); out bf16 bits. C % 8 == 0.
constexpr int RUN1 = 16;

// x [B, H, W] (f32 or bf16 bits) -> out [B, Ho, Wo, C]: thread t takes
// channel group t % (C/8) of run (t / (C/8)) % runs of output rows 2 q and
// 2 q + 1 (q = t / (C/8 * runs), counted over the images' row pairs), runs
// = ceil(Wo / RUN1); a row's last run is cut at Wo, an odd Ho's last pair
// at its first row.
template <typename TX>
__global__ void __launch_bounds__(THREADS, 2)
conv1_image_kernel(const TX* __restrict__ x, const float* __restrict__ w9,
                   const float* __restrict__ b, uint16_t* __restrict__ out, int H, int W,
                   int Ho, int Wo, int C, int runs, long long items) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= items) return;
  const int groups = C / 8, pairs = (Ho + 1) / 2;
  const long long r = t / groups;
  const int c0 = (int)(t - r * groups) * 8;
  const long long q = r / runs;                // b * pairs + oy / 2
  const int ox0 = (int)(r - q * runs) * RUN1;
  const long long bi = q / pairs;
  const int oy = (int)(q - bi * pairs) * 2;
  enc0::Conv1Group g;
  enc0::load_group(g, w9, b, C, c0);
  uint16_t* o = out + ((bi * Ho + oy) * Wo + ox0) * C + c0;
  const int inside = Wo - ox0, rows = Ho - oy;   // pixels of the run, output rows of the pair
  const TX* xr = x + (bi * H + oy) * W + ox0;
  const int xrows = rows < 2 ? 3 : 4, cols = W - ox0;
  enc0::conv1_rows<RUN1, 2>(
      g,
      [&](int r, int j) { return r < xrows && j < cols ? enc0::load_x<TX>(xr + r * W + j) : 0.f; },
      [&](int rr, int i, uint4 v) {
        if (i < inside && rr < rows)
          *reinterpret_cast<uint4*>(o + ((long long)rr * Wo + i) * C) = v;
      });
}

// x [P, 9] f32 (the 9-tap slab, P = B*R*Q pixels) -> out [P, C]: thread t
// takes channel group t % (C/8) of pixels RUN1 (t / (C/8)) .. + RUN1 - 1 of
// the flat pixel order, across row and image ends.
__global__ void __launch_bounds__(THREADS)
conv1_taps_kernel(const float* __restrict__ x, const float* __restrict__ w9,
                  const float* __restrict__ b, uint16_t* __restrict__ out, int C,
                  long long pixels, long long items) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= items) return;
  const int groups = C / 8;
  const long long r = t / groups;
  const int c0 = (int)(t - r * groups) * 8;
  enc0::Conv1Group g;
  enc0::load_group(g, w9, b, C, c0);
#pragma unroll 4
  for (int i = 0; i < RUN1; ++i) {
    const long long px = r * RUN1 + i;
    if (px >= pixels) break;
    float xw[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) xw[tap] = __ldg(x + px * 9 + tap);
    *reinterpret_cast<uint4*>(out + px * C + c0) = enc0::conv1_chunk(g, xw);
  }
}

// ---- pool / quantize -------------------------------------------------------
// h [B, H, W, C] (f32 or bf16 bits), H and W even, C % 8 == 0. SKIP 0: no
// skip; 1: bf16(h); 2: int8 clamp(rint(h * s), 0, 127). pooled [B, H/2,
// W/2, C] bf16 bits when `pool`.
template <typename TH_, int SKIP>
__global__ void __launch_bounds__(THREADS)
pool_quant_kernel(const TH_* __restrict__ h, void* __restrict__ skip,
                  uint16_t* __restrict__ pooled, int H, int W, int C, float s, int pool,
                  long long items) {
  const int groups = C / 8;
  const int Hp = H / 2, Wp = W / 2;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < items;
       t += (long long)gridDim.x * THREADS) {
    const long long pp = t / groups;      // pooled pixel
    const int c0 = (int)(t - pp * groups) * 8;
    const long long hw = (long long)Hp * Wp;
    const long long bi = pp / hw;
    const int rem = (int)(pp - bi * hw);
    const int py = rem / Wp, px = rem - (rem / Wp) * Wp;
    float m[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = -INFINITY;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const long long o = ((bi * H + 2 * py + (d >> 1)) * W + 2 * px + (d & 1)) * C + c0;
      float v[8];
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (sizeof(TH_) == 4) {
        const float4 a = *reinterpret_cast<const float4*>(h + o);
        const float4 bq = *reinterpret_cast<const float4*>(h + o + 4);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
        v[4] = bq.x; v[5] = bq.y; v[6] = bq.z; v[7] = bq.w;
      } else {
        raw = *reinterpret_cast<const uint4*>(h + o);
        const uint32_t w4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[2 * k] = bf16_bits_to_float(w4[k] & 0xffffu);
          v[2 * k + 1] = bf16_bits_to_float(w4[k] >> 16);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) m[k] = fmaxf(m[k], v[k]);
      if constexpr (SKIP == 1) {
        uint4 q = raw;
        if constexpr (sizeof(TH_) == 4) {
          q.x = pack_bf16x2(v[0], v[1]);
          q.y = pack_bf16x2(v[2], v[3]);
          q.z = pack_bf16x2(v[4], v[5]);
          q.w = pack_bf16x2(v[6], v[7]);
        }
        *reinterpret_cast<uint4*>(static_cast<uint16_t*>(skip) + o) = q;
      } else if constexpr (SKIP == 2) {
        uint32_t q[2] = {0u, 0u};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float r = fminf(fmaxf(rintf(__fmul_rn(v[k], s)), 0.f), 127.f);
          q[k >> 2] |= (uint32_t)(uint8_t)(int8_t)(int)r << (8 * (k & 3));
        }
        *reinterpret_cast<uint2*>(static_cast<int8_t*>(skip) + o) = make_uint2(q[0], q[1]);
      }
    }
    if (pool) {
      uint4 o4;
      o4.x = pack_bf16x2(m[0], m[1]);
      o4.y = pack_bf16x2(m[2], m[3]);
      o4.z = pack_bf16x2(m[4], m[5]);
      o4.w = pack_bf16x2(m[6], m[7]);
      *reinterpret_cast<uint4*>(pooled + ((bi * Hp + py) * Wp + px) * C + c0) = o4;
    }
  }
}

int grid_for(long long items, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  const long long need = (items + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * 16;   // a grid-stride loop past 16 blocks per SM
  *blocks = (int)(need < cap ? need : cap);
  return 0;
}

}  // namespace

// Plain C interface, bound from Python with ctypes: each entry launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (or the
// error of the launch set-up, or cudaErrorInvalidValue for arguments it
// does not take). Every tensor is contiguous and 16-byte aligned.

// taps 0: x [B, H, W] (x_bf16: bf16, else f32) -> out [B, H-2, W-2, C];
// taps 1: x [B, H, W, 9] f32 -> out [B, H, W, C]. w9 f32 [9, C], b f32 [C],
// out bf16. C % 8 == 0.
extern "C" int enc0_conv1_stage(const void* x, const void* w9, const void* b, void* out,
                                int batch, int H, int W, int C, int x_bf16, int taps,
                                void* stream) {
  if (batch < 1 || C < 8 || C % 8 || (taps && x_bf16) || (taps ? (H < 1 || W < 1)
                                                               : (H < 3 || W < 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = C / 8;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w9);
  const float* bp = static_cast<const float*>(b);
  uint16_t* op = static_cast<uint16_t*>(out);
  long long items;
  if (taps) {
    const long long pixels = (long long)batch * H * W;
    items = (pixels + RUN1 - 1) / RUN1 * groups;
    const long long blocks = (items + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    conv1_taps_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(static_cast<const float*>(x), wp, bp,
                                                           op, C, pixels, items);
  } else {
    const int Ho = H - 2, Wo = W - 2, runs = (Wo + RUN1 - 1) / RUN1;
    items = (long long)batch * ((Ho + 1) / 2) * runs * groups;
    const long long blocks = (items + THREADS - 1) / THREADS;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    if (x_bf16)
      conv1_image_kernel<uint16_t><<<(unsigned)blocks, THREADS, 0, s>>>(
          static_cast<const uint16_t*>(x), wp, bp, op, H, W, Ho, Wo, C, runs, items);
    else
      conv1_image_kernel<float><<<(unsigned)blocks, THREADS, 0, s>>>(
          static_cast<const float*>(x), wp, bp, op, H, W, Ho, Wo, C, runs, items);
  }
  return static_cast<int>(cudaGetLastError());
}

// h [B, H, W, Cin] bf16, w [Cout, 9, Cin] bf16 (K-major) -> out [B, H-2,
// W-2, Cout], f32 or (relu_bf16) bf16(relu(.)). Cin and Cout multiples of
// 8, at most 64; h, w, out 16-byte aligned. The strip loop's grid is one
// persistent block per SM of the card's `sms`.
extern "C" int enc0_conv2_stage(const void* h, const void* w, void* out, int batch, int H,
                                int W, int Cin, int Cout, int relu_bf16, int sms,
                                void* stream) {
  if (batch < 1 || H < 3 || W < 3 || Cin > MAX_C2 || Cout > MAX_C2)
    return static_cast<int>(cudaErrorInvalidValue);
  const sm90::Conv p = sm90::make_conv(h, w, nullptr, out, batch, H, W, Cin, Cout, 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return relu_bf16 ? sm90::launch_strip<sm90::RELU_BF16>(p, sms, s)
                   : sm90::launch_strip<sm90::F32>(p, sms, s);
}

// h [B, H, W, C] (h_bf16: bf16, else f32), H and W even, C % 8 == 0.
// skip_mode 0: none; 1: skip bf16 [B, H, W, C]; 2: skip int8 clamp(rint(h *
// s), 0, 127). pool 1: pooled bf16 [B, H/2, W/2, C]. At least one output.
extern "C" int enc0_pool_quant_stage(const void* h, void* skip, void* pooled, int batch, int H,
                                     int W, int C, int h_bf16, int skip_mode, float s,
                                     int pool, void* stream) {
  if (batch < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C < 8 || C % 8 || skip_mode < 0 ||
      skip_mode > 2 || (skip_mode == 0 && !pool))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items = (long long)batch * (H / 2) * (W / 2) * (C / 8);
  int blocks = 0;
  if (int rc = grid_for(items, &blocks)) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint16_t* pp = static_cast<uint16_t*>(pooled);
#define POOL_LAUNCH(T, MODE)                                                          \
  pool_quant_kernel<T, MODE><<<blocks, THREADS, 0, st>>>(static_cast<const T*>(h), skip, \
                                                         pp, H, W, C, s, pool, items)
  if (h_bf16) {
    if (skip_mode == 0) POOL_LAUNCH(uint16_t, 0);
    else if (skip_mode == 1) POOL_LAUNCH(uint16_t, 1);
    else POOL_LAUNCH(uint16_t, 2);
  } else {
    if (skip_mode == 0) POOL_LAUNCH(float, 0);
    else if (skip_mode == 1) POOL_LAUNCH(float, 1);
    else POOL_LAUNCH(float, 2);
  }
#undef POOL_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
