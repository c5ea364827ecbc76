// The fused level-0 encoder chain for Hopper (sm_90a): K4 of the port.
//
// Replaces the TPU kernel tpu_unet/ops/fused_level0.py::enc0_chain
// (`_enc0_kernel`), with its numerics:
//
//   h1     = bf16(relu(conv3x3(x, w1) + b1))   x [B, H, W] (one channel), f32 sums of
//                                              f32 products, one bf16 rounding
//   h2     = relu(conv3x3(h1, w2) + b2)        bf16 x bf16 products, f32 sums, f32 h2
//   skip   = bf16(h2)                          [B, H-4, W-4, C]
//          or clamp(rint(h2 * inv_skip), 0, 127) as int8 (skip_i8), from the f32 h2
//   pooled = bf16(max of each 2x2 window of h2)  [B, (H-4)/2, (W-4)/2, C]
//
// The conv1 tile lives only in shared memory and the pool reads h2 from
// registers: of the chain's tensors only x is read and only the skip and the
// pooled map are written.
//
// What bounds it on the H100: at C = 64, conv2 does 2*9*64*64 = 73.7 kop per
// output pixel against 129 bytes written (int8 skip plus a quarter pixel of
// bf16 pool), ~570 op/byte, above the card's ~295 bf16 op/byte ridge: the
// tensor cores (conv2) bound it, conv1's 9 FMAs per value run on the f32
// units beside them. The design:
//   * one block per SM walks over 8 x 32 tiles of conv2 outputs (all C
//     channels) of every image, with conv2's weights resident in shared
//     memory for the whole walk (loaded once);
//   * per tile the (8+4) x (32+4) input patch is staged as f32, conv1 runs
//     by FMAs into a 10 x 34 x CP bf16 tile in shared memory (CP = C rounded
//     up to 16, the channels past C zero), and conv2 is an implicit GEMM on
//     mma.sync m16n8k16 bf16 -> f32, M = 256 pixels (warp w owns tile row w,
//     two m16 tiles), N = C (n8 tiles), K = 9*CP (tap-major, each k16 step
//     inside one tap), with K3's fragment layout (csrc/conv3x3_fused.cu);
//   * shared-memory rows are padded by 16 bytes so that the 32 lanes of a
//     fragment load fall on 32 banks;
//   * the epilogue adds b2 and applies ReLU on the accumulators, stores the
//     skip, pools column pairs with a lane shuffle and row pairs through
//     shared memory (odd warps hand their column maxima to the even warp
//     above), and stores the pooled map.
// Edge tiles compute on zero-filled input and store only inside the output.
// Not yet here: wgmma, TMA, a cp.async ring, coalesced (staged) stores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;                     // conv2 output rows per tile: one per warp
constexpr int TW = 32;                    // conv2 output columns per tile
constexpr int THREADS = 256;
constexpr int PH = TH + 4, PW = TW + 4;   // input patch
constexpr int H1H = TH + 2, H1W = TW + 2; // conv1 tile
constexpr int MAX_C = 64;                 // the resident weights and conv1 tile fit shared memory

struct Geom {
  int B, H, W, Ho, Wo, C, CP;
  int tiles_r, tiles_c;
  long long tiles;
  int lda;          // bytes per conv1 pixel in shared memory: 2*CP + 16
  int ldw;          // bytes per weight row (one output channel): 18*CP + 16
  float inv_skip;   // float32(1 / skip_scale) for the int8 skip
};

// Shared-memory carve, in bytes; every size is a multiple of 16.
struct Smem {
  int patch, w1, b1, b2, stage, h1, w2, total;
};

__host__ __device__ inline Smem smem_layout(int C, int CP, int lda, int ldw) {
  Smem s;
  s.patch = 0;
  s.w1 = s.patch + PH * PW * 4;
  s.b1 = s.w1 + 9 * CP * 4;
  s.b2 = s.b1 + CP * 4;
  s.stage = s.b2 + CP * 4;
  s.h1 = s.stage + (TH / 2) * (TW / 2) * CP * 4;
  s.w2 = s.h1 + H1H * H1W * lda;
  s.total = s.w2 + C * ldw;
  return s;
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TX> __device__ __forceinline__ float load_x(const TX* p);
template <> __device__ __forceinline__ float load_x<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float load_x<uint16_t>(const uint16_t* p) {
  return __uint_as_float((uint32_t)*p << 16);
}

// x [B, H, W] (f32, or bf16 bit patterns); w1 f32 [9, C] (tap-major); b1,
// b2 f32 [C]; w2t bf16 bits [C, 9, CP] (each output channel's K-contiguous
// row, zero past C); skip [B, Ho, Wo, C] int8 or bf16; pooled [B, Ho/2,
// Wo/2, C] bf16.
template <typename TX, bool SKIP_I8>
__global__ void __launch_bounds__(THREADS, 1)
enc0_chain_kernel(const TX* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ b1, const uint16_t* __restrict__ w2t,
                  const float* __restrict__ b2, void* __restrict__ skip,
                  uint16_t* __restrict__ pooled, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(g.C, g.CP, g.lda, g.ldw);
  float* patch = reinterpret_cast<float*>(smem + L.patch);
  float* w1s = reinterpret_cast<float*>(smem + L.w1);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* b2s = reinterpret_cast<float*>(smem + L.b2);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  unsigned char* h1 = smem + L.h1;
  unsigned char* w2s = smem + L.w2;

  const int C = g.C, CP = g.CP;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  const int nt = C / 8;                   // n8 tiles of output channels

  // Resident for the whole walk: w1, b1, b2 and conv2's weights.
  for (int i = threadIdx.x; i < 9 * CP; i += THREADS) {
    const int tap = i / CP, ch = i - tap * CP;
    w1s[i] = ch < C ? w1[tap * C + ch] : 0.f;
  }
  for (int i = threadIdx.x; i < CP; i += THREADS) {
    b1s[i] = i < C ? b1[i] : 0.f;
    b2s[i] = i < C ? b2[i] : 0.f;
  }
  const int row_vecs = 9 * CP * 2 / 16;   // uint4 per weight row
  for (int i = threadIdx.x; i < C * row_vecs; i += THREADS) {
    const int n = i / row_vecs, v = i - n * row_vecs;
    reinterpret_cast<uint4*>(w2s + n * g.ldw)[v] =
        reinterpret_cast<const uint4*>(w2t + (long long)n * 9 * CP)[v];
  }

  const int tiles_img = g.tiles_r * g.tiles_c;
  for (long long t = blockIdx.x; t < g.tiles; t += gridDim.x) {
    const int b = (int)(t / tiles_img);
    const int rem = (int)(t - (long long)b * tiles_img);
    const int y0 = (rem / g.tiles_c) * TH;
    const int x0 = (rem % g.tiles_c) * TW;

    __syncthreads();                      // the previous tile is done with patch, h1, stage
    for (int i = threadIdx.x; i < PH * PW; i += THREADS) {
      const int r = i / PW, c = i - r * PW;
      const int gy = y0 + r, gx = x0 + c;
      patch[i] = (gy < g.H && gx < g.W)
                     ? load_x<TX>(x + ((long long)b * g.H + gy) * g.W + gx) : 0.f;
    }
    __syncthreads();

    // conv1 + b1 + ReLU -> bf16, two channels per thread and step.
    const int half = CP / 2;
    for (int i = threadIdx.x; i < H1H * H1W * half; i += THREADS) {
      const int p = i / half;
      const int ch = (i - p * half) * 2;
      const int pr = p / H1W, pc = p - pr * H1W;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float v = patch[(pr + tap / 3) * PW + pc + tap % 3];
        a0 = fmaf(v, w1s[tap * CP + ch], a0);
        a1 = fmaf(v, w1s[tap * CP + ch + 1], a1);
      }
      a0 = __fadd_rn(a0, b1s[ch]);
      a1 = __fadd_rn(a1, b1s[ch + 1]);
      a0 = ch < C ? (a0 < 0.f ? 0.f : a0) : 0.f;
      a1 = ch + 1 < C ? (a1 < 0.f ? 0.f : a1) : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(h1 + p * g.lda + ch * 2) =
          __floats2bfloat162_rn(a0, a1);
    }
    __syncthreads();

    // conv2: warp w computes tile row w, columns [16i, 16i + 16) for i = 0, 1.
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - dy * 3;
      for (int k0 = 0; k0 < CP; k0 += 16) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const unsigned char* p =
              h1 + ((warp + dy) * H1W + i * 16 + grp + dx) * g.lda + k0 * 2 + tq * 4;
          af[i][0] = ld32(p);
          af[i][1] = ld32(p + 8 * g.lda);
          af[i][2] = ld32(p + 16);
          af[i][3] = ld32(p + 8 * g.lda + 16);
        }
        const unsigned char* q = w2s + grp * g.ldw + (tap * CP + k0) * 2 + tq * 4;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nt) {
            const uint32_t bf[2] = {ld32(q + j * 8 * g.ldw), ld32(q + j * 8 * g.ldw + 16)};
            mma_bf16(acc[0][j], af[0], bf);
            mma_bf16(acc[1][j], af[1], bf);
          }
        }
      }
    }

    // Epilogue. Accumulator r of tile (i, j): column 16i + grp + 8*(r/2) of
    // tile row `warp`, channel 8j + 2*tq + r%2.
    const int oy = y0 + warp;
    const bool row_ok = oy < g.Ho;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nt) {
          const int ch = j * 8 + tq * 2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = __fadd_rn(acc[i][j][2 * h], b2s[ch]);
            float v1 = __fadd_rn(acc[i][j][2 * h + 1], b2s[ch + 1]);
            v0 = v0 < 0.f ? 0.f : v0;     // ReLU; keeps a NaN, as jnp.maximum
            v1 = v1 < 0.f ? 0.f : v1;
            acc[i][j][2 * h] = v0;
            acc[i][j][2 * h + 1] = v1;
            const int ox = x0 + i * 16 + grp + 8 * h;
            if (row_ok && ox < g.Wo) {
              const long long o = (((long long)b * g.Ho + oy) * g.Wo + ox) * C + ch;
              if constexpr (SKIP_I8) {
                const float q0 = fminf(fmaxf(rintf(__fmul_rn(v0, g.inv_skip)), 0.f), 127.f);
                const float q1 = fminf(fmaxf(rintf(__fmul_rn(v1, g.inv_skip)), 0.f), 127.f);
                *reinterpret_cast<char2*>(static_cast<int8_t*>(skip) + o) =
                    make_char2((signed char)(int)q0, (signed char)(int)q1);
              } else {
                *reinterpret_cast<__nv_bfloat162*>(static_cast<uint16_t*>(skip) + o) =
                    __floats2bfloat162_rn(v0, v1);
              }
            }
          }
        }
      }

    // 2x2 max-pool: column pairs (grp, grp ^ 1) are lanes lane ^ 4; row pairs
    // (warps 2k, 2k + 1) meet in `stage`. Even-grp lanes own pooled column
    // 8i + grp/2 + 4h of the tile.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (j < nt) acc[i][j][r] = fmaxf(acc[i][j][r], __shfl_xor_sync(0xffffffffu, acc[i][j][r], 4));
    const bool owner = (grp & 1) == 0;
    if ((warp & 1) && owner) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (j < nt) {
              const int pc = i * 8 + grp / 2 + 4 * (r >> 1);
              stage[((warp >> 1) * (TW / 2) + pc) * CP + j * 8 + tq * 2 + (r & 1)] = acc[i][j][r];
            }
    }
    __syncthreads();
    if (!(warp & 1) && owner && row_ok) {
      const int py = oy / 2;
      const int Wp = g.Wo / 2;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (j < nt) {
              const int pc = i * 8 + grp / 2 + 4 * h;
              const int px = x0 / 2 + pc;
              if (px < Wp) {
                const int ch = j * 8 + tq * 2;
                const float* s = stage + ((warp >> 1) * (TW / 2) + pc) * CP + ch;
                const float m0 = fmaxf(acc[i][j][2 * h], s[0]);
                const float m1 = fmaxf(acc[i][j][2 * h + 1], s[1]);
                const long long o = (((long long)b * (g.Ho / 2) + py) * Wp + px) * C + ch;
                *reinterpret_cast<__nv_bfloat162*>(pooled + o) = __floats2bfloat162_rn(m0, m1);
              }
            }
    }
  }
}

template <typename TX, bool SKIP_I8>
int launch(const void* x, const void* w1, const void* b1, const void* w2t, const void* b2,
           void* skip, void* pooled, const Geom& g, int smem, cudaStream_t s) {
  auto kernel = enc0_chain_kernel<TX, SKIP_I8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long blocks = g.tiles < (long long)sms * per_sm ? g.tiles : (long long)sms * per_sm;
  kernel<<<(unsigned)blocks, THREADS, smem, s>>>(
      static_cast<const TX*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const uint16_t*>(w2t), static_cast<const float*>(b2), skip,
      static_cast<uint16_t*>(pooled), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound from Python with ctypes: launches on `stream`,
// does not synchronise, returns cudaGetLastError() (or the error of the
// launch set-up). `x_bf16` selects bf16 x (else f32), `skip_i8` the int8
// skip at `inv_skip`. All tensors contiguous; C a multiple of 8, at most 64;
// H - 4 and W - 4 even and positive.
extern "C" int enc0_chain(const void* x, const void* w1, const void* b1, const void* w2t,
                          const void* b2, void* skip, void* pooled, int batch, int H, int W,
                          int C, int x_bf16, int skip_i8, float inv_skip, void* stream) {
  if (batch < 1 || H < 6 || W < 6 || (H - 4) % 2 || (W - 4) % 2 || C < 8 || C % 8 ||
      C > MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.B = batch;
  g.H = H;
  g.W = W;
  g.Ho = H - 4;
  g.Wo = W - 4;
  g.C = C;
  g.CP = (C + 15) / 16 * 16;
  g.tiles_r = (g.Ho + TH - 1) / TH;
  g.tiles_c = (g.Wo + TW - 1) / TW;
  g.tiles = (long long)batch * g.tiles_r * g.tiles_c;
  g.lda = 2 * g.CP + 16;
  g.ldw = 18 * g.CP + 16;
  g.inv_skip = inv_skip;
  const int smem = smem_layout(C, g.CP, g.lda, g.ldw).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return skip_i8 ? launch<uint16_t, true>(x, w1, b1, w2t, b2, skip, pooled, g, smem, s)
                   : launch<uint16_t, false>(x, w1, b1, w2t, b2, skip, pooled, g, smem, s);
  return skip_i8 ? launch<float, true>(x, w1, b1, w2t, b2, skip, pooled, g, smem, s)
                 : launch<float, false>(x, w1, b1, w2t, b2, skip, pooled, g, smem, s);
}
