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
// h1 lives only in shared memory and h2 only in registers and shared memory:
// of the chain's tensors only x is read and only the skip and the pooled map
// are written.
//
// What bounds it on the H100: at C = 64, conv2 does 2*9*64*64 = 73.7 kop per
// output pixel against 129 bytes written (int8 skip plus a quarter pixel of
// bf16 pool), ~570 op/byte, above the card's ~295 bf16 op/byte ridge: the
// tensor cores (conv2) bound it, conv1's 9 FMAs per value run on the f32
// units beside them.
//
// Two routes (ops/fused_level0.py: `enc0_chain_route` gives "sm90" for every
// shape the kernels take; `_enc0_chain_route_forward` forces one):
//
// "sm90", `enc0_chain_sm90_kernel`: the strip loop's MMA step fed by a
// conv1 producer in place of its copies, warp-specialised.
//   * Persistent blocks, one per SM, each walks a contiguous range of tiles
//     of 2 output rows x 88 columns, row pairs fastest, then column tiles,
//     then images (ops/fused_level0.py::enc0_plan, enc0_tile; the entry
//     checks the plan it is given). oy is even and 88 is even, so a tile
//     holds whole 2x2 pool windows and the two wgmma warpgroups hold one
//     pool row pair. conv2's weights (9 x 64 x 64 bf16) stay in shared
//     memory in the 128-byte swizzle for the walk.
//   * A tile reads h1 rows oy .. oy+3 x 90 pixels x 64 channels from a
//     ring of 8 h1 rows in shared memory (pixel px of a row at px * 128
//     bytes, 16-byte chunk j at (j ^ (px & 7)) << 4). Vertical neighbours
//     share 2 rows, so a tile adds 2 new rows, 4 where it starts a column:
//     conv1 runs ~1.1 times per h1 value, not 2.
//   * Warpgroups 2 and 3 (the producer) compute the new rows with the conv1
//     producer of enc0_conv1.cuh: thread (group, run) computes 8 channels
//     of 3 pixels of 2 (or 4) rows at once, from an x patch (rows oy ..
//     oy+5, f32) staged in shared memory a tile ahead, so that its loads
//     run under the FMAs before. Pixels past the image and channels past C
//     are zero, as the strip loop's zero-filled copies are.
//     fence.proxy.async and a named barrier hand the rows to wgmma. The
//     producer also writes each tile's staged outputs to global memory, one
//     tile behind.
//   * Warpgroups 0 and 1 run conv2 as the strip loop's MMA step
//     (`strip_mma`, 36 wgmma m64n88k16 each, channels x pixels), so the f32
//     sums equal the conv2 stage's bit for bit; then b2, ReLU, the int8 or
//     bf16 skip and the column max of each pool window (in registers) go to
//     a staging buffer.
//   * The row max of each pool window is taken as the pooled map is
//     stored: each warpgroup stages its column maxima (bf16, which commutes
//     with max), and a pooled 16-byte chunk is the max of the two.
//   * Skip and pooled map go out in 16-byte stores (8 bytes for an int8
//     skip whose C is not a multiple of 16), contiguous along each row.
//   * setmaxnreg gives the producer 152 registers a thread (80 hold its
//     weights) and the wgmma warpgroups 104 (44 accumulators).
// What it leaves on the table (PERF.md): the output staging overlaps no
// MMA (double accumulators would need ~88 more registers a thread), and
// conv1's FMAs are bound per warp.
//
// "simple", `enc0_chain_kernel`, the route's first design: one block per
// SM walks over 8 x 32 tiles with conv2's weights resident; per tile the
// (8+4) x (32+4) input patch is staged as f32, conv1 runs by FMAs into a 10
// x 34 x CP bf16 tile in shared memory (CP = C rounded up to 16, the
// channels past C zero), and conv2 is an implicit GEMM on mma.sync
// m16n8k16 bf16 -> f32, M = 256 pixels (warp w owns tile row w, two m16
// tiles), N = C (n8 tiles), K = 9*CP (tap-major, each k16 step inside one
// tap), with K3's fragment layout; shared-memory rows are padded by 16
// bytes so that the 32 lanes of a fragment load fall on 32 banks; the
// epilogue adds b2 and applies ReLU on the accumulators, stores the skip,
// pools column pairs with a lane shuffle and row pairs through shared
// memory, and stores the pooled map. Nothing overlaps: the tensor cores
// idle through the patch load, conv1 and the stores. Kept only so that a
// comparison can time the two routes in turns.
// Edge tiles of both compute on zero-filled input and store only inside
// the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "conv3x3_sm90.cuh"
#include "enc0_conv1.cuh"

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

// ---- the sm90 route ----------------------------------------------------------

constexpr int SM90_THREADS = 4 * 128;      // warpgroups 0, 1: conv2 (wgmma); 2, 3: conv1, stores
constexpr int CONSUMERS = 2 * 128;
constexpr int PRODUCERS = SM90_THREADS - CONSUMERS;
// Registers per thread after setmaxnreg: the conv1 warpgroups hold 80
// weights and up to 32 running sums, the wgmma warpgroups 44 accumulators.
constexpr int CONSUMER_REGS = 104, PRODUCER_REGS = 152;
static_assert(CONSUMERS * CONSUMER_REGS + PRODUCERS * PRODUCER_REGS == 65536, "the SM's registers");
constexpr int STW = sm90::STRIP_TW;        // a tile's output columns
constexpr int RUN = 3;      // h1 pixels of one conv1 run; 32 runs fill a 96-pixel h1 row
static_assert(32 * RUN * 128 == sm90::STRIP_ROW, "the runs fill an h1 row");
constexpr int RING = 8;     // h1 rows: a tile's 4 and the next tile's new ones (2, or 4)
constexpr int XCOLS = 32 * RUN + 2;        // x columns of a tile
constexpr int PATCH = 6 * XCOLS;           // a tile's x patch: 6 rows x 98 columns, f32
constexpr int PTW = STW / 2;               // pooled columns of a tile
constexpr int LDP = 64 * 2 + 16;           // staged pooled pixel row, padded
// staged skip pixel row, padded
__host__ __device__ constexpr int stage_lds(bool skip_i8) { return 64 * (skip_i8 ? 1 : 2) + 16; }
constexpr int STAGE_BYTES = 2 * STW * stage_lds(false) + 2 * PTW * LDP;
// Shared memory: conv2's weights, the ring of h1 rows, the staged outputs
// of one tile, two x patch slots.
constexpr int SM90_RING = sm90::STRIP_B;
constexpr int SM90_STAGE = SM90_RING + RING * sm90::STRIP_ROW;
constexpr int SM90_PATCH = SM90_STAGE + STAGE_BYTES;
constexpr int SM90_SMEM = SM90_PATCH + 2 * PATCH * 4 + sm90::SMEM_ALIGN;
static_assert(SM90_SMEM <= sm90::SMEM_MAX, "the weights, the ring and the staging fit the card");
// Named barriers (0 is __syncthreads), a pair of each for alternate tiles
// (k % 2): FULL (tile k's new h1 rows are computed: conv1 arrives, conv2
// waits), DONE (both conv2 warpgroups have read tile k's rows: conv2
// arrives, conv1 waits before it overwrites them), STAGED (tile k's outputs
// are staged: conv2 arrives, the stores wait), FREE (they are stored: conv1
// arrives, the next staging waits); and STEP among the conv1 warpgroups (a
// step's x patch is staged and read).
constexpr int BAR_FULL = 1, BAR_DONE = 3, BAR_STAGED = 5, BAR_FREE = 7, BAR_STEP = 9;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// Publishes this thread's shared-memory writes to the threads that sync on `id`.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

struct Chain {
  const void* x;                 // [B, H, W], f32 or bf16
  const float* w1;               // [9, C], tap-major
  const float* b1;               // [C]
  const __nv_bfloat16* w2;       // [C, 9, C], K-major: each output channel's row
  const float* b2;               // [C]
  void* skip;                    // [B, Ho, Wo, C], int8 or bf16
  uint16_t* pooled;              // [B, Ho/2, Wo/2, C] bf16
  int H, W, Ho, Wo, C;
  float inv_skip;
  long long tiles;               // enc0_plan: B * tiles_img
  int tiles_c, tiles_img;        // ceil(Wo / 88), Ho / 2 * tiles_c
};

// Tile t of the walk: image b, column tile c (output columns 88 c .. 88 c +
// 87), row pair r (output rows 2 r, 2 r + 1). Row pairs run fastest, then
// column tiles, then images, so the tiles of a block's contiguous range are
// mostly vertical neighbours (ops/fused_level0.py::enc0_tile is the same
// arithmetic). A cursor steps through them without dividing.
struct Walk {
  long long b;
  int c, r;
  __device__ __forceinline__ int oy() const { return 2 * r; }
  __device__ __forceinline__ int ox0() const { return c * STW; }
};

__device__ __forceinline__ Walk walk_at(const Chain& p, long long t) {
  Walk w;
  w.b = t / p.tiles_img;
  const int rem = (int)(t - w.b * p.tiles_img), pairs = p.Ho / 2;
  w.c = rem / pairs;
  w.r = rem - w.c * pairs;
  return w;
}

__device__ __forceinline__ void walk_next(const Chain& p, Walk& w) {
  if (++w.r == p.Ho / 2) {
    w.r = 0;
    if (++w.c == p.tiles_c) {
      w.c = 0;
      ++w.b;
    }
  }
}

// The max of two pairs of bf16 values (exact: the max of bf16 values is one).
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  const float lo = fmaxf(__uint_as_float(a << 16), __uint_as_float(b << 16));
  const float hi = fmaxf(__uint_as_float(a & 0xffff0000u), __uint_as_float(b & 0xffff0000u));
  return enc0::pack_bf16x2(lo, hi);
}

template <typename TX, bool SKIP_I8>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    enc0_chain_sm90_kernel(const Chain p) {
  constexpr int SB = SKIP_I8 ? 1 : 2;          // bytes per skip value
  constexpr int LDS = stage_lds(SKIP_I8);      // staged skip pixel row
  constexpr int POOL = 2 * STW * LDS;          // then each conv2 warpgroup's column maxima
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t pad = (sm90::SMEM_ALIGN - (raw & (sm90::SMEM_ALIGN - 1))) & (sm90::SMEM_ALIGN - 1);
  unsigned char* smem = smem_raw + pad;
  const uint32_t sb = raw + pad;               // the weights, tap t at t * 8 KB
  unsigned char* stage = smem + SM90_STAGE;
  const int tid = threadIdx.x;
  // h1 row v of the block's walk (v counts the rows computed) in the ring
  auto ring_row = [](long long v) { return SM90_RING + (int)(v % RING) * sm90::STRIP_ROW; };
  // this block's tiles: lo + k, k < n (the grid is at most the tile count,
  // so n >= 1; ops/fused_level0.py::enc0_block_tiles). Tile k reads h1 rows
  // base(k) .. base(k) + 3 of the walk: a tile that starts a column (row
  // pair 0, or the block's first tile) takes 4 new rows, the others reuse
  // the 2 below and add 2.
  const long long lo = blockIdx.x * p.tiles / gridDim.x;
  const long long n = (blockIdx.x + 1) * p.tiles / gridDim.x - lo;

  // conv2's weights once, as the strip loop loads them: row n, chunk j, tap t
  for (int i = tid; i < 9 * 64 * 8; i += SM90_THREADS) {
    const int t = i / (64 * 8), nn = (i / 8) % 64, j = i % 8;
    const bool ok = nn < p.C && j * 8 < p.C;
    sm90::cp_async16(sb + t * 8192 + nn * 128 + ((j ^ (nn & 7)) << 4),
                     ok ? (const void*)(p.w2 + ((long long)nn * 9 + t) * p.C + j * 8) : p.w2,
                     ok ? 16u : 0u);
  }
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  sm90::fence_proxy_async();                   // read by wgmma
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- warpgroups 2, 3: conv1 into the ring, and the outputs out ----
    // Thread (g, run) computes channels 8 g .. 8 g + 7 of pixels 3 run ..
    // 3 run + 2 of a tile's new h1 rows; 8 adjacent lanes write one
    // 128-byte pixel row.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = tid - CONSUMERS;
    const int g = pt & 7, run = pt >> 3;
    const bool live = g * 8 < p.C;
    const TX* x = static_cast<const TX*>(p.x);
    enc0::Conv1Group cw;
    if (live) enc0::load_group(cw, p.w1, p.b1, p.C, g * 8);

    // Tile k's x patch, rows oy .. oy+5 x columns ox0 .. ox0+97 (0 past the
    // image) in f32: fetched into registers a tile ahead, so that the loads
    // run under the FMAs of the tile before, and put in patch slot k % 2.
    constexpr int PER = (PATCH + PRODUCERS - 1) / PRODUCERS;
    float* patches = reinterpret_cast<float*>(smem + SM90_PATCH);
    auto fetch = [&](const Walk& w, float (&v)[PER]) {
      const int ox0 = w.ox0();
      const TX* xb = x + (w.b * p.H + w.oy()) * p.W + ox0;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = pt + PRODUCERS * i, r = e / XCOLS, c = e - r * XCOLS;
        v[i] = e < PATCH && ox0 + c < p.W ? enc0::load_x<TX>(xb + r * p.W + c) : 0.f;
      }
    };
    auto put_patch = [&](long long k, const float (&v)[PER]) {
      float* slot = patches + (k & 1) * PATCH;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (pt + PRODUCERS * i < PATCH) slot[pt + PRODUCERS * i] = v[i];
    };

    // Tile k's new h1 rows (all 4 where it starts a column, else rows 2, 3)
    // into ring rows base + q.
    auto produce = [&](long long k, const Walk& w, bool all4, long long base) {
      const int px0 = run * RUN;
      const int inside = p.W - 2 - (w.ox0() + px0);   // the run's pixels inside the image
      const float* xp = patches + (k & 1) * PATCH + px0;
      auto put = [&](int q, int i, uint4 v) {
        const int px = px0 + i;
        if (i >= inside) v = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(smem + ring_row(base + q) + px * 128 + ((g ^ (px & 7)) << 4)) = v;
      };
      if (live && inside > 0) {
        if (all4)
          enc0::conv1_rows<RUN, 4>(cw, [&](int r, int j) { return xp[r * XCOLS + j]; }, put);
        else
          enc0::conv1_rows<RUN, 2>(cw, [&](int r, int j) { return xp[(r + 2) * XCOLS + j]; },
                                   [&](int q, int i, uint4 v) { put(q + 2, i, v); });
      } else {
#pragma unroll
        for (int i = 0; i < RUN; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (all4 || q >= 2) put(q, i, make_uint4(0u, 0u, 0u, 0u));
      }
    };

    // Tile w's staged outputs to global memory, each row's bytes contiguous:
    // thread pt takes piece pt % per_px of pixels pt / per_px + i * step
    // (a pixel row is per_px pieces; threads past step * per_px idle).
    const int skip_piece = (p.C * SB) % 16 == 0 ? 16 : 8;   // 8: an int8 skip, C % 16 == 8
    const int skip_pp = p.C * SB / skip_piece, pool_pp = p.C / 8;
    const int skip_q = pt % skip_pp, skip_p0 = pt / skip_pp, skip_step = PRODUCERS / skip_pp;
    const int pool_q = pt % pool_pp, pool_p0 = pt / pool_pp, pool_step = PRODUCERS / pool_pp;
    auto store = [&](const Walk& w) {
      const int oy = w.oy(), ox0 = w.ox0();
      const int cols = min(STW, p.Wo - ox0);   // even, as Wo and ox0 are
      const int row_bytes = p.C * SB;
      unsigned char* skip = static_cast<unsigned char*>(p.skip) + skip_q * skip_piece;
      const unsigned char* st = stage + skip_q * skip_piece;
      if (skip_p0 < skip_step) {
        for (int i = skip_p0; i < 2 * cols; i += skip_step) {
          const int r = i >= cols, px = i - r * cols;
          unsigned char* dst = skip + ((w.b * p.Ho + oy + r) * p.Wo + ox0 + px) * row_bytes;
          const unsigned char* src = st + (r * STW + px) * LDS;
          if (skip_piece == 16)
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          else
            *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        }
      }
      uint16_t* pooled = p.pooled + ((w.b * (p.Ho / 2) + oy / 2) * (p.Wo / 2) + ox0 / 2) * p.C +
                         pool_q * 8;
      if (pool_p0 < pool_step) {
        for (int px = pool_p0; px < cols / 2; px += pool_step) {
          const uint4 u = *reinterpret_cast<const uint4*>(stage + POOL + px * LDP + pool_q * 16);
          const uint4 l =
              *reinterpret_cast<const uint4*>(stage + POOL + (PTW + px) * LDP + pool_q * 16);
          *reinterpret_cast<uint4*>(pooled + (long long)px * p.C) =
              make_uint4(max_bf16x2(u.x, l.x), max_bf16x2(u.y, l.y), max_bf16x2(u.z, l.z),
                         max_bf16x2(u.w, l.w));
        }
      }
    };

    // One tile ahead of conv2: step k computes tile k + 1's rows (once
    // conv2 is done with tile k - 1's, whose ring rows they take), then
    // stores tile k. Cursors: wf the tile whose x patch is fetched, wp the
    // tile whose rows are computed, ws the tile stored.
    Walk wf = walk_at(p, lo), wp = wf, ws = wf;
    float v[PER];
    fetch(wf, v);
    put_patch(0, v);
    walk_next(p, wf);
    if (n > 1) fetch(wf, v);
    bar_sync(BAR_STEP, PRODUCERS);
    produce(0, wp, true, 0);
    sm90::fence_proxy_async();                 // generic-proxy writes, read by wgmma
    bar_arrive(BAR_FULL, SM90_THREADS);
    if (n > 1) put_patch(1, v);
    bar_sync(BAR_STEP, PRODUCERS);
    long long base = 0;                        // tile k + 1's first ring row, below
#pragma unroll 1
    for (long long k = 0; k < n; ++k) {
      if (k >= 1) bar_sync(BAR_DONE + (int)((k - 1) & 1), SM90_THREADS);
      if (k + 1 < n) {
        walk_next(p, wf);
        if (k + 2 < n) fetch(wf, v);
        walk_next(p, wp);
        const bool all4 = wp.r == 0;
        base += all4 ? 4 : 2;
        produce(k + 1, wp, all4, base);
        sm90::fence_proxy_async();
        bar_arrive(BAR_FULL + (int)((k + 1) & 1), SM90_THREADS);
        if (k + 2 < n) put_patch(k + 2, v);
      }
      bar_sync(BAR_STAGED + (int)(k & 1), SM90_THREADS);
      store(ws);
      walk_next(p, ws);
      bar_arrive(BAR_FREE + (int)(k & 1), SM90_THREADS);
      bar_sync(BAR_STEP, PRODUCERS);           // patch k + 2 staged, patch k + 1 read
    }
    bar_sync(BAR_DONE + (int)((n - 1) & 1), SM90_THREADS);
  } else {
    // ---- warpgroups 0 and 1: conv2, output row oy + wg of each tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    // Accumulator 4 c + 2 h + e: channel ch + 8 h of pixel 8 c + pxq + e.
    const int wg = tid >> 7, warp = (tid & 127) >> 5, lane = tid & 31;
    const int ch = warp * 16 + (lane >> 2);
    const int pxq = (lane & 3) * 2;
    float bias[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) bias[h] = ch + 8 * h < p.C ? p.b2[ch + 8 * h] : 0.f;
    float acc[STW / 2];
    long long base = 0;                        // tile k's first ring row
    Walk w = walk_at(p, lo);
#pragma unroll 1
    for (long long k = 0; k < n; ++k) {
      if (k > 0) {
        walk_next(p, w);
        base += w.r == 0 ? 4 : 2;
      }
      bar_sync(BAR_FULL + (int)(k & 1), SM90_THREADS);   // tile k's rows are computed
#pragma unroll
      for (int i = 0; i < STW / 2; ++i) acc[i] = 0.f;
      const uint32_t rows[3] = {sb + ring_row(base + wg), sb + ring_row(base + wg + 1),
                                sb + ring_row(base + wg + 2)};
      sm90::wgmma_fence();
      sm90::fence_acc(acc);
      sm90::strip_mma(acc, sb, rows);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(acc);
      bar_arrive(BAR_DONE + (int)(k & 1), SM90_THREADS);
      if (k > 0) bar_sync(BAR_FREE + (int)((k - 1) & 1), SM90_THREADS);   // tile k-1 stored

      // Tile k's outputs into the staging buffer: + b2, ReLU, the skip
      // (pixel-major rows), and each pool window's column max (pixels 8 c +
      // pxq, + 1).
#pragma unroll
      for (int c = 0; c < STW / 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = __fadd_rn(acc[4 * c + 2 * h + e], bias[h]);
            v[e] = a < 0.f ? 0.f : a;          // ReLU; keeps a NaN, as jnp.maximum
            unsigned char* q = stage + (wg * STW + 8 * c + pxq + e) * LDS + (ch + 8 * h) * SB;
            if constexpr (SKIP_I8) {
              // rint (half to even) and the clamp to [0, 127] in one convert:
              // v >= 0, or NaN, which converts to 0 as the clamp made it
              int r;
              asm("cvt.rni.sat.s8.f32 %0, %1;\n" : "=r"(r) : "f"(__fmul_rn(v[e], p.inv_skip)));
              *reinterpret_cast<int8_t*>(q) = (int8_t)r;
            } else {
              *reinterpret_cast<__nv_bfloat16*>(q) = __float2bfloat16(v[e]);
            }
          }
          *reinterpret_cast<__nv_bfloat16*>(stage + POOL + (wg * PTW + 4 * c + (lane & 3)) * LDP +
                                            (ch + 8 * h) * 2) = __float2bfloat16(fmaxf(v[0], v[1]));
        }
      bar_arrive(BAR_STAGED + (int)(k & 1), SM90_THREADS);
    }
    bar_sync(BAR_FREE + (int)((n - 1) & 1), SM90_THREADS);
  }
}

template <typename TX, bool SKIP_I8>
int launch_sm90(const Chain& p, int sms, cudaStream_t s) {
  auto kernel = enc0_chain_sm90_kernel<TX, SKIP_I8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SM90_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = p.tiles < sms ? p.tiles : sms;
  kernel<<<(unsigned)blocks, SM90_THREADS, SM90_SMEM, s>>>(p);
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

// The sm90 route: the same arguments, w2 K-major [C, 9, C] bf16 (16-byte
// aligned, as w1 and b1), plus the walk that ops/fused_level0.py::enc0_plan
// computed (tiles, tiles_c, tiles_img; refused unless it is this entry's)
// and the card's `sms`, one persistent block per SM.
extern "C" int enc0_chain_sm90(const void* x, const void* w1, const void* b1, const void* w2,
                               const void* b2, void* skip, void* pooled, int batch, int H,
                               int W, int C, int x_bf16, int skip_i8, float inv_skip,
                               long long tiles, int tiles_c, int tiles_img, int sms,
                               void* stream) {
  if (batch < 1 || H < 6 || W < 6 || (H - 4) % 2 || (W - 4) % 2 || C < 8 || C % 8 ||
      C > MAX_C || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Chain p;
  p.x = x;
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const __nv_bfloat16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.skip = skip;
  p.pooled = static_cast<uint16_t*>(pooled);
  p.H = H;
  p.W = W;
  p.Ho = H - 4;
  p.Wo = W - 4;
  p.C = C;
  p.inv_skip = inv_skip;
  const long long tc = (p.Wo + sm90::STRIP_TW - 1) / sm90::STRIP_TW;
  const long long ti = (long long)(p.Ho / 2) * tc;
  if (tiles_c != tc || tiles_img != ti || tiles != (long long)batch * ti)
    return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = tiles;
  p.tiles_c = tiles_c;
  p.tiles_img = tiles_img;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return skip_i8 ? launch_sm90<uint16_t, true>(p, sms, s)
                   : launch_sm90<uint16_t, false>(p, sms, s);
  return skip_i8 ? launch_sm90<float, true>(p, sms, s) : launch_sm90<float, false>(p, sms, s);
}
