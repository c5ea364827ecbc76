// The Hopper (sm_90a) main loops for the bf16 3x3 valid convolution,
// NHWC, with f32 sums: implicit GEMMs fed by cp.async into wgmma. The flat
// loop takes any Cin, Cout (multiples of 8); the strip loop (further down)
// Cin, Cout <= 64; ops/conv_pallas.py::sm90_plan picks one, and the flat
// loop's block.
//
// Included by conv3x3_bias_relu.cu (K1's bf16 route: bias + ReLU -> bf16,
// the bias bf16 or f32),
// enc0_stages.cu (the Mosaic probes' conv2 stage: f32 out, or bf16(ReLU))
// and enc0_chain.cu (K4's sm90 route runs the strip loop's MMA step,
// `strip_mma`, on h1 rows its conv1 computes); conv_fused.cuh builds its
// int8 loop on this file's ring, copies, swizzle and wgmma helpers.
// Everything here has internal linkage, so each file builds the instances
// it launches.
//
//   x [B, H, W, Cin] bf16, w [Cout, 9, Cin] bf16 (K-major: each output
//   channel's row, tap-major with ascending channels), bias [Cout] bf16 or
//   f32 -> y [B, H-2, W-2, Cout], bf16 or f32.
//
// The flat loop's GEMM: M = B*Ho*Wo output pixels (flat, so a ragged Wo wastes
// nothing), N = Cout, K = 9*Cin in steps of one tap (dy, dx) x 64
// channels (128 bytes), tap-major with ascending channels. For output
// pixel m = (b, oy, ox) a K step's A row is one contiguous 128-byte run at
// base(m) + (dy*W + dx)*Cin + c0, base(m) = ((b*H + oy)*W + ox)*Cin: the
// bases are computed once per block (4 per thread), and the loop only adds
// the step's offset. Channels past Cin (Cin < 64, or not a multiple of 64)
// and rows past M or Cout are zero-filled by cp.async with src-size 0.
// Offsets are 64-bit: a 16-tile chunk of enc0_conv2 holds ~333 M elements.
//
// A block is BM output pixels (128 or 256) x BN output channels (64 or
// 128), 2 BM threads = BM / 64 warpgroups, each owning 64 rows. A ring
// of S = 4 stages in dynamic shared memory holds per stage the A tile (BM
// rows x 128 B) and the B tile (BN rows x 128 B), both K-major in the
// 128-byte swizzle that wgmma's shared-memory descriptors read (layout 1:
// 16-byte chunk j of row r at chunk j ^ (r % 8), 8-row groups 1024 B
// apart, tiles 1024-byte aligned). Every thread copies 16-byte chunks with
// cp.async.cg;
// the ring keeps S - 2 steps in flight while wgmma m64nBNk16 (4 per step
// and warpgroup) runs on an arrived step, with one wgmma group left in
// flight across the step boundary (wait_group 1), so the slot written next
// is the one read two steps back. One __syncthreads per step publishes the
// arrived slot (after cp.async.wait_group and a generic-to-async proxy
// fence) and retires the slot being refilled. 128-row blocks run two to an
// SM where two rings fit, so one block's prologue and epilogue overlap the
// other's loop; 256-row blocks halve the B traffic per output.
//
// The epilogue is a template parameter: bias + ReLU -> bf16 (K1; the bias
// bf16, or f32 for the int8 tier's float layers, whose f32 bias a bf16 copy
// would round before the one rounding of the output), none -> f32, ReLU ->
// bf16 (the conv2 stage). ReLU is `v < 0 ? 0 : v`, which keeps a NaN. The
// tile goes through shared memory (the retired ring) so that every store to
// y is 16 bytes and a row's stores are contiguous.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace sm90 {

constexpr int BK = 64;         // channels per K step: 128 bytes of bf16
constexpr int SMEM_ALIGN = 1024;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may hold (227 KB)
constexpr int STAGES = 4;      // the flat loop's ring
// A block of BM output pixels runs BM / 64 warpgroups, 64 rows each.
__host__ __device__ constexpr int threads(int bm) { return 2 * bm; }

enum Epilogue { BIAS_RELU_BF16 = 0, F32 = 1, RELU_BF16 = 2, BIAS_F32_RELU_BF16 = 3 };
__host__ __device__ constexpr bool has_bias(int epi) {
  return epi == BIAS_RELU_BF16 || epi == BIAS_F32_RELU_BF16;
}

struct Conv {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  const void* bias;            // bf16 for BIAS_RELU_BF16, f32 for BIAS_F32_RELU_BF16
  void* y;
  long long M;                 // B * Ho * Wo
  long long HoWo;
  int H, W, Wo, Cin, Cout;
  int n_tiles;                 // ceil(Cout / BN); blockIdx.x = m_tile * n_tiles + n_tile
};

__host__ __device__ constexpr int stage_bytes(int bm, int bn) { return (bm + bn) * BK * 2; }
__host__ __device__ constexpr int smem_bytes(int bm, int bn) {
  return STAGES * stage_bytes(bm, bn) + SMEM_ALIGN;
}
// Two 256-thread blocks per SM where two rings fit in the 227 KB a block
// may hold (and 128 registers a thread do); a 512-thread block alone.
__host__ __device__ constexpr int min_blocks(int bm, int bn) {
  return bm == 128 && 2 * smem_bytes(bm, bn) <= SMEM_MAX ? 2 : 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy; wgmma reads through the async one.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's commit and wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major operand, 128-byte swizzle: start >> 4, leading offset 1 (unused
// for this swizzle), stride 1024 B between 8-row groups, layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32, A and B from shared memory
// (K-major both), D += A * B. d holds the warpgroup's 64 x N accumulator
// tile, N / 2 values per thread.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n88(float (&d)[44], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %46, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, "
      "%44, %45, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) wgmma_n64(d, a, b);
  else wgmma_n128(d, a, b);
}

// Output channel n's bias in f32, read in the type the epilogue takes.
template <int EPI>
__device__ __forceinline__ float bias_at(const Conv& p, int n) {
  if constexpr (EPI == BIAS_F32_RELU_BF16) return static_cast<const float*>(p.bias)[n];
  else return __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[n]);
}

template <int EPI>
__device__ __forceinline__ float epilogue(float v, float bias) {
  if constexpr (has_bias(EPI)) v += bias;
  if constexpr (EPI != F32) v = v < 0.f ? 0.f : v;
  return v;
}

template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(threads(BM), min_blocks(BM, BN))
    conv3x3_kernel(const Conv p) {
  static_assert(BM == 128 || BM == 256, "BM");
  static_assert(BN == 64 || BN == 128, "BN");
  constexpr int S = STAGES;
  static_assert(S >= 3, "the ring keeps S - 2 steps in flight");
  static_assert(smem_bytes(BM, BN) <= SMEM_MAX, "the ring fits the card");
  constexpr int THREADS = threads(BM);
  constexpr int RSTEP = THREADS / 8;          // tile rows one pass of the threads copies
  constexpr int A_BYTES = BM * BK * 2;
  constexpr int STAGE = stage_bytes(BM, BN);
  constexpr int OUT_BYTES = EPI == F32 ? 4 : 2;
  constexpr int LDS = BN * OUT_BYTES + 16;   // epilogue tile row, padded
  static_assert(BM * LDS <= S * STAGE, "the epilogue tile fits the ring");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (SMEM_ALIGN - (raw & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1);
  unsigned char* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;

  const int tid = threadIdx.x;
  const long long m0 = (long long)(blockIdx.x / p.n_tiles) * BM;
  const int n0 = (blockIdx.x % p.n_tiles) * BN;

  // This thread copies 16-byte chunk j of tile rows r0 + RSTEP i; those
  // rows share r0 % 8, so the swizzled chunk is the same for all of them.
  const int j = tid & 7;
  const int r0 = tid >> 3;
  const uint32_t dst = (uint32_t)(r0 * 128 + ((j ^ (r0 & 7)) << 4));
  long long a_off[4];             // element offset of the pixel's chunk j, -1 past M
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + r0 + RSTEP * i;
    if (m < p.M) {
      const long long b = m / p.HoWo;
      const long long rem = m - b * p.HoWo;
      const long long oy = rem / p.Wo;
      const long long ox = rem - oy * p.Wo;
      a_off[i] = ((b * p.H + oy) * p.W + ox) * p.Cin + j * 8;
    } else {
      a_off[i] = -1;
    }
  }
  constexpr int BROWS = BN / RSTEP;
  static_assert(BROWS * RSTEP == BN, "whole passes over the B tile");
  long long b_off[BROWS];         // element offset of the weight row's chunk j, -1 past Cout
#pragma unroll
  for (int i = 0; i < BROWS; ++i) {
    const int n = n0 + r0 + RSTEP * i;
    b_off[i] = n < p.Cout ? (long long)n * 9 * p.Cin + j * 8 : -1;
  }

  // The producer's position: K step `ld` is tap (dy, dx), channels c0..c0+63.
  const int nk = 9 * ((p.Cin + BK - 1) / BK);
  int ld = 0, ld_dy = 0, ld_dx = 0, ld_c0 = 0;
  auto prefetch = [&]() {
    if (ld < nk) {
      const uint32_t sa = sbase + (uint32_t)((ld % S) * STAGE) + dst;
      const uint32_t sb = sa + A_BYTES;
      const bool cvalid = ld_c0 + j * 8 < p.Cin;
      const long long a_step = ((long long)ld_dy * p.W + ld_dx) * p.Cin + ld_c0;
      const long long b_step = (long long)(ld_dy * 3 + ld_dx) * p.Cin + ld_c0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = cvalid && a_off[i] >= 0;
        cp_async16(sa + i * RSTEP * 128, ok ? (const void*)(p.x + a_off[i] + a_step) : p.x,
                   ok ? 16u : 0u);
      }
#pragma unroll
      for (int i = 0; i < BROWS; ++i) {
        const bool ok = cvalid && b_off[i] >= 0;
        cp_async16(sb + i * RSTEP * 128, ok ? (const void*)(p.w + b_off[i] + b_step) : p.w,
                   ok ? 16u : 0u);
      }
      ++ld;
      ld_c0 += BK;
      if (ld_c0 >= p.Cin) {
        ld_c0 = 0;
        if (++ld_dx == 3) {
          ld_dx = 0;
          ++ld_dy;
        }
      }
    }
    cp_async_commit();            // one group per step, empty past the last
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 2; ++s) prefetch();

  const int wg = tid >> 7;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<S - 3>();       // this thread's copies of step k have landed
    fence_proxy_async();
    __syncthreads();              // everyone's have; step k - 2's wgmma are retired
    const uint32_t sa = sbase + (uint32_t)((k % S) * STAGE) + wg * 64 * 128;
    const uint32_t sb = sbase + (uint32_t)((k % S) * STAGE) + A_BYTES;
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_step<BN>(acc, desc_sw128(sa + kk * 32), desc_sw128(sb + kk * 32));
    wgmma_commit();
    prefetch();                   // step k + S - 2 into the slot step k - 2 used, under the MMAs
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  cp_async_wait<0>();
  __syncthreads();                // the ring is free for the epilogue tile

  // Accumulator 4 c + 2 h + e of a thread holds row 16 warp + lane / 4 + 8 h
  // of its warpgroup's 64, column 8 c + 2 (lane % 4) + e.
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int row = wg * 64 + warp * 16 + (lane >> 2);
  const int colq = (lane & 3) * 2;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    const int col = c * 8 + colq;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (has_bias(EPI)) {
      if (n0 + col < p.Cout) {    // Cout is a multiple of 8: col + 1 is inside too
        b0 = bias_at<EPI>(p, n0 + col);
        b1 = bias_at<EPI>(p, n0 + col + 1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = epilogue<EPI>(acc[4 * c + 2 * h], b0);
      const float v1 = epilogue<EPI>(acc[4 * c + 2 * h + 1], b1);
      unsigned char* q = smem + (row + 8 * h) * LDS + col * OUT_BYTES;
      if constexpr (EPI == F32) {
        *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();

  constexpr int CPR = BN * OUT_BYTES / 16;     // 16-byte chunks per tile row
  constexpr int VE = 16 / OUT_BYTES;           // outputs per chunk
  unsigned char* y = static_cast<unsigned char*>(p.y);
#pragma unroll 4
  for (int c = tid; c < BM * CPR; c += THREADS) {
    const int r = c / CPR, q = c % CPR;
    const long long m = m0 + r;
    const int n = n0 + q * VE;
    if (m < p.M && n < p.Cout)
      *reinterpret_cast<uint4*>(y + (m * p.Cout + n) * OUT_BYTES) =
          *reinterpret_cast<const uint4*>(smem + r * LDS + q * 16);
  }
}

// What both loops take: Cin and Cout multiples of 8 (16-byte rows of x,
// w and y).
inline bool channels_ok(const Conv& p) {
  return p.Cin >= 8 && p.Cin % 8 == 0 && p.Cout >= 8 && p.Cout % 8 == 0;
}

// Launch the flat loop with BM x BN blocks: one per M tile and N tile.
template <int BM, int BN, int EPI>
int launch(const Conv& p, cudaStream_t stream) {
  const long long blocks = (p.M + BM - 1) / BM * p.n_tiles;
  if (!channels_ok(p) || p.n_tiles != (p.Cout + BN - 1) / BN || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = smem_bytes(BM, BN);
  auto kernel = conv3x3_kernel<BM, BN, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)blocks, threads(BM), smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- the strip loop: Cin <= 64, Cout <= 64 ---------------------------------
// Where one K step covers every channel and one block column every output
// channel (enc0_conv2, dec0_conv2, the conv2 stage), the flat loop has two
// costs the strip loop removes. (1) It reads each input pixel 9 times from
// L2, once per tap; the strip loop reads it once per tile: a tile is 2
// output rows x 88 columns, and its input strip, rows oy..oy+3 x columns
// ox0..ox0+89 x 64 channels, lands in shared memory in the 128-byte
// swizzle (pixel px of a strip row at row px of a 1024-byte-aligned row
// padded to 8-row groups). (2) Its m64n64 wgmma reads as many operand
// bytes from shared memory as the tensor cores can use; the strip loop
// swaps the operands, D^T = W x X^T, so that the 64 output channels are M
// and 88 pixels are N: warpgroup g runs m64n88k16 with A the tap's weights
// and B the 88 pixels that start at row (g + dy, dx) of the strip, a
// descriptor that starts dx rows into the swizzle pattern, base-offset
// field 0 (the swizzle is a function of the address bits; a base offset
// of dx reads wrong data on the H100). The weights (9 taps x 64 x 64) stay
// in shared memory for the block's life; blocks are persistent (one per
// SM), walking tiles t = blockIdx.x + i gridDim.x through a ring of 3
// strip buffers, 2 strips in flight under the current tile's 72 wgmma.
// The accumulators (channel x pixel) go through the strip buffer just
// read, transposed to pixel-major rows, and out in 16-byte stores.
constexpr int STRIP_THREADS = 256;
constexpr int STRIP_B = 9 * 64 * 128;        // the resident weights: 9 taps x 64 rows
// A tile's output columns (the wgmma N) and the ring's strip buffers: 88
// columns is the most that three buffers and the weights leave room for.
constexpr int STRIP_TW = 88;
constexpr int STRIP_NB = 3;
constexpr int STRIP_IN = STRIP_TW + 2;                 // input pixels a strip row uses
constexpr int STRIP_ROW = (STRIP_IN + 7) / 8 * 8 * 128;  // 12 KB: 8-row groups, 1024-aligned
constexpr int STRIP_BYTES = 4 * STRIP_ROW;             // input rows oy .. oy + 3
__host__ __device__ constexpr int strip_smem_bytes() {
  return STRIP_B + STRIP_NB * STRIP_BYTES + SMEM_ALIGN;
}

// The strip loop's MMA step, D += W x X^T for one output row of a tile:
// the 9 taps x 4 k16 wgmma m64n88k16 of one warpgroup on its three input
// rows (rows[dy] the shared-memory address of input row dy, each a row of
// the strip layout: pixel px at px * 128 bytes, 128-byte swizzle), with the
// resident weights at `sw` (tap t at t * 8 KB). Every caller (K1's strip
// route, the conv2 stage, K4's sm90 route) issues this one sequence, so
// their f32 sums of the same operands are equal bit for bit. The caller
// fences before and commits after.
__device__ __forceinline__ void strip_mma(float (&acc)[STRIP_TW / 2], uint32_t sw,
                                          const uint32_t (&rows)[3]) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const uint32_t px0 = rows[dy] + dx * 128;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_n88(acc, desc_sw128(sw + tap * 8192 + kk * 32), desc_sw128(px0 + kk * 32));
  }
}

template <int EPI>
__global__ void __launch_bounds__(STRIP_THREADS, 1)
    conv3x3_strip_kernel(const Conv p, long long tiles, int tiles_c, int tiles_img) {
  constexpr int OUT_BYTES = EPI == F32 ? 4 : 2;
  constexpr int LDS = 64 * OUT_BYTES + 16;     // staged output pixel row, padded
  static_assert(2 * STRIP_TW * LDS <= STRIP_BYTES, "the staged tile fits a strip buffer");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (SMEM_ALIGN - (raw & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1);
  unsigned char* smem = smem_raw + pad;
  const uint32_t sb = raw + pad;               // the weights, tap t at t * 8 KB
  const uint32_t sstrip = sb + STRIP_B;        // strip buffer k at k * STRIP_BYTES
  const int tid = threadIdx.x;
  const int Ho = p.H - 2;

  // the weights once: row n (output channel), chunk j, tap t
  for (int i = tid; i < 9 * 64 * 8; i += STRIP_THREADS) {
    const int t = i / (64 * 8), n = (i / 8) % 64, j = i % 8;
    const bool ok = n < p.Cout && j * 8 < p.Cin;
    cp_async16(sb + t * 8192 + n * 128 + ((j ^ (n & 7)) << 4),
               ok ? (const void*)(p.w + ((long long)n * 9 + t) * p.Cin + j * 8) : p.w,
               ok ? 16u : 0u);
  }

  // the strip of local tile `k` (global tile blockIdx.x + k gridDim.x)
  auto prefetch = [&](long long k) {
    const long long t = blockIdx.x + k * gridDim.x;
    if (t < tiles) {
      const uint32_t buf = sstrip + (uint32_t)((k % STRIP_NB) * STRIP_BYTES);
      const long long b = t / tiles_img;
      const int rem = (int)(t - b * tiles_img);
      const int oy = (rem / tiles_c) * 2, ox0 = (rem % tiles_c) * STRIP_TW;
      for (int i = tid; i < 4 * STRIP_IN * 8; i += STRIP_THREADS) {
        const int rr = i / (STRIP_IN * 8), px = (i / 8) % STRIP_IN, j = i % 8;
        const int iy = oy + rr, ix = ox0 + px;
        const bool ok = iy < p.H && ix < p.W && j * 8 < p.Cin;
        cp_async16(buf + rr * STRIP_ROW + px * 128 + ((j ^ (px & 7)) << 4),
                   ok ? (const void*)(p.x + ((b * p.H + iy) * p.W + ix) * p.Cin + j * 8) : p.x,
                   ok ? 16u : 0u);
      }
    }
    cp_async_commit();            // one group per tile, empty past the last
  };

#pragma unroll
  for (int k = 0; k < STRIP_NB - 1; ++k) prefetch(k);   // the weights ride in the first group

  const int wg = tid >> 7;                     // output row oy + wg
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  const int ch = warp * 16 + (lane >> 2);      // channels ch and ch + 8
  const int pxq = (lane & 3) * 2;              // pixels 8 c + pxq + e
  float bias[2] = {0.f, 0.f};
  if constexpr (has_bias(EPI)) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (ch + 8 * h < p.Cout) bias[h] = bias_at<EPI>(p, ch + 8 * h);
  }
  float acc[STRIP_TW / 2];
  for (long long k = 0; blockIdx.x + k * gridDim.x < tiles; ++k) {
    cp_async_wait<STRIP_NB - 2>();  // this thread's copies of tile k have landed
    fence_proxy_async();
    __syncthreads();              // everyone's have; tile k - 1's stores have read its buffer
#pragma unroll
    for (int i = 0; i < STRIP_TW / 2; ++i) acc[i] = 0.f;
    const uint32_t buf = sstrip + (uint32_t)((k % STRIP_NB) * STRIP_BYTES);
    wgmma_fence();
    fence_acc(acc);
    const uint32_t rows[3] = {buf + wg * STRIP_ROW, buf + (wg + 1) * STRIP_ROW,
                              buf + (wg + 2) * STRIP_ROW};
    strip_mma(acc, sb, rows);
    wgmma_commit();
    prefetch(k + STRIP_NB - 1);   // into the buffer tile k - 1 used, under the MMAs
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();              // both warpgroups are done reading the strip

    // Accumulator 4 c + 2 h + e: channel ch + 8 h of pixel 8 c + pxq + e of
    // output row oy + wg; staged as pixel-major rows of the strip buffer.
    unsigned char* stage = smem + (sstrip - sb) + (k % STRIP_NB) * STRIP_BYTES;
#pragma unroll
    for (int c = 0; c < STRIP_TW / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = epilogue<EPI>(acc[4 * c + 2 * h + e], bias[h]);
          unsigned char* q = stage + (wg * STRIP_TW + 8 * c + pxq + e) * LDS +
                             (ch + 8 * h) * OUT_BYTES;
          if constexpr (EPI == F32)
            *reinterpret_cast<float*>(q) = v;
          else
            *reinterpret_cast<__nv_bfloat16*>(q) = __float2bfloat16(v);
        }
    __syncthreads();

    const long long t = blockIdx.x + k * gridDim.x;
    const long long b = t / tiles_img;
    const int rem = (int)(t - b * tiles_img);
    const int oy = (rem / tiles_c) * 2, ox0 = (rem % tiles_c) * STRIP_TW;
    constexpr int CPR = 64 * OUT_BYTES / 16;   // 16-byte chunks per staged pixel row
    constexpr int VE = 16 / OUT_BYTES;
    unsigned char* y = static_cast<unsigned char*>(p.y);
#pragma unroll 4
    for (int i = tid; i < 2 * STRIP_TW * CPR; i += STRIP_THREADS) {
      const int r = i / CPR, q = i % CPR;
      const int oyr = oy + r / STRIP_TW, ox = ox0 + r % STRIP_TW;
      if (oyr < Ho && ox < p.Wo && q * VE < p.Cout)
        *reinterpret_cast<uint4*>(y + (((b * Ho + oyr) * p.Wo + ox) * p.Cout + q * VE) *
                                          OUT_BYTES) =
            *reinterpret_cast<const uint4*>(stage + r * LDS + q * 16);
    }
  }
  cp_async_wait<0>();
}

// The strip loop's tiles: batch x ceil(Ho / 2) x ceil(Wo / STRIP_TW).
inline long long strip_tiles(const Conv& p, int* tiles_c, int* tiles_img) {
  *tiles_c = (p.Wo + STRIP_TW - 1) / STRIP_TW;
  *tiles_img = ((p.H - 2 + 1) / 2) * *tiles_c;
  return p.M / p.HoWo * *tiles_img;
}

// Launch the strip loop on persistent blocks: one per SM of the `sms` the
// card has, at most one per tile.
template <int EPI>
int launch_strip(const Conv& p, int sms, cudaStream_t stream) {
  int tiles_c = 0, tiles_img = 0;
  const long long tiles = strip_tiles(p, &tiles_c, &tiles_img);
  if (!channels_ok(p) || p.Cin > 64 || p.Cout > 64 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = tiles < sms ? tiles : sms;
  constexpr int smem = strip_smem_bytes();
  static_assert(smem <= SMEM_MAX, "the weights and the ring fit the card");
  auto kernel = conv3x3_strip_kernel<EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)blocks, STRIP_THREADS, smem, stream>>>(p, tiles, tiles_c, tiles_img);
  return static_cast<int>(cudaGetLastError());
}

inline Conv make_conv(const void* x, const void* w, const void* bias, void* y, int batch,
                      int H, int W, int Cin, int Cout, int bn) {
  Conv p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.bias = bias;
  p.y = y;
  p.H = H;
  p.W = W;
  p.Wo = W - 2;
  p.HoWo = (long long)(H - 2) * (W - 2);
  p.M = (long long)batch * p.HoWo;
  p.Cin = Cin;
  p.Cout = Cout;
  p.n_tiles = (Cout + bn - 1) / bn;
  return p;
}

}  // namespace sm90
}  // namespace
