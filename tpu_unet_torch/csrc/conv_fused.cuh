// The fused k x k valid convolution + per-channel scale + bias + ReLU (+ int8
// requantize), NHWC, on its two routes: shared by conv3x3_fused.cu (K3,
// k = 3, int8 or bf16 inputs) and conv_kxk_fused.cu (the phase-packed level
// 0's k x k int8 conv, k = 2 or 3). Everything here has internal linkage and
// is templated on a tag type that each file defines, so each file builds the
// instances it launches, under kernel names that carry its tag.
//
//   acc = conv_kxk_valid(x, w)       int8 x int8 -> int32, or bf16 x bf16 -> f32
//   v   = relu(acc * alpha[c] + beta[c])     in f32, multiply then add, each
//                                            rounded (no FMA contraction); the
//                                            int32 -> f32 conversion rounds to
//                                            nearest (|acc| passes 2^24)
//   y   = min(rint(v), 127) as int8          (out_int8; rint: half to even)
//         or v rounded to bf16
//
//   x [B, H, W, Cin], w as wt [Cout, KH*KH*Cin] (the HWIO kernel read as a
//   [KH*KH*Cin, Cout] matrix, transposed by the wrapper: each output
//   channel's row, tap-major with ascending channels), alpha, beta f32
//   [Cout] -> y [B, H-KH+1, W-KH+1, Cout], all contiguous.
//
// Both routes are implicit GEMMs: M = B*Ho*Wo output pixels, N = Cout, K =
// KH*KH*Cin, k = (dy*KH + dx)*Cin + c. Output pixel m = (b, oy, ox) reads
// element k of its receptive field at base(m) + (dy*W + dx)*Cin + c, base(m)
// = ((b*H + oy)*W + ox)*Cin; every pixel inside M reads inside the image, so
// the staged tiles are zero-filled only past M, past Cin (or K) and past
// Cout. Offsets are 64-bit.
//
// What bounds it on the H100: the int8 layers of a 572^2 serving tile do
// 2*KH^2*Cin*Cout operations per output pixel against Cin + Cout bytes in and
// out (at Cin = Cout = 128, 3x3: 1152 op/byte, twice the card's ~590 int8
// op/byte ridge, and more at every deeper layer), so both kernels are
// tensor-core bound at every int8 shape of the main path.
//
// Route "sm90" (`sm90::conv_int8_kernel`; int8 x, Cin a multiple of 16, Cout
// a multiple of 16 (int8 out) or 8 (bf16 out), 16-byte aligned x, w and y):
// the int8 counterpart of conv3x3_sm90.cuh's flat loop, with its helpers. A K
// step is one tap (dy, dx) x 128 int8 channels, 128 bytes: the A tile (BM
// pixels) and the B tile (BN output channels) land in the same 128-byte
// swizzle as the bf16 loop's, through a cp.async ring of STAGES steps, and
// feed wgmma m64nBNk32 s8 x s8 -> s32 (4 per step and warpgroup, both
// operands K-major, as the integer wgmma requires), accumulators in
// registers. Per step an int8 block moves the bytes of a bf16 one for twice
// the operations. The epilogue runs on the accumulators in registers, with
// alpha and beta read once per block into shared memory, and stages the
// output tile through the retired ring so that every store to y is 16 bytes.
// Blocks: 256 x 128 (one per SM, half the weight traffic per output) or 128 x
// 64 (two per SM, where Cout <= 64); ops/conv_tiles.py::sm90_block picks.
//
// Route "simple" (`onestage::conv_fused_kernel`; what the sm90 route does not
// take: bf16 inputs, odd Cin or Cout, a misaligned x): the first design,
// mma.sync (m16n8k32 s8 -> s32, m16n8k16 bf16 -> f32) on a 128-pixel x
// 64-channel block tile of 8 warps, each 32 x 32, K staged 64 bytes at a
// time through one shared-memory stage. Staged rows are K-contiguous for both
// operands, so each 32-bit fragment register is one shared-memory load; rows
// are padded to 80 bytes, which puts the 32 lanes of a fragment load on 32
// different banks.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "conv3x3_sm90.cuh"

namespace {

// The epilogue both routes apply to one int32 (or f32) sum.
__device__ __forceinline__ float requant(float acc, float alpha, float beta) {
  const float v = __fadd_rn(__fmul_rn(acc, alpha), beta);
  return v < 0.f ? 0.f : v;  // ReLU; keeps a NaN, as torch.relu does
}
__device__ __forceinline__ int8_t to_int8(float v) {
  return (int8_t)(int)fminf(rintf(v), 127.f);
}

namespace onestage {

constexpr int BM = 128;        // output pixels per block
constexpr int BN = 64;         // output channels per block
constexpr int THREADS = 256;   // 8 warps: 4 (pixels) x 2 (channels) of 32 x 32
constexpr int BKB = 64;        // bytes of K staged per step: two MMA k-steps
constexpr int LDS = BKB + 16;  // staged row stride in bytes

struct Geom {
  long long M;     // B * Ho * Wo
  long long HoWo;  // Ho * Wo
  int H, W, Wo, Cin, Cout, K;
};

inline Geom make_geom(int batch, int H, int W, int Cin, int Cout, int kh) {
  Geom g;
  g.H = H;
  g.W = W;
  g.Wo = W - kh + 1;
  g.Cin = Cin;
  g.Cout = Cout;
  g.K = kh * kh * Cin;
  g.HoWo = (long long)(H - kh + 1) * g.Wo;
  g.M = (long long)batch * g.HoWo;
  return g;
}

// The tensor-core product for each storage type: uint8_t holds int8 values,
// uint16_t bf16 bit patterns.
template <typename S> struct Mma;

template <> struct Mma<uint8_t> {
  using Acc = int;
  static __device__ __forceinline__ void run(int (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }
};

template <> struct Mma<uint16_t> {
  using Acc = float;
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  static __device__ __forceinline__ float to_float(float v) { return v; }
};

// Input offset of the block's BM output pixels; -1 past M.
__device__ void pixel_bases(const Geom& g, long long m0, long long* base) {
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const long long m = m0 + r;
    if (m < g.M) {
      const long long b = m / g.HoWo;
      const long long rem = m - b * g.HoWo;
      const long long oy = rem / g.Wo;
      const long long ox = rem - oy * g.Wo;
      base[r] = ((b * g.H + oy) * g.W + ox) * g.Cin;
    } else {
      base[r] = -1;
    }
  }
}

// Offset of receptive-field element k relative to its pixel's base.
template <int KH>
__device__ __forceinline__ long long tap_offset(const Geom& g, int k) {
  const int tap = k / g.Cin;
  const int c = k - tap * g.Cin;
  const int dy = tap / KH;
  const int dx = tap - dy * KH;
  return ((long long)dy * g.W + dx) * g.Cin + c;
}

// Stage A[m0:m0+BM, k0:k0+BKB/sizeof(S)] into As, one pixel per row. VEC
// moves 16 bytes per load; the caller guarantees Cin*sizeof(S) is a multiple
// of 16 (so a vector never straddles two taps or the end of K) and 16-byte
// aligned pointers.
template <typename S, int KH, bool VEC>
__device__ void load_a(const S* __restrict__ x, const Geom& g, const long long* base,
                       int k0, unsigned char* As) {
  constexpr int E = sizeof(S);
  constexpr int BKE = BKB / E;
  if constexpr (VEC) {
    constexpr int VE = 16 / E;
    constexpr int VPR = BKE / VE;
    for (int v = threadIdx.x; v < BM * VPR; v += THREADS) {
      const int r = v / VPR;
      const int kk = (v - r * VPR) * VE;
      const int k = k0 + kk;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < g.K && base[r] >= 0)
        val = *reinterpret_cast<const uint4*>(x + (base[r] + tap_offset<KH>(g, k)));
      *reinterpret_cast<uint4*>(As + r * LDS + kk * E) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BM * BKE; e += THREADS) {
      const int r = e / BKE;
      const int kk = e - r * BKE;
      const int k = k0 + kk;
      S val = 0;
      if (k < g.K && base[r] >= 0) val = x[base[r] + tap_offset<KH>(g, k)];
      reinterpret_cast<S*>(As + r * LDS)[kk] = val;
    }
  }
}

// Stage wt[n0:n0+BN, k0:k0+BKB/sizeof(S)] into Bs, one output channel per row.
template <typename S, bool VEC>
__device__ void load_b(const S* __restrict__ wt, const Geom& g, int k0, int n0,
                       unsigned char* Bs) {
  constexpr int E = sizeof(S);
  constexpr int BKE = BKB / E;
  if constexpr (VEC) {
    constexpr int VE = 16 / E;
    constexpr int VPR = BKE / VE;
    for (int v = threadIdx.x; v < BN * VPR; v += THREADS) {
      const int r = v / VPR;
      const int kk = (v - r * VPR) * VE;
      const int n = n0 + r;
      const int k = k0 + kk;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < g.Cout && k < g.K)
        val = *reinterpret_cast<const uint4*>(wt + ((long long)n * g.K + k));
      *reinterpret_cast<uint4*>(Bs + r * LDS + kk * E) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BN * BKE; e += THREADS) {
      const int r = e / BKE;
      const int kk = e - r * BKE;
      const int n = n0 + r;
      const int k = k0 + kk;
      S val = 0;
      if (n < g.Cout && k < g.K) val = wt[(long long)n * g.K + k];
      reinterpret_cast<S*>(Bs + r * LDS)[kk] = val;
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename Tag, typename S, int KH, bool VEC, bool OUT8>
__global__ void __launch_bounds__(THREADS)
conv_fused_kernel(const S* __restrict__ x, const S* __restrict__ wt,
                  const float* __restrict__ alpha, const float* __restrict__ beta,
                  void* __restrict__ y, Geom g) {
  using Acc = typename Mma<S>::Acc;
  constexpr int BKE = BKB / sizeof(S);
  __shared__ __align__(16) unsigned char As[BM * LDS];
  __shared__ __align__(16) unsigned char Bs[BN * LDS];
  __shared__ long long base[BM];

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % 4;       // warp rows [wm*32, wm*32 + 32)
  const int wn = warp / 4;       // warp cols [wn*32, wn*32 + 32)
  const int grp = lane >> 2;     // the fragment's row (A, C) or column (B)
  const int tq = lane & 3;       // its 4-byte slot along K

  pixel_bases(g, m0, base);
  Acc acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  __syncthreads();

  for (int k0 = 0; k0 < g.K; k0 += BKE) {
    load_a<S, KH, VEC>(x, g, base, k0, As);
    load_b<S, VEC>(wt, g, k0, n0, Bs);
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < BKB; kb += 32) {
      // A (16 rows x 32 bytes): registers {row, row + 8} x {bytes 0-15, 16-31};
      // B (8 columns x 32 bytes): registers {bytes 0-15, 16-31}; lane slot tq*4.
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* p = As + (wm * 32 + i * 16 + grp) * LDS + kb + tq * 4;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDS);
        af[i][2] = ld32(p + 16);
        af[i][3] = ld32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* q = Bs + (wn * 32 + j * 8 + grp) * LDS + kb + tq * 4;
        bf[j][0] = ld32(q);
        bf[j][1] = ld32(q + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Mma<S>::run(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // Accumulator register r of tile (i, j): row grp + 8*(r/2), column tq*2 + r%2.
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long m = m0 + wm * 32 + i * 16 + grp + 8 * (r >> 1);
        const int n = n0 + wn * 32 + j * 8 + tq * 2 + (r & 1);
        if (m < g.M && n < g.Cout) {
          const float v = requant(Mma<S>::to_float(acc[i][j][r]), alpha[n], beta[n]);
          const long long o = m * g.Cout + n;
          if constexpr (OUT8) {
            static_cast<int8_t*>(y)[o] = to_int8(v);
          } else {
            static_cast<uint16_t*>(y)[o] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
          }
        }
      }
}

// Launch the one-stage kernel: one block per 128 pixels x 64 channels. `vec`
// selects the 16-byte loads.
template <typename Tag, typename S, int KH, bool OUT8>
int launch(const void* x, const void* wt, const void* alpha, const void* beta, void* y,
           int batch, int H, int W, int Cin, int Cout, int vec, cudaStream_t s) {
  const Geom g = make_geom(batch, H, W, Cin, Cout, KH);
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.Cout + BN - 1) / BN));
  const auto* xp = static_cast<const S*>(x);
  const auto* wp = static_cast<const S*>(wt);
  const auto* ap = static_cast<const float*>(alpha);
  const auto* bp = static_cast<const float*>(beta);
  if (vec)
    conv_fused_kernel<Tag, S, KH, true, OUT8><<<grid, THREADS, 0, s>>>(xp, wp, ap, bp, y, g);
  else
    conv_fused_kernel<Tag, S, KH, false, OUT8><<<grid, THREADS, 0, s>>>(xp, wp, ap, bp, y, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace onestage

// ---- route "sm90": the int8 wgmma loop ---------------------------------------
namespace sm90 {

constexpr int BK8 = 128;       // int8 channels per K step: 128 bytes, as the bf16 loop's
static_assert(BK8 == 2 * BK, "an int8 K step moves the bytes of a bf16 one");

struct ConvI8 {
  const int8_t* x;
  const int8_t* w;             // [Cout, KH*KH*Cin], K-major
  const float* alpha;
  const float* beta;
  void* y;
  long long M;                 // B * Ho * Wo
  long long HoWo;
  int H, W, Wo, Cin, Cout;
  int n_tiles;                 // ceil(Cout / BN); blockIdx.x = m_tile * n_tiles + n_tile
};

// The ring, then alpha and beta of the block's BN output channels.
__host__ __device__ constexpr int i8_smem_bytes(int bm, int bn) {
  return STAGES * stage_bytes(bm, bn) + 2 * bn * 4 + SMEM_ALIGN;
}
__host__ __device__ constexpr int i8_min_blocks(int bm, int bn) {
  return bm == 128 && 2 * i8_smem_bytes(bm, bn) <= SMEM_MAX ? 2 : 1;
}

// fence_acc for the integer accumulators.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk32, s8 x s8 -> s32, A and B from shared memory, both
// K-major (the integer forms take no scale or transpose immediates), D += A *
// B. d holds the warpgroup's 64 x N accumulator tile, N / 2 values per thread,
// in the layout of the f32 forms.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8_step(int (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 64) wgmma_s8_n64(d, a, b);
  else wgmma_s8_n128(d, a, b);
}

template <typename Tag, int BM, int BN, int KH, bool OUT8>
__global__ void __launch_bounds__(threads(BM), i8_min_blocks(BM, BN))
    conv_int8_kernel(const ConvI8 p) {
  static_assert(BM == 128 || BM == 256, "BM");
  static_assert(BN == 64 || BN == 128, "BN");
  static_assert(KH == 2 || KH == 3, "KH");
  constexpr int S = STAGES;
  static_assert(S >= 3, "the ring keeps S - 2 steps in flight");
  static_assert(i8_smem_bytes(BM, BN) <= SMEM_MAX, "the ring fits the card");
  constexpr int THREADS = threads(BM);
  constexpr int RSTEP = THREADS / 8;          // tile rows one pass of the threads copies
  constexpr int A_BYTES = BM * BK8;
  constexpr int STAGE = stage_bytes(BM, BN);
  static_assert(STAGE == (BM + BN) * BK8, "a stage holds one K step of A and B");
  constexpr int OUT_BYTES = OUT8 ? 1 : 2;
  constexpr int LDS = BN * OUT_BYTES + 16;   // epilogue tile row, padded
  static_assert(BM * LDS <= S * STAGE, "the epilogue tile fits the ring");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (SMEM_ALIGN - (raw & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1);
  unsigned char* smem = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  float* s_alpha = reinterpret_cast<float*>(smem + S * STAGE);
  float* s_beta = s_alpha + BN;

  const int tid = threadIdx.x;
  const long long m0 = (long long)(blockIdx.x / p.n_tiles) * BM;
  const int n0 = (blockIdx.x % p.n_tiles) * BN;
  for (int i = tid; i < BN; i += THREADS) {   // published by the loop's first barrier
    const bool ok = n0 + i < p.Cout;
    s_alpha[i] = ok ? p.alpha[n0 + i] : 0.f;
    s_beta[i] = ok ? p.beta[n0 + i] : 0.f;
  }

  // This thread copies 16-byte chunk j (channels 16 j .. 16 j + 15 of the
  // step) of tile rows r0 + RSTEP i; those rows share r0 % 8, so the
  // swizzled chunk is the same for all of them.
  const int j = tid & 7;
  const int r0 = tid >> 3;
  const uint32_t dst = (uint32_t)(r0 * 128 + ((j ^ (r0 & 7)) << 4));
  long long a_off[4];             // byte offset of the pixel's chunk j, -1 past M
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + r0 + RSTEP * i;
    if (m < p.M) {
      const long long b = m / p.HoWo;
      const long long rem = m - b * p.HoWo;
      const long long oy = rem / p.Wo;
      const long long ox = rem - oy * p.Wo;
      a_off[i] = ((b * p.H + oy) * p.W + ox) * p.Cin + j * 16;
    } else {
      a_off[i] = -1;
    }
  }
  constexpr int BROWS = BN / RSTEP;
  static_assert(BROWS * RSTEP == BN, "whole passes over the B tile");
  const long long krow = (long long)KH * KH * p.Cin;
  long long b_off[BROWS];         // byte offset of the weight row's chunk j, -1 past Cout
#pragma unroll
  for (int i = 0; i < BROWS; ++i) {
    const int n = n0 + r0 + RSTEP * i;
    b_off[i] = n < p.Cout ? n * krow + j * 16 : -1;
  }

  // The producer's position: K step `ld` is tap (dy, dx), channels c0..c0+127.
  const int nk = KH * KH * ((p.Cin + BK8 - 1) / BK8);
  int ld = 0, ld_dy = 0, ld_dx = 0, ld_c0 = 0;
  auto prefetch = [&]() {
    if (ld < nk) {
      const uint32_t sa = sbase + (uint32_t)((ld % S) * STAGE) + dst;
      const uint32_t sb = sa + A_BYTES;
      const bool cvalid = ld_c0 + j * 16 < p.Cin;
      const long long a_step = ((long long)ld_dy * p.W + ld_dx) * p.Cin + ld_c0;
      const long long b_step = (long long)(ld_dy * KH + ld_dx) * p.Cin + ld_c0;
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
      ld_c0 += BK8;
      if (ld_c0 >= p.Cin) {
        ld_c0 = 0;
        if (++ld_dx == KH) {
          ld_dx = 0;
          ++ld_dy;
        }
      }
    }
    cp_async_commit();            // one group per step, empty past the last
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

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
    for (int kk = 0; kk < BK8 / 32; ++kk)
      wgmma_s8_step<BN>(acc, desc_sw128(sa + kk * 32), desc_sw128(sb + kk * 32));
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
    const float a0 = s_alpha[col], a1 = s_alpha[col + 1];
    const float b0 = s_beta[col], b1 = s_beta[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = requant(__int2float_rn(acc[4 * c + 2 * h]), a0, b0);
      const float v1 = requant(__int2float_rn(acc[4 * c + 2 * h + 1]), a1, b1);
      unsigned char* q = smem + (row + 8 * h) * LDS + col * OUT_BYTES;
      if constexpr (OUT8) {
        *reinterpret_cast<char2*>(q) = make_char2(to_int8(v0), to_int8(v1));
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

// What the loop takes: Cin a multiple of 16 (16-byte chunks of x and w), Cout
// a multiple of the outputs in one 16-byte store of y.
inline bool i8_channels_ok(int cin, int cout, bool out8) {
  const int ve = out8 ? 16 : 8;
  return cin >= 16 && cin % 16 == 0 && cout >= ve && cout % ve == 0;
}

// Launch the loop with BM x BN blocks: one per M tile and N tile; ring, grid
// and shared memory follow from the template constants.
template <typename Tag, int BM, int BN, int KH, bool OUT8>
int launch_int8(const void* x, const void* w, const void* alpha, const void* beta, void* y,
                int batch, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  ConvI8 p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.alpha = static_cast<const float*>(alpha);
  p.beta = static_cast<const float*>(beta);
  p.y = y;
  p.H = H;
  p.W = W;
  p.Wo = W - KH + 1;
  p.HoWo = (long long)(H - KH + 1) * p.Wo;
  p.M = (long long)batch * p.HoWo;
  p.Cin = Cin;
  p.Cout = Cout;
  p.n_tiles = (Cout + BN - 1) / BN;
  const long long blocks = (p.M + BM - 1) / BM * p.n_tiles;
  if (!i8_channels_ok(Cin, Cout, OUT8) || p.M < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = i8_smem_bytes(BM, BN);
  auto kernel = conv_int8_kernel<Tag, BM, BN, KH, OUT8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(unsigned)blocks, threads(BM), smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The blocks ops/conv_tiles.py::sm90_block picks: 128 x 64 or 256 x 128.
template <typename Tag, int KH, bool OUT8>
int launch_int8_block(const void* x, const void* w, const void* alpha, const void* beta,
                      void* y, int batch, int H, int W, int Cin, int Cout, int bm, int bn,
                      cudaStream_t s) {
  if (bm == 128 && bn == 64)
    return launch_int8<Tag, 128, 64, KH, OUT8>(x, w, alpha, beta, y, batch, H, W, Cin, Cout, s);
  if (bm == 256 && bn == 128)
    return launch_int8<Tag, 256, 128, KH, OUT8>(x, w, alpha, beta, y, batch, H, W, Cin, Cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
}  // namespace
