// Fused 3x3 valid convolution + per-channel scale + bias + ReLU (+ int8
// requantize) for Hopper (sm_90a), NHWC: K3 of the port.
//
// Replaces the TPU kernel tpu_unet/ops/conv_tiles.py::conv3x3_fused (all four
// of its MXU-feeding variants, `taps`, `nconcat`, `rows3` and `im2col`):
//
//   acc = conv3x3_valid(x, w)        int8 x int8 -> int32, or bf16 x bf16 -> f32
//   v   = relu(acc * alpha[c] + beta[c])     in f32, multiply then add, each
//                                            rounded (no FMA contraction)
//   y   = clamp(rint(v), 0, 127) as int8     (out_int8; rint: half to even)
//         or v rounded to bf16
//
//   x [B, H, W, Cin], w as wt [Cout, 9*Cin] (the HWIO kernel read as a
//   [9*Cin, Cout] matrix, transposed by the wrapper), alpha, beta f32 [Cout]
//   -> y [B, H-2, W-2, Cout], all contiguous.
//
// Formulation: an implicit GEMM, as K1 (csrc/conv3x3_bias_relu.cu):
//   M = B*Ho*Wo output pixels, N = Cout, K = 9*Cin, k = (dy*3 + dx)*Cin + c.
// For output pixel m = (b, oy, ox) element k of its receptive field sits at
// base(m) + (dy*W + dx)*Cin + c, base(m) = ((b*H + oy)*W + ox)*Cin; every pixel
// inside M reads inside the image, so the staged tiles are zero-filled only
// past M, past K and past Cout. Offsets are 64-bit.
//
// What bounds it on the H100: the int8 layers of a 572^2 serving tile do
// 2*9*Cin*Cout operations per output pixel against Cin + Cout bytes in and
// out (at Cin = Cout = 128: 295 kop per 256 bytes, 1152 op/byte, twice the
// card's ~590 int8 op/byte ridge, and more at every deeper layer), so K3 is
// tensor-core bound at every int8 shape of the main path. The design feeds the tensor cores with
// mma.sync (m16n8k32 s8 -> s32, m16n8k16 bf16 -> f32): a 128-pixel x
// 64-channel block tile of 8 warps, each warp 32 x 32, K staged 64 bytes at a
// time. Staged rows are K-contiguous for both operands, so each 32-bit
// fragment register is one shared-memory load; rows are padded to 80 bytes,
// which puts the 32 lanes of a fragment load on 32 different banks. The
// epilogue is applied to the accumulators in registers before the one store
// of each output.
// Not yet here: a multi-stage cp.async ring, wgmma and TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
__device__ __forceinline__ long long tap_offset(const Geom& g, int k) {
  const int tap = k / g.Cin;
  const int c = k - tap * g.Cin;
  const int dy = tap / 3;
  const int dx = tap - dy * 3;
  return ((long long)dy * g.W + dx) * g.Cin + c;
}

// Stage A[m0:m0+BM, k0:k0+BKB/sizeof(S)] into As, one pixel per row. VEC
// moves 16 bytes per load; the caller guarantees Cin*sizeof(S) is a multiple
// of 16 (so a vector never straddles two taps or the end of K) and 16-byte
// aligned pointers.
template <typename S, bool VEC>
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
        val = *reinterpret_cast<const uint4*>(x + (base[r] + tap_offset(g, k)));
      *reinterpret_cast<uint4*>(As + r * LDS + kk * E) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BM * BKE; e += THREADS) {
      const int r = e / BKE;
      const int kk = e - r * BKE;
      const int k = k0 + kk;
      S val = 0;
      if (k < g.K && base[r] >= 0) val = x[base[r] + tap_offset(g, k)];
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

template <typename S, bool VEC, bool OUT8>
__global__ void __launch_bounds__(THREADS)
conv3x3_fused_kernel(const S* __restrict__ x, const S* __restrict__ wt,
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
    load_a<S, VEC>(x, g, base, k0, As);
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
          float v = __fadd_rn(__fmul_rn(Mma<S>::to_float(acc[i][j][r]), alpha[n]), beta[n]);
          v = v < 0.f ? 0.f : v;  // ReLU; keeps a NaN, as torch.relu does
          const long long o = m * g.Cout + n;
          if constexpr (OUT8) {
            static_cast<int8_t*>(y)[o] = (int8_t)(int)fminf(rintf(v), 127.f);
          } else {
            static_cast<uint16_t*>(y)[o] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
          }
        }
      }
}

Geom make_geom(int batch, int H, int W, int Cin, int Cout) {
  Geom g;
  g.H = H;
  g.W = W;
  g.Wo = W - 2;
  g.Cin = Cin;
  g.Cout = Cout;
  g.K = 9 * Cin;
  g.HoWo = (long long)(H - 2) * (W - 2);
  g.M = (long long)batch * g.HoWo;
  return g;
}

template <typename S>
int launch(const void* x, const void* wt, const void* alpha, const void* beta, void* y,
           int batch, int H, int W, int Cin, int Cout, int out_int8, int vec,
           void* stream) {
  const Geom g = make_geom(batch, H, W, Cin, Cout);
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.Cout + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const S*>(x);
  const auto* wp = static_cast<const S*>(wt);
  const auto* ap = static_cast<const float*>(alpha);
  const auto* bp = static_cast<const float*>(beta);
  if (vec && out_int8)
    conv3x3_fused_kernel<S, true, true><<<grid, THREADS, 0, s>>>(xp, wp, ap, bp, y, g);
  else if (vec)
    conv3x3_fused_kernel<S, true, false><<<grid, THREADS, 0, s>>>(xp, wp, ap, bp, y, g);
  else if (out_int8)
    conv3x3_fused_kernel<S, false, true><<<grid, THREADS, 0, s>>>(xp, wp, ap, bp, y, g);
  else
    conv3x3_fused_kernel<S, false, false><<<grid, THREADS, 0, s>>>(xp, wp, ap, bp, y, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound from Python with ctypes. Each launches on
// `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported at once.
// `out_int8` selects the int8 store, else bf16; `vec` the 16-byte loads.
extern "C" int conv3x3_fused_s8(const void* x, const void* wt, const void* alpha,
                                const void* beta, void* y, int batch, int H, int W,
                                int Cin, int Cout, int out_int8, int vec, void* stream) {
  return launch<uint8_t>(x, wt, alpha, beta, y, batch, H, W, Cin, Cout, out_int8, vec,
                         stream);
}

extern "C" int conv3x3_fused_bf16(const void* x, const void* wt, const void* alpha,
                                  const void* beta, void* y, int batch, int H, int W,
                                  int Cin, int Cout, int out_int8, int vec, void* stream) {
  return launch<uint16_t>(x, wt, alpha, beta, y, batch, H, W, Cin, Cout, out_int8, vec,
                          stream);
}
