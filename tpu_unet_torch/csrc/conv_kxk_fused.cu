// Fused k x k int8 valid convolution (k = 2 or 3) + per-channel scale + bias +
// ReLU + int8 requantize for Hopper (sm_90a), NHWC: the port's kernel for
// the packed 2x2 int8 convs of the phase-packed level 0.
//
// Replaces the two TPU kernels of scripts/tpu_deep_shootout_r4.py, which
// compute one function:
//   conv2x2_fused  (:111, kernel _k2 :78; variants im2col4 and rows2)
//   conv_rows3_col (:184, kernel _k3col :164; kh = w.shape[0] in {2, 3})
//
//   acc = conv_kxk_valid(x, w)           int8 x int8 -> int32
//   v   = relu(acc * alpha[c] + beta[c]) in f32, multiply then add, each
//                                        rounded (no FMA contraction)
//   y   = clamp(rint(v), 0, 127) as int8 (rint: half to even)
//
//   x [B, H, W, Cin] int8, w as wt [Cout, KH*KH*Cin] (the HWIO kernel read as
//   a [KH*KH*Cin, Cout] matrix, transposed by the wrapper), alpha, beta f32
//   [Cout] -> y [B, H-KH+1, W-KH+1, Cout] int8, all contiguous.
//
// Formulation: an implicit GEMM, as K3 (csrc/conv3x3_fused.cu):
//   M = B*Ho*Wo output pixels, N = Cout, K = KH*KH*Cin,
//   k = (dy*KH + dx)*Cin + c (tap-major, the HWIO order).
// Output pixel m = (b, oy, ox) reads element k of its receptive field at
// base(m) + (dy*W + dx)*Cin + c, base(m) = ((b*H + oy)*W + ox)*Cin; every
// pixel inside M reads inside the image, so the staged tiles are zero-filled
// only past M, past K and past Cout (the ragged edges: Ho = 284, 194, 674 are
// no multiple of anything). Offsets are 64-bit.
//
// What bounds it on the H100: the packed level-0 convs do 2*4*Cin*Cout
// operations per output pixel against Cin + Cout bytes in and out (at the
// path's Cin = Cout = 256: 524 kop per 512 bytes, 1024 op/byte, above the
// card's ~590 int8 op/byte ridge), so it is tensor-core bound: 0.342 ms for
// the packed enc0_conv2 of a 16-tile chunk at 1979 TOP/s, 0.160 ms for
// dec0_conv2. The packed kernel is 9/16 dense; the kernel multiplies the zero
// taps as the TPU kernels do (skipping them is later work). The design is
// K3's: mma.sync m16n8k32 s8 -> s32 on a 128-pixel x 64-channel block tile of
// 8 warps (32 x 32 each), K staged 64 bytes at a time, rows padded to 80 bytes
// so that the 32 lanes of a fragment load hit 32 banks, the epilogue applied
// to the accumulators in registers before the one store of each output. The
// TPU kernels' XLA-gathered slabs and VMEM im2col scratch have no counterpart:
// the block computes its own offsets. Not yet here: a multi-stage cp.async
// ring, wgmma and TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output pixels per block
constexpr int BN = 64;         // output channels per block
constexpr int THREADS = 256;   // 8 warps: 4 (pixels) x 2 (channels) of 32 x 32
constexpr int BK = 64;         // bytes (= int8 elements) of K staged per step
constexpr int LDS = BK + 16;   // staged row stride in bytes

struct Geom {
  long long M;     // B * Ho * Wo
  long long HoWo;  // Ho * Wo
  int H, W, Wo, Cin, Cout, K;
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

// Stage A[m0:m0+BM, k0:k0+BK] into As, one pixel per row. VEC moves 16 bytes
// per load; the caller guarantees Cin % 16 == 0 (so a vector never straddles
// two taps or the end of K) and 16-byte aligned pointers.
template <int KH, bool VEC>
__device__ void load_a(const int8_t* __restrict__ x, const Geom& g, const long long* base,
                       int k0, unsigned char* As) {
  if constexpr (VEC) {
    constexpr int VPR = BK / 16;
    for (int v = threadIdx.x; v < BM * VPR; v += THREADS) {
      const int r = v / VPR;
      const int kk = (v - r * VPR) * 16;
      const int k = k0 + kk;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < g.K && base[r] >= 0)
        val = *reinterpret_cast<const uint4*>(x + (base[r] + tap_offset<KH>(g, k)));
      *reinterpret_cast<uint4*>(As + r * LDS + kk) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int kk = e - r * BK;
      const int k = k0 + kk;
      int8_t val = 0;
      if (k < g.K && base[r] >= 0) val = x[base[r] + tap_offset<KH>(g, k)];
      reinterpret_cast<int8_t*>(As + r * LDS)[kk] = val;
    }
  }
}

// Stage wt[n0:n0+BN, k0:k0+BK] into Bs, one output channel per row.
template <bool VEC>
__device__ void load_b(const int8_t* __restrict__ wt, const Geom& g, int k0, int n0,
                       unsigned char* Bs) {
  if constexpr (VEC) {
    constexpr int VPR = BK / 16;
    for (int v = threadIdx.x; v < BN * VPR; v += THREADS) {
      const int r = v / VPR;
      const int kk = (v - r * VPR) * 16;
      const int n = n0 + r;
      const int k = k0 + kk;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < g.Cout && k < g.K)
        val = *reinterpret_cast<const uint4*>(wt + ((long long)n * g.K + k));
      *reinterpret_cast<uint4*>(Bs + r * LDS + kk) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BN * BK; e += THREADS) {
      const int r = e / BK;
      const int kk = e - r * BK;
      const int n = n0 + r;
      const int k = k0 + kk;
      int8_t val = 0;
      if (n < g.Cout && k < g.K) val = wt[(long long)n * g.K + k];
      reinterpret_cast<int8_t*>(Bs + r * LDS)[kk] = val;
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int KH, bool VEC>
__global__ void __launch_bounds__(THREADS)
conv_kxk_fused_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                      const float* __restrict__ alpha, const float* __restrict__ beta,
                      int8_t* __restrict__ y, Geom g) {
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
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  __syncthreads();

  for (int k0 = 0; k0 < g.K; k0 += BK) {
    load_a<KH, VEC>(x, g, base, k0, As);
    load_b<VEC>(wt, g, k0, n0, Bs);
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {
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
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
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
          float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][r]), alpha[n]), beta[n]);
          v = v < 0.f ? 0.f : v;  // ReLU; keeps a NaN, as torch.relu does
          y[m * g.Cout + n] = (int8_t)(int)fminf(rintf(v), 127.f);
        }
      }
}

template <int KH>
void launch(const int8_t* x, const int8_t* wt, const float* alpha, const float* beta,
            int8_t* y, const Geom& g, int vec, cudaStream_t s) {
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.Cout + BN - 1) / BN));
  if (vec)
    conv_kxk_fused_kernel<KH, true><<<grid, THREADS, 0, s>>>(x, wt, alpha, beta, y, g);
  else
    conv_kxk_fused_kernel<KH, false><<<grid, THREADS, 0, s>>>(x, wt, alpha, beta, y, g);
}

}  // namespace

// Plain C interface, bound from Python with ctypes. Launches on `stream` (a
// cudaStream_t), does not synchronise, and returns cudaGetLastError() so that
// a refused launch is reported at once (cudaErrorInvalidValue for a kernel
// size other than 2 or 3). `vec` selects the 16-byte loads.
extern "C" int conv_kxk_fused_s8(const void* x, const void* wt, const void* alpha,
                                 const void* beta, void* y, int batch, int H, int W,
                                 int Cin, int Cout, int kh, int vec, void* stream) {
  if (kh != 2 && kh != 3) return static_cast<int>(cudaErrorInvalidValue);
  Geom g;
  g.H = H;
  g.W = W;
  g.Wo = W - kh + 1;
  g.Cin = Cin;
  g.Cout = Cout;
  g.K = kh * kh * Cin;
  g.HoWo = (long long)(H - kh + 1) * g.Wo;
  g.M = (long long)batch * g.HoWo;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(wt);
  const auto* ap = static_cast<const float*>(alpha);
  const auto* bp = static_cast<const float*>(beta);
  auto* yp = static_cast<int8_t*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh == 2)
    launch<2>(xp, wp, ap, bp, yp, g, vec, s);
  else
    launch<3>(xp, wp, ap, bp, yp, g, vec, s);
  return static_cast<int>(cudaGetLastError());
}
