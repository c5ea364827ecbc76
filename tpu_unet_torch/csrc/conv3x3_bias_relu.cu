// Fused 3x3 valid convolution + bias + ReLU for Hopper (sm_90a), NHWC.
//
// Replaces the TPU kernel tpu_unet/ops/conv_pallas.py::conv3x3_bias_relu
// (both its `_conv3x3_bias_relu_fwd_only` DMA variant and the default
// `conv3x3_bias_relu_slab`): y = relu(conv3x3_valid(x, w) + b), accumulated
// in f32, with bias and ReLU applied before the single store of each output.
//
//   x [B, H, W, Cin], w [3, 3, Cin, Cout] (HWIO), b [Cout]
//   -> y [B, H-2, W-2, Cout], all of one dtype (bf16 or f32), contiguous.
//
// Formulation: an implicit GEMM, not the Pallas grid carried over.
//   M = B*Ho*Wo output pixels, N = Cout, K = 9*Cin with k = (dy*3 + dx)*Cin + c.
// That k is the row index of the HWIO weight read as a row-major [K, Cout]
// matrix, and y read as [M, Cout] is row-major too, so B and C are plain
// matrices. Only A is implicit: for output pixel m = (b, oy, ox) the element
// k sits at base(m) + (dy*W + dx)*Cin + c with base(m) = ((b*H + oy)*W + ox)*Cin.
// The conv is valid, so every pixel inside M reads inside the image; the
// staged tiles are zero-filled only past M (ragged Ho*Wo), past K (Cin = 1
// gives K = 9, under one tensor-core K step) and past Cout. Offsets are
// 64-bit: a batch of 16 tiles of 572^2 holds ~333 M elements per activation.
//
// What bounds it on the H100: at Cin = Cout = 64 one bf16 output pixel does
// 2*9*64*64 = 73.7 kflop per ~256 bytes of input and output, about the
// card's ~295 flop/byte ridge; every deeper layer has more flops per byte.
// So the kernel is tensor-core bound. The design keeps the tensor cores fed
// the simple way: a 128-pixel x 64-channel block tile, so every staged input
// element feeds 64 output channels and every staged weight element 128
// pixels; bf16 goes through the tensor cores (wmma m16n16k16, which lowers
// to mma.sync) into f32 accumulators. f32 inputs take the same tiling with
// f32 FMAs (no TF32), so comparisons in f32 stay meaningful.
// Not yet here: wgmma, TMA loads and a multi-stage shared-memory ring.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int THREADS = 256;  // 8 warps

struct Geom {
  long long M;     // B * Ho * Wo
  long long HoWo;  // Ho * Wo
  int H, W, Wo, Cin, Cout, K;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

// Stage A[m0:m0+BM, k0:k0+BK] into As (row stride LDA). VEC moves 16 bytes
// per load; the caller guarantees Cin is a multiple of the vector width (so a
// vector never straddles two taps) and 16-byte aligned pointers.
template <typename T, int BK, int LDA, bool VEC>
__device__ void load_a(const T* __restrict__ x, const Geom& g, const long long* base,
                       int k0, T* As) {
  if constexpr (VEC) {
    constexpr int VE = 16 / sizeof(T);
    constexpr int VPR = BK / VE;
    for (int v = threadIdx.x; v < BM * VPR; v += THREADS) {
      const int r = v / VPR;
      const int kk = (v - r * VPR) * VE;
      const int k = k0 + kk;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < g.K && base[r] >= 0)
        val = *reinterpret_cast<const uint4*>(x + (base[r] + tap_offset(g, k)));
      *reinterpret_cast<uint4*>(As + r * LDA + kk) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int kk = e - r * BK;
      const int k = k0 + kk;
      T val = from_float<T>(0.f);
      if (k < g.K && base[r] >= 0) val = x[base[r] + tap_offset(g, k)];
      As[r * LDA + kk] = val;
    }
  }
}

// Stage W[k0:k0+BK, n0:n0+BN] into Bs (row stride LDB). VEC needs Cout to be
// a multiple of the vector width.
template <typename T, int BK, int LDB, bool VEC>
__device__ void load_b(const T* __restrict__ w, const Geom& g, int k0, int n0, T* Bs) {
  if constexpr (VEC) {
    constexpr int VE = 16 / sizeof(T);
    constexpr int VPR = BN / VE;
    for (int v = threadIdx.x; v < BK * VPR; v += THREADS) {
      const int r = v / VPR;
      const int nn = (v - r * VPR) * VE;
      const int k = k0 + r;
      const int n = n0 + nn;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < g.K && n < g.Cout)
        val = *reinterpret_cast<const uint4*>(w + ((long long)k * g.Cout + n));
      *reinterpret_cast<uint4*>(Bs + r * LDB + nn) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int nn = e - r * BN;
      const int k = k0 + r;
      const int n = n0 + nn;
      T val = from_float<T>(0.f);
      if (k < g.K && n < g.Cout) val = w[(long long)k * g.Cout + n];
      Bs[r * LDB + nn] = val;
    }
  }
}

// relu(acc + bias) -> y. `v < 0 ? 0 : v` keeps a NaN as torch.relu does.
template <typename T>
__device__ __forceinline__ void store_one(T* __restrict__ y, const T* __restrict__ bias,
                                          const Geom& g, long long m, int n, float acc) {
  if (m < g.M && n < g.Cout) {
    float v = acc + to_float(bias[n]);
    v = v < 0.f ? 0.f : v;
    y[m * g.Cout + n] = from_float<T>(v);
  }
}

// ---------------------------------------------------------------- bf16
constexpr int BK16 = 32;        // two m16n16k16 steps per staged tile
constexpr int LDA16 = BK16 + 8; // padded rows: 80 bytes, 16- and 32-byte aligned
constexpr int LDB16 = BN + 8;   // 144 bytes
constexpr int LDC16 = BN + 4;   // f32 epilogue tile, 272 bytes
constexpr int A16_BYTES = BM * LDA16 * 2;
constexpr int B16_BYTES = BK16 * LDB16 * 2;
constexpr int C16_BYTES = BM * LDC16 * 4;
constexpr int SMEM16 = (A16_BYTES + B16_BYTES > C16_BYTES) ? A16_BYTES + B16_BYTES : C16_BYTES;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_bias_relu_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ w,
                              const __nv_bfloat16* __restrict__ bias,
                              __nv_bfloat16* __restrict__ y, Geom g) {
  using namespace nvcuda;
  // The f32 epilogue tile reuses the operand tiles' memory after the K loop.
  __shared__ __align__(128) unsigned char smem[SMEM16];
  __shared__ long long base[BM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + A16_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4;  // warp tile rows  [wm*32, wm*32+32)
  const int wn = warp / 4;  // warp tile cols  [wn*32, wn*32+32)

  pixel_bases(g, m0, base);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  __syncthreads();

  for (int k0 = 0; k0 < g.K; k0 += BK16) {
    load_a<__nv_bfloat16, BK16, LDA16, VEC>(x, g, base, k0, As);
    load_b<__nv_bfloat16, BK16, LDB16, VEC>(w, g, k0, n0, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * 32 + i * 16) * LDA16 + kk, LDA16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * LDB16 + wn * 32 + j * 16, LDB16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC16 + wn * 32 + j * 16, acc[i][j],
                              LDC16, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN;
    const int c = e - r * BN;
    store_one(y, bias, g, m0 + r, n0 + c, Cs[r * LDC16 + c]);
  }
}

// ---------------------------------------------------------------- f32
constexpr int BK32 = 16;
constexpr int LDA32 = BK32 + 4;  // 80-byte rows keep 16-byte stores aligned
constexpr int LDB32 = BN + 4;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
conv3x3_bias_relu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                             const float* __restrict__ bias, float* __restrict__ y, Geom g) {
  __shared__ __align__(16) float As[BM * LDA32];
  __shared__ __align__(16) float Bs[BK32 * LDB32];
  __shared__ long long base[BM];

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;  // columns tx + 16*j
  const int ty = threadIdx.x / 16;  // rows    ty + 16*i

  pixel_bases(g, m0, base);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < g.K; k0 += BK32) {
    load_a<float, BK32, LDA32, VEC>(x, g, base, k0, As);
    load_b<float, BK32, LDB32, VEC>(w, g, k0, n0, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * LDA32 + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * LDB32 + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_one(y, bias, g, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
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

dim3 grid_for(const Geom& g) {
  return dim3((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.Cout + BN - 1) / BN));
}

}  // namespace

// Plain C interface, bound from Python with ctypes. Each launches on
// `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() so that a refused launch is reported at once.
extern "C" int conv3x3_bias_relu_bf16(const void* x, const void* w, const void* b, void* y,
                                      int batch, int H, int W, int Cin, int Cout, int vec,
                                      void* stream) {
  const Geom g = make_geom(batch, H, W, Cin, Cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (vec)
    conv3x3_bias_relu_bf16_kernel<true><<<grid_for(g), THREADS, 0, s>>>(xp, wp, bp, yp, g);
  else
    conv3x3_bias_relu_bf16_kernel<false><<<grid_for(g), THREADS, 0, s>>>(xp, wp, bp, yp, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int conv3x3_bias_relu_f32(const void* x, const void* w, const void* b, void* y,
                                     int batch, int H, int W, int Cin, int Cout, int vec,
                                     void* stream) {
  const Geom g = make_geom(batch, H, W, Cin, Cout);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* yp = static_cast<float*>(y);
  if (vec)
    conv3x3_bias_relu_f32_kernel<true><<<grid_for(g), THREADS, 0, s>>>(xp, wp, bp, yp, g);
  else
    conv3x3_bias_relu_f32_kernel<false><<<grid_for(g), THREADS, 0, s>>>(xp, wp, bp, yp, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tpu_unet_torch_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
