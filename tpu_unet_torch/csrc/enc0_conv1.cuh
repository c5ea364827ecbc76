// The conv1 producer of the level-0 encoder chain, shared by K4's sm90
// route (enc0_chain.cu) and the Mosaic probes' conv1 stage
// (enc0_stages.cu):
//
//   h1 = bf16(relu(sum_t x_t * w9[t] + b))   taps t = 3*dy + dx, in that order
//
// per output value: acc = 0, acc = fmaf(x_t, w_t, acc) for t = 0..8, then
// __fadd_rn(acc, b) (one rounding), ReLU as `v < 0 ? 0 : v` (which keeps a
// NaN), one bf16 rounding. These are the numerics of the kernels it
// replaced, so h1 is bit for bit what they computed.
//
// A thread owns one group of 8 output channels and a run of adjacent pixels
// of R adjacent h1 rows (conv1_rows). Its 72 weights and 8 biases are loaded
// once into registers; the run's R + 2 input rows are read once (N + 2
// values each, from global memory through L1, or from a patch the caller
// staged in shared memory), each value serving every h1 row it touches, and
// the thread hands back one 16-byte chunk (8 bf16) per pixel. The callers
// give adjacent lanes adjacent channel groups of a pixel, so 8 lanes (C =
// 64) store one whole 128-byte pixel row.
// Everything here has internal linkage.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace enc0 {

// The tap weights w[t][k] and biases b[k] of output channels c0 + k.
struct Conv1Group {
  float w[9][8];
  float b[8];
};

// w9 f32 [9, C] (tap-major), b f32 [C], both 16-byte aligned; c0 a
// multiple of 8 below C, C a multiple of 8 (so every row is 32-byte
// aligned).
__device__ __forceinline__ void load_group(Conv1Group& g, const float* __restrict__ w9,
                                           const float* __restrict__ b, int C, int c0) {
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(w9 + t * C + c0));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(w9 + t * C + c0 + 4));
    g.w[t][0] = lo.x; g.w[t][1] = lo.y; g.w[t][2] = lo.z; g.w[t][3] = lo.w;
    g.w[t][4] = hi.x; g.w[t][5] = hi.y; g.w[t][6] = hi.z; g.w[t][7] = hi.w;
  }
  const float4 lo = __ldg(reinterpret_cast<const float4*>(b + c0));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(b + c0 + 4));
  g.b[0] = lo.x; g.b[1] = lo.y; g.b[2] = lo.z; g.b[3] = lo.w;
  g.b[4] = hi.x; g.b[5] = hi.y; g.b[6] = hi.z; g.b[7] = hi.w;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One pixel's 8 channels from its 3x3 window xw[3*dy + dx].
__device__ __forceinline__ uint4 conv1_chunk(const Conv1Group& g, const float (&xw)[9]) {
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = fmaf(xw[t], g.w[t][k], acc[k]);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float v = __fadd_rn(acc[k], g.b[k]);
    acc[k] = v < 0.f ? 0.f : v;
  }
  return make_uint4(pack_bf16x2(acc[0], acc[1]), pack_bf16x2(acc[2], acc[3]),
                    pack_bf16x2(acc[4], acc[5]), pack_bf16x2(acc[6], acc[7]));
}

template <typename TX> __device__ __forceinline__ float load_x(const TX* p);
template <> __device__ __forceinline__ float load_x<float>(const float* p) { return __ldg(p); }
// bf16 x, as its bit pattern
template <> __device__ __forceinline__ float load_x<uint16_t>(const uint16_t* p) {
  return __uint_as_float((uint32_t)__ldg(p) << 16);
}

// A run of N adjacent pixels of R adjacent h1 rows. xat(r, j) is input
// row r = 0 .. R+1 (h1 row q reads rows q .. q+2), column j = 0 .. N+1 of
// the run, 0 where there is none. The window slides one column per step:
// R + 2 new values serve the R pixels of the column, whose 8 R sums are
// interleaved, so the FMA units see 8 R independent chains (each sum is
// still conv1_chunk's, taps in order). Calls emit(q, i, chunk) for h1 row
// q = 0 .. R-1 and i = 0 .. N-1; which of them lie inside the image is the
// caller's to decide.
template <int N, int R, typename XAt, typename Emit>
__device__ __forceinline__ void conv1_rows(const Conv1Group& g, XAt&& xat, Emit&& emit) {
  float win[R + 2][3];
#pragma unroll
  for (int r = 0; r < R + 2; ++r) {
    win[r][0] = xat(r, 0);
    win[r][1] = xat(r, 1);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int r = 0; r < R + 2; ++r) win[r][2] = xat(r, i + 2);
    float acc[R][8];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[q][k] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[q][k] = fmaf(win[q + t / 3][t % 3], g.w[t][k], acc[q][k]);
#pragma unroll
    for (int q = 0; q < R; ++q) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float v = __fadd_rn(acc[q][k], g.b[k]);
        acc[q][k] = v < 0.f ? 0.f : v;
      }
      emit(q, i, make_uint4(pack_bf16x2(acc[q][0], acc[q][1]), pack_bf16x2(acc[q][2], acc[q][3]),
                            pack_bf16x2(acc[q][4], acc[q][5]), pack_bf16x2(acc[q][6], acc[q][7])));
    }
#pragma unroll
    for (int r = 0; r < R + 2; ++r) {
      win[r][0] = win[r][1];
      win[r][1] = win[r][2];
    }
  }
}

}  // namespace enc0
}  // namespace
