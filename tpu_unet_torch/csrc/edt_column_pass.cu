// Column pass of the exact Euclidean distance transform for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_unet/ops/edt_pallas.py::column_pass_pallas
// (its exact `_col_pass_kernel` and its `_col_pass_banded_kernel`):
//
//   D2[p, i, j] = min_r  g2[p, r, j] + (i - r)^2
//
// over f32 planes g2 [P, H, W] (squared distances along each row, +inf where
// a row holds no object). Exact pass: r runs over every row. Banded pass
// (band >= 0): only |i - r| <= band counts, and a candidate whose d^2 =
// (i - r)^2 exceeds band^2 is masked out, as the Pallas kernel masks it.
// Planes are grouped by batch: plane p = b * planes_per_batch + k is live iff
// k < num_valid[b], read from device memory (num_valid == nullptr: all live).
// A dead plane writes +inf and does nothing else, so there is no host sync.
//
// Every finite value is an integer below 2^24 (row and column offsets of a
// plane of a few hundred pixels), so each sum and minimum is exact in f32 and
// the result is bit-identical to the plain version in any order.
//
// What bounds it on the H100: each output element reads one g2 element and
// writes one D2 element (8 bytes) and does one add, one compare-select and
// one min per source row in reach. Banded at band 40: 81 rows, about 160
// flop per 8 bytes, near the card's f32 ridge (67 TFLOP/s over 3.35 TB/s,
// ~20 flop/byte). Exact at H = 388: 388 rows, compute-bound.
//
// Design: columns are independent, so a block owns a (plane, strip of 32
// columns, 64 output rows) tile. One warp spans the strip, so every global
// load and store of a row is one coalesced 128-byte line. The source rows
// that can reach the tile (its rows +- band, clipped to the plane; the whole
// column for the exact pass) are staged through shared memory in chunks of
// 128 rows, so each g2 element is read from device memory once per tile.
// Each thread keeps 8 consecutive output rows in registers: one shared load
// feeds 8 add-min pairs, which keeps the kernel on the ALUs rather than on
// shared-memory bandwidth. Rows outside the plane are never loaded, which is
// what the Pallas kernel's +inf padding stood for.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                                // columns per block: one warp
constexpr int kWarps = 8;                                // warps per block
constexpr int kRowsPerThread = 8;                        // output rows in registers
constexpr int kTileRows = kWarps * kRowsPerThread;       // 64 output rows per block
constexpr int kChunk = 128;                              // source rows staged at a time

__global__ void __launch_bounds__(kCols * kWarps)
edt_column_pass_kernel(const float* __restrict__ g2, const int* __restrict__ num_valid,
                       float* __restrict__ out, int planes_per_batch, int h, int w,
                       int band, int col_blocks, int row_blocks) {
  __shared__ float tile[kChunk][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  long long bid = blockIdx.x;
  const int cb = static_cast<int>(bid % col_blocks);
  bid /= col_blocks;
  const int rb = static_cast<int>(bid % row_blocks);
  const long long plane = bid / row_blocks;
  const int j = cb * kCols + tx;
  const int i0 = rb * kTileRows;
  const int ib = i0 + ty * kRowsPerThread;                // this thread's first row
  const size_t base = static_cast<size_t>(plane) * h * w;

  bool live = true;
  if (num_valid != nullptr) {
    const long long b = plane / planes_per_batch;
    live = static_cast<int>(plane % planes_per_batch) < num_valid[b];
  }

  float acc[kRowsPerThread];
#pragma unroll
  for (int l = 0; l < kRowsPerThread; ++l) acc[l] = CUDART_INF_F;

  if (live) {  // uniform over the block: the barriers below are safe
    int r_lo = 0, r_hi = h;
    float band2 = CUDART_INF_F;
    if (band >= 0) {
      r_lo = max(0, i0 - band);
      r_hi = min(h, i0 + kTileRows + band);
      band2 = static_cast<float>(band) * static_cast<float>(band);
    }
    for (int c0 = r_lo; c0 < r_hi; c0 += kChunk) {
      const int n = min(kChunk, r_hi - c0);
      __syncthreads();                                    // the last chunk is consumed
      for (int r = ty; r < n; r += kWarps)
        tile[r][tx] = j < w ? g2[base + static_cast<size_t>(c0 + r) * w + j] : CUDART_INF_F;
      __syncthreads();
      int lo = 0, hi = n;                                 // rows this warp can use
      if (band >= 0) {
        lo = max(0, ib - band - c0);
        hi = min(n, ib + kRowsPerThread + band - c0);
      }
      for (int r = lo; r < hi; ++r) {
        const float s = tile[r][tx];
        const float d0 = static_cast<float>(ib - (c0 + r));
#pragma unroll
        for (int l = 0; l < kRowsPerThread; ++l) {
          const float d = d0 + static_cast<float>(l);
          const float dd = d * d;
          acc[l] = fminf(acc[l], dd <= band2 ? s + dd : CUDART_INF_F);
        }
      }
    }
  }

  if (j < w) {
#pragma unroll
    for (int l = 0; l < kRowsPerThread; ++l) {
      const int i = ib + l;
      if (i < h) out[base + static_cast<size_t>(i) * w + j] = acc[l];
    }
  }
}

}  // namespace

// g2, out: [planes, h, w] f32 contiguous on the device; num_valid: int32
// [planes / planes_per_batch] on the device, or null (every plane live);
// band < 0 runs the exact pass. Launches on `stream` and returns
// cudaGetLastError() so that a refused launch is reported at once.
extern "C" int edt_column_pass_f32(const void* g2, const void* num_valid, void* out,
                                   long long planes, int planes_per_batch, int h, int w,
                                   int band, void* stream) {
  const int col_blocks = (w + kCols - 1) / kCols;
  const int row_blocks = (h + kTileRows - 1) / kTileRows;
  const long long blocks = planes * col_blocks * row_blocks;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  edt_column_pass_kernel<<<static_cast<unsigned>(blocks), dim3(kCols, kWarps), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g2), static_cast<const int*>(num_valid),
      static_cast<float*>(out), planes_per_batch, h, w, band, col_blocks, row_blocks);
  return static_cast<int>(cudaGetLastError());
}
