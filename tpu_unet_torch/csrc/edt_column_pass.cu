// Column pass of the exact Euclidean distance transform for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_unet/ops/edt_pallas.py::column_pass_pallas
// (its exact `_col_pass_kernel` and its `_col_pass_banded_kernel`):
//
//   D2[p, i, j] = min_r  g2[p, r, j] + (i - r)^2
//
// over f32 planes g2 [P, H, W] (squared distances along each row, +inf where
// a row holds no object). Exact pass: r runs over every row. Banded pass
// (band >= 0): only |i - r| <= band counts, as the Pallas kernel masks it.
// Planes are grouped by batch: plane p = b * planes_per_batch + k is live iff
// k < num_valid[b], read from device memory (num_valid == nullptr: all live).
// A dead plane writes +inf and does nothing else, so there is no host sync.
//
// What bounds it on the H100: each output element reads one g2 element and
// writes one D2 element (8 bytes) and does one add and one min per source
// row in reach. Banded at band 40: 81 rows, 162 operations per 8 bytes, near
// the card's f32 ridge (67 TFLOP/s over 3.35 TB/s, ~20 per byte). Exact at
// H = 388: 388 rows, bound by operations. With few live planes (the weight
// map's usual case) the dead planes' +inf stores are most of the bytes.
//
// Two routes, one file:
//
// "simple" (edt_column_pass_f32, the first kernel): a block owns a (plane,
// strip of 32 columns, 64 output rows) tile; each thread keeps 8 output
// rows and walks the source rows in reach, spending six instructions per
// candidate (the offset, its square, the band compare, the add, a select and
// the min). Dead planes are written 4 bytes at a time, tile by tile.
//
// "sm90" (edt_column_pass_sm90): tiles of the same kind, offset-major. For each
// offset d the square d*d is computed once, and the thread's 8 outputs i =
// ib + l take g2[i + d] + d*d from a register window of 8 staged rows that
// slides one row per offset: one shared-memory load per offset, unrolled by
// 8 so that each row stays in its register while it is in the window. Rows
// outside the plane are staged as +inf (the Pallas kernel's padding), so
// the band needs no mask: the loop runs over offsets -band..band (the exact
// pass over the tile's whole offset range). g2 holds squares (each +0,
// positive or +inf), so every sum is a non-negative float, and those order
// as their bit patterns do as int32: the loop takes the plain version's f32
// sums (__fadd_rn, so that nvcc cannot contract d*d into an FMA) and their
// minimum on the integer pipe, where ptxas folds two candidates into one
// 3-input VIMNMX3: 1.5 instructions per candidate, the adds on the FMA
// pipe. The result equals the plain version bit for bit. (Hopper's DPX
// add-min, __viaddmin_s32 on int32 codes of the squares, was the first
// design: CUDA 12.8's header writes it as add.s32 + min.s32, and ptxas
// turned those into IMAD + VIMNMX3, with no VIADDMNMX in the sweep, and
// that loop ran slower than an f32 add and FMNMX per candidate on the
// H100; PERF.md.)
// The tile height (8 rows a warp, 4 to 8 warps) is the one that covers H
// with the fewest idle rows (7 warps at H = 388). A dead plane's blocks
// write it as one run of 16-byte stores (scalar stores for the few floats
// before the first 16-byte boundary and after the last).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

// ---- route "simple" ---------------------------------------------------------

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

// ---- route "sm90" -----------------------------------------------------------

namespace {
namespace sm90 {

constexpr int kCols = 32;                    // columns per block: one warp
constexpr int kRows = 8;                     // output rows per thread = the window
constexpr int kMaxWarps = 8;
constexpr int kMinWarps = 4;
constexpr int kMaxStage = 384;               // source rows staged at a time (48 KB)

// One dead plane's share of +inf: part `part` of `parts` blocks, 16-byte
// stores from the first 16-byte boundary of the plane, scalar stores around.
__device__ void fill_dead(float* o, size_t hw, int part, int parts, int tid, int nthreads) {
  const float inf = CUDART_INF_F;
  size_t head = ((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) / 4;
  if (head > hw) head = hw;
  const size_t nvec = (hw - head) / 4;
  float4* v = reinterpret_cast<float4*>(o + head);
  const float4 inf4 = make_float4(inf, inf, inf, inf);
  const size_t stride = static_cast<size_t>(parts) * nthreads;
  for (size_t q = static_cast<size_t>(part) * nthreads + tid; q < nvec; q += stride) v[q] = inf4;
  if (part == 0) {
    for (size_t e = tid; e < head; e += nthreads) o[e] = inf;
    for (size_t e = head + nvec * 4 + tid; e < hw; e += nthreads) o[e] = inf;
  }
}

// One candidate: the sum of a staged row and d*d, into the running minimum
// of the sums' bit patterns.
__device__ __forceinline__ int step(float s, float dd, int acc) {
  return min(acc, __float_as_int(__fadd_rn(s, dd)));
}

// Windows u .. u + count - 1 of staged rows s[0 ..] (s points at window u's
// first row, this thread's column): window u holds rows u .. u + 7 and meets
// output row ib + l at offset d = u - ib, d0 for the first. The offset is
// carried as a float (exact: |d| < 2^24), so no int-to-float conversion, a
// quarter-rate instruction, runs per offset.
__device__ __forceinline__ void sweep(const float* s, int count, int d0, int (&acc)[kRows]) {
  float win[kRows];                          // row u + l sits in win[(u + l) % 8]
#pragma unroll
  for (int l = 0; l < kRows - 1; ++l) win[l] = s[l * kCols];
  float d = static_cast<float>(d0);
  int k = 0;
  for (; k + kRows <= count; k += kRows) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      win[(q + kRows - 1) % kRows] = s[(k + q + kRows - 1) * kCols];
      const float dd = __fmul_rn(d, d);      // as the plain version's off * off
      d += 1.0f;
#pragma unroll
      for (int l = 0; l < kRows; ++l) acc[l] = step(win[(q + l) % kRows], dd, acc[l]);
    }
  }
#pragma unroll
  for (int q = 0; q < kRows - 1; ++q) {
    if (k + q < count) {
      win[(q + kRows - 1) % kRows] = s[(k + q + kRows - 1) * kCols];
      const float dd = __fmul_rn(d, d);      // as the plain version's off * off
      d += 1.0f;
#pragma unroll
      for (int l = 0; l < kRows; ++l) acc[l] = step(win[(q + l) % kRows], dd, acc[l]);
    }
  }
}

__global__ void __launch_bounds__(kCols * kMaxWarps)
column_pass_kernel(const float* __restrict__ g2, const int* __restrict__ num_valid,
                   float* __restrict__ out, int planes_per_batch, int h, int w, int band,
                   int col_blocks, int row_blocks, int stage_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);   // [stage_rows][kCols]
  const int tx = threadIdx.x, ty = threadIdx.y, nw = blockDim.y;
  long long bid = blockIdx.x;
  const int cb = static_cast<int>(bid % col_blocks);
  bid /= col_blocks;
  const int rb = static_cast<int>(bid % row_blocks);
  const long long plane = bid / row_blocks;
  const size_t hw = static_cast<size_t>(h) * w;
  float* o = out + static_cast<size_t>(plane) * hw;
  if (num_valid != nullptr &&
      static_cast<int>(plane % planes_per_batch) >= num_valid[plane / planes_per_batch]) {
    fill_dead(o, hw, rb * col_blocks + cb, row_blocks * col_blocks, ty * kCols + tx,
              nw * kCols);
    return;                                  // the whole block: no barrier is skipped
  }
  const int tile = nw * kRows;
  const int i0 = rb * tile, ib = i0 + ty * kRows;
  const int j = cb * kCols + tx;
  // Windows [U0, U1) feed the block, [u0, u1) this warp: a window whose 8
  // rows all lie outside the plane adds only +inf and is skipped.
  int U0 = -(kRows - 1), U1 = h, u0 = U0, u1 = U1;
  if (band >= 0) {
    U0 = max(U0, i0 - band);
    U1 = min(U1, i0 + tile - kRows + band + 1);
    u0 = max(u0, ib - band);
    u1 = min(u1, ib + band + 1);
  }
  if (ib >= h) u1 = u0;                      // this warp's rows lie past the plane
  int acc[kRows];                            // bit patterns of non-negative floats
#pragma unroll
  for (int l = 0; l < kRows; ++l) acc[l] = __float_as_int(CUDART_INF_F);
  const float* col = g2 + static_cast<size_t>(plane) * hw + j;
  for (int c = U0; c < U1; c += stage_rows - (kRows - 1)) {
    const int n = min(stage_rows, U1 + kRows - 1 - c);   // stage rows [c, c + n)
    __syncthreads();                         // the last chunk is consumed
#pragma unroll 4
    for (int r = ty; r < n; r += nw) {
      const int row = c + r;
      stage[r * kCols + tx] =
          j < w && row >= 0 && row < h ? col[static_cast<size_t>(row) * w] : CUDART_INF_F;
    }
    __syncthreads();
    const int ua = max(u0, c), ub = min(u1, c + n - (kRows - 1));
    if (ua < ub) sweep(stage + (ua - c) * kCols + tx, ub - ua, ua - ib, acc);
  }
  if (j < w) {
#pragma unroll
    for (int l = 0; l < kRows; ++l)
      if (ib + l < h) o[static_cast<size_t>(ib + l) * w + j] = __int_as_float(acc[l]);
  }
}

int launch(const void* g2, const void* num_valid, void* out, long long planes,
           int planes_per_batch, int h, int w, int band, cudaStream_t stream) {
  if (band > h) band = h;                    // the same pass, and no int overflow
  int warps = kMaxWarps;
  long long idle = -1;
  for (int k = kMaxWarps; k >= kMinWarps; --k) {
    const long long t = static_cast<long long>(k) * kRows;
    const long long waste = (h + t - 1) / t * t - h;
    if (idle < 0 || waste < idle) idle = waste, warps = k;
  }
  const int tile = warps * kRows;
  const int col_blocks = (w + kCols - 1) / kCols;
  const int row_blocks = (h + tile - 1) / tile;
  const long long blocks = planes * col_blocks * row_blocks;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  long long need = static_cast<long long>(h) + 2 * (kRows - 1);   // rows a block stages
  if (band >= 0) need = std::min(need, static_cast<long long>(tile) + 2LL * band);
  const int stage_rows = static_cast<int>(std::min(need, static_cast<long long>(kMaxStage)));
  const size_t smem = static_cast<size_t>(stage_rows) * kCols * sizeof(float);
  column_pass_kernel<<<static_cast<unsigned>(blocks), dim3(kCols, warps), smem, stream>>>(
      static_cast<const float*>(g2), static_cast<const int*>(num_valid),
      static_cast<float*>(out), planes_per_batch, h, w, band, col_blocks, row_blocks,
      stage_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace

// Route "sm90": the arguments of edt_column_pass_f32, for g2 of squares
// (each +0, positive or +inf).
extern "C" int edt_column_pass_sm90(const void* g2, const void* num_valid, void* out,
                                    long long planes, int planes_per_batch, int h, int w,
                                    int band, void* stream) {
  return sm90::launch(g2, num_valid, out, planes, planes_per_batch, h, w, band,
                      static_cast<cudaStream_t>(stream));
}
