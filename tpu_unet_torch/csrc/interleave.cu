// Batch<->channel pairing copies for Hopper (sm_90a): K6a-c of the port.
//
// Replaces the TPU kernels of tpu_unet/ops/interleave.py:
//   mode 0  pair_batch_channels    [B, H, W, C]    -> [B/2, H, W, 2C], out[i] = x[i] || x[i+B/2]
//   mode 1  unpair_batch_channels  [B/2, H, W, 2C] -> [B, H, W, C], its inverse
//   mode 2  interleave_pairs       a, b [B/2, H, W, 2C] -> [B/2, H, W, 4C], channels [a0, b0, a1, b1]
//
// Every output pixel is S segments of `seg` bytes (C channels of the element
// size): S = 2, 1 and 4 in the three modes. A segment is a contiguous run of
// its source pixel, so each copy reads and writes whole runs; the dtype does
// not matter. The output is contiguous; the inputs need only their (W, C)
// dims packed: the batch and row strides come in bytes, so a center-cropped
// view is read in place.
//
// What bounds it on the H100: it moves every byte twice (one read, one
// write) and computes nothing, so memory bandwidth (3.35 TB/s). The design:
// one block row per output image row (blockIdx.x = ob*H + y, so no 64-bit
// division per element), one thread per 16-byte unit of that row (uint4 loads
// and stores, neighbouring threads on neighbouring addresses) where the
// segment, the strides and the pointers are multiples of 16 bytes, and one
// thread per byte otherwise. The TPU kernel's row blocking (`_row_block`,
// sized for VMEM) has no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Copy {
  const unsigned char* a;
  const unsigned char* b;
  unsigned char* out;
  long long a_sb, a_sy, b_sb, b_sy;  // batch and row strides of a and b, bytes
  int nb, H, W;                      // output batch, rows, columns
  int seg;                           // bytes of one segment
  int mode;
  int units_per_seg, units_per_pixel, units_per_row;
  long long row_bytes;
};

template <typename U>
__global__ void __launch_bounds__(THREADS) interleave_copy_kernel(Copy c) {
  const int r = blockIdx.y * THREADS + threadIdx.x;  // unit of the output row
  if (r >= c.units_per_row) return;
  const int row = blockIdx.x;                        // ob * H + y
  const int ob = row / c.H;
  const int y = row - ob * c.H;
  const int x = r / c.units_per_pixel;
  const int rem = r - x * c.units_per_pixel;
  const int s = rem / c.units_per_seg;               // output segment
  const int k = rem - s * c.units_per_seg;
  const unsigned char* src = c.a;
  long long sb = c.a_sb, sy = c.a_sy;
  int batch = ob, pixel = 2 * c.seg, choff = 0;
  if (c.mode == 0) {          // pair: segment s from image ob + s*B/2
    batch = ob + s * c.nb;
    pixel = c.seg;
  } else if (c.mode == 1) {   // unpair: image ob from half ob / (B/2) of pair ob % (B/2)
    const int hb = c.nb >> 1;
    batch = ob % hb;
    choff = (ob / hb) * c.seg;
  } else {                    // interleave: [a0, b0, a1, b1]
    if (s & 1) {
      src = c.b;
      sb = c.b_sb;
      sy = c.b_sy;
    }
    choff = (s >> 1) * c.seg;
  }
  const U* p = reinterpret_cast<const U*>(src + batch * sb + y * sy + (long long)x * pixel +
                                          choff) + k;
  U* o = reinterpret_cast<U*>(c.out + (long long)row * c.row_bytes) + r;
  *o = *p;
}

}  // namespace

// Plain C interface, bound from Python with ctypes: launches on `stream`
// (a cudaStream_t), does not synchronise, and returns cudaGetLastError().
// `vec` selects the 16-byte units; the caller guarantees `seg`, the strides
// and the pointers are then multiples of 16.
extern "C" int interleave_copy(int mode, const void* a, const void* b, void* out,
                               long long a_sb, long long a_sy, long long b_sb, long long b_sy,
                               int nb, int H, int W, int seg, int vec, void* stream) {
  if (mode < 0 || mode > 2 || nb < 1 || H < 1 || W < 1 || seg < 1 || (mode == 1 && nb % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Copy c;
  c.a = static_cast<const unsigned char*>(a);
  c.b = static_cast<const unsigned char*>(b);
  c.out = static_cast<unsigned char*>(out);
  c.a_sb = a_sb;
  c.a_sy = a_sy;
  c.b_sb = b_sb;
  c.b_sy = b_sy;
  c.nb = nb;
  c.H = H;
  c.W = W;
  c.seg = seg;
  c.mode = mode;
  const int segs = mode == 0 ? 2 : (mode == 1 ? 1 : 4);
  const int unit = vec ? 16 : 1;
  c.units_per_seg = seg / unit;
  c.units_per_pixel = segs * c.units_per_seg;
  c.row_bytes = (long long)W * segs * seg;
  if (c.row_bytes / unit > 65535LL * THREADS || (long long)nb * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  c.units_per_row = static_cast<int>(c.row_bytes / unit);
  const dim3 grid((unsigned)(nb * H), (unsigned)((c.units_per_row + THREADS - 1) / THREADS));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    interleave_copy_kernel<uint4><<<grid, THREADS, 0, st>>>(c);
  else
    interleave_copy_kernel<unsigned char><<<grid, THREADS, 0, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}
