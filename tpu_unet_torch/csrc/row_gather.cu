// Row gather for Hopper (sm_90a): out[n, :] = src[idx[n], :].
//
// Replaces the three Pallas kernels of scripts/tpu_gather_probe.py::main,
// which compute this one function by three mechanisms: `k_take` (jnp.take
// inside the kernel), `k_vecidx` (vector ref indexing) and `k_rowloop` (a
// scalar-prefetched fori_loop of one-row copies). The semantics are
// jnp.take's default: an index in [-N, 0) counts from the end, and an index
// outside [-N, N) reads NaN, so no address outside src is ever formed.
//
// What bounds it on the H100: it does no arithmetic, so bytes. A random
// row costs at least one 32-byte sector to read, so the least traffic is
// max(4C, 32) bytes read and 4C written per row, plus the index.
//
// The design: a group of G lanes (G a power of two, the smallest that
// covers the row's vectors, at most 32) owns one output row; a warp holds
// 32 / G rows. The group's first lane reads the index once and hands it to
// the others with a shuffle. Each lane then copies 16 bytes at a time
// (float4) when C % 4 == 0 and the base pointers and src's row stride allow
// it, else one float at a time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename TI, bool VEC>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const float* __restrict__ src, const TI* __restrict__ idx,
                  float* __restrict__ out, long long n, long long m, int c,
                  long long src_stride, int group_log2) {
  const int G = 1 << group_log2;
  const long long row = ((long long)blockIdx.x * THREADS + threadIdx.x) >> group_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  // the group's first lane reads the index; the whole warp takes part in
  // the shuffle, rows past m included
  long long v = 0;
  if (sub == 0 && row < m) v = (long long)idx[row];
  v = __shfl_sync(0xffffffffu, v, lane & ~(G - 1));
  if (row >= m) return;
  if (v < 0) v += n;
  const bool ok = v >= 0 && v < n;
  if (VEC) {
    const int cv = c >> 2;
    const float4* s = reinterpret_cast<const float4*>(src + (ok ? v : 0) * src_stride);
    float4* o = reinterpret_cast<float4*>(out + row * c);
    const float4 nan4 = make_float4(NAN, NAN, NAN, NAN);
    for (int j = sub; j < cv; j += G) o[j] = ok ? __ldg(s + j) : nan4;
  } else {
    const float* s = src + (ok ? v : 0) * src_stride;
    float* o = out + row * c;
    for (int j = sub; j < c; j += G) o[j] = ok ? __ldg(s + j) : NAN;
  }
}

template <typename TI>
int launch(const void* src, const void* idx, void* out, long long n, long long m, int c,
           long long src_stride, int vec, cudaStream_t s) {
  const int units = vec ? c / 4 : c;       // vectors (or floats) per row
  int group_log2 = 0;
  while ((1 << group_log2) < units && group_log2 < 5) ++group_log2;
  const long long rows_per_block = THREADS >> group_log2;
  const long long blocks = (m + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const float* sp = static_cast<const float*>(src);
  const TI* ip = static_cast<const TI*>(idx);
  float* op = static_cast<float*>(out);
  if (vec)
    row_gather_kernel<TI, true><<<(unsigned)blocks, THREADS, 0, s>>>(sp, ip, op, n, m, c,
                                                                     src_stride, group_log2);
  else
    row_gather_kernel<TI, false><<<(unsigned)blocks, THREADS, 0, s>>>(sp, ip, op, n, m, c,
                                                                      src_stride, group_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound from Python with ctypes: launches on `stream`,
// does not synchronise, returns cudaGetLastError() (or cudaErrorInvalidValue
// for arguments it does not take). src f32 [n, c] with row stride
// `src_stride` (elements; unit column stride); idx [m] int32 (idx_i64 0) or
// int64; out f32 [m, c] contiguous. `vec` asks for 16-byte copies: the
// caller sets it only when c and src_stride are multiples of 4 and src and
// out are 16-byte aligned.
extern "C" int row_gather_f32(const void* src, const void* idx, int idx_i64, void* out,
                              long long n, long long m, int c, long long src_stride, int vec,
                              void* stream) {
  if (n < 1 || m < 0 || c < 1 || src_stride < c || (vec && (c % 4 || src_stride % 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx_i64 ? launch<long long>(src, idx, out, n, m, c, src_stride, vec, s)
                 : launch<int32_t>(src, idx, out, n, m, c, src_stride, vec, s);
}
