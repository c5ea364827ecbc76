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
// The kernels, what bounds them and their design are in conv_fused.cuh,
// shared with the k x k int8 conv (conv_kxk_fused.cu). K3 takes them at KH =
// 3 on two routes, which ops/conv_tiles.py::conv3x3_fused_route picks: "sm90",
// the int8 wgmma loop (int8 x, Cin a multiple of 16, Cout a multiple of 16
// for int8 out or 8 for bf16 out, 16-byte aligned x), and "simple", the
// one-stage mma.sync kernel (bf16 inputs, the rest).

#include "conv_fused.cuh"

namespace {
// Names K3's instances (kernel names carry it; a profile groups by it).
struct conv3x3_fused_tag {};
using Tag = conv3x3_fused_tag;
}  // namespace

// Plain C interface, bound from Python with ctypes. Each launches on
// `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or block the
// kernel does not take) so that a refused launch is reported at once.
// `out_int8` selects the int8 store, else bf16.

// Route "simple"; `vec` selects the 16-byte loads.
extern "C" int conv3x3_fused_s8(const void* x, const void* wt, const void* alpha,
                                const void* beta, void* y, int batch, int H, int W,
                                int Cin, int Cout, int out_int8, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_int8)
    return onestage::launch<Tag, uint8_t, 3, true>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                   Cout, vec, s);
  return onestage::launch<Tag, uint8_t, 3, false>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                  Cout, vec, s);
}

extern "C" int conv3x3_fused_bf16(const void* x, const void* wt, const void* alpha,
                                  const void* beta, void* y, int batch, int H, int W,
                                  int Cin, int Cout, int out_int8, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_int8)
    return onestage::launch<Tag, uint16_t, 3, true>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                    Cout, vec, s);
  return onestage::launch<Tag, uint16_t, 3, false>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                   Cout, vec, s);
}

// Route "sm90": int8 x and wt, 16-byte aligned; `bm` x `bn` the block
// (128 x 64 or 256 x 128, as ops/conv_tiles.py::sm90_block picks).
extern "C" int conv3x3_fused_sm90(const void* x, const void* wt, const void* alpha,
                                  const void* beta, void* y, int batch, int H, int W,
                                  int Cin, int Cout, int out_int8, int bm, int bn,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_int8)
    return sm90::launch_int8_block<Tag, 3, true>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                 Cout, bm, bn, s);
  return sm90::launch_int8_block<Tag, 3, false>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                Cout, bm, bn, s);
}
