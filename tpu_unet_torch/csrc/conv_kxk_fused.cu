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
// The kernels, what bounds them and their design are K3's, in conv_fused.cuh,
// at KH = 2 or 3, on the same two routes (ops/conv_kxk.py::conv_kxk_route
// picks): "sm90", the int8 wgmma loop (Cin and Cout multiples of 16, 16-byte
// aligned x), and "simple", the one-stage mma.sync kernel. At the path's
// packed 256 -> 256 convs the kernel is tensor-core bound (1024 op/byte,
// above the card's ~590 int8 op/byte ridge). The packed kernel is 9/16 dense;
// the kernel multiplies the zero taps as the TPU kernels do (skipping them
// is later work). The TPU kernels' XLA-gathered slabs and VMEM im2col scratch
// have no counterpart: the blocks compute their own offsets.

#include "conv_fused.cuh"

namespace {
// Names the k x k kernel's instances (kernel names carry it; a profile
// groups by it).
struct conv_kxk_fused_tag {};
using Tag = conv_kxk_fused_tag;
}  // namespace

// Plain C interface, bound from Python with ctypes. Each launches on
// `stream` (a cudaStream_t), does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for a kernel size other than 2
// or 3, or a shape or block the kernel does not take) so that a refused
// launch is reported at once.

// Route "simple"; `vec` selects the 16-byte loads.
extern "C" int conv_kxk_fused_s8(const void* x, const void* wt, const void* alpha,
                                 const void* beta, void* y, int batch, int H, int W,
                                 int Cin, int Cout, int kh, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh == 2)
    return onestage::launch<Tag, uint8_t, 2, true>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                   Cout, vec, s);
  if (kh == 3)
    return onestage::launch<Tag, uint8_t, 3, true>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                   Cout, vec, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Route "sm90": wt 16-byte aligned; `bm` x `bn` the block (128 x 64 or 256 x
// 128, as ops/conv_tiles.py::sm90_block picks).
extern "C" int conv_kxk_fused_sm90(const void* x, const void* wt, const void* alpha,
                                   const void* beta, void* y, int batch, int H, int W,
                                   int Cin, int Cout, int kh, int bm, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh == 2)
    return sm90::launch_int8_block<Tag, 2, true>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                 Cout, bm, bn, s);
  if (kh == 3)
    return sm90::launch_int8_block<Tag, 3, true>(x, wt, alpha, beta, y, batch, H, W, Cin,
                                                 Cout, bm, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
