"""tpu_unet_torch — the PyTorch and CUDA port of tpu_unet, for an NVIDIA
H100. It imports no JAX; the JAX package `tpu_unet` is its reference.

Layering (mirrors tpu_unet):
  csrc/      hand-written CUDA C++ kernels for Hopper (sm_90a)
  ops/       the kernels' wrappers and plain versions, their build, padding
  models/    the U-Net as an nn.Module, with the JAX package's layer names
  data/      host ingest for serving, synthetic fixture datasets
  losses/    IoU / pixel error
  infer/     overlap-tile inference engine, evaluation entry point, export
  convert    JAX params and reference .pth files -> the port's state_dict

Shared with tpu_unet (they import no JAX): config.ModelConfig,
core.geometry, convert.NAME_MAP and its layout transforms, native.
"""

__version__ = "0.1.0"
