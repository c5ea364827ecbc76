"""tpu_unet_torch — the PyTorch and CUDA port of tpu_unet, for an NVIDIA
H100. It imports no JAX; the JAX package `tpu_unet` is its reference.

Layering (mirrors tpu_unet):
  csrc/      hand-written CUDA C++ kernels for Hopper (sm_90a), one for
             each Pallas kernel of tpu_unet and of its probe scripts
  ops/       the kernels' wrappers, plain versions and K1's gradient, their
             build; EDT, connected components, warps, padding, phase
             packing
  models/    the U-Net as an nn.Module, with the JAX package's layer names
  data/      host ingest, synthetic fixture datasets, augmentation
  losses/    weighted BCE, weight maps, IoU / pixel error
  infer/     overlap-tile inference engine, evaluation entry point, export,
             int8 serving
  probes/    kernel timings on the card at fixed shapes
  train/     trainer, optimizer and plateau scheduler, checkpoints,
             progress curves, folds
  config     the configuration dataclasses and dataset presets
  core/      valid-conv size arithmetic and the overlap-tile planner
  convert    JAX params and reference .pth files -> the port's state_dict
  native     ctypes binding of the host C++ ground-truth preprocessing

It imports nothing of tpu_unet: config, core.geometry and convert's name map
and layout transforms are the port's own copies of the JAX package's.
"""

__version__ = "0.1.0"
