"""Carry weights into `tpu_unet_torch.models.UNet`.

The port's layers take the JAX package's names (``enc0_conv1`` ... ``head``)
in PyTorch's layouts, so:

* a JAX parameter tree converts with the layout transforms below (the
  transposed convs keep their spatial flip) and keeps its names;
* a reference ``.pth`` state_dict is already in PyTorch's layouts and is only
  renamed, through ``NAME_MAP``.

``NAME_MAP`` and the transforms are the port's own copies of those in
``tpu_unet/convert.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# reference layer name -> (the JAX package's and the port's layer name,
# is_transpose)
NAME_MAP: Dict[str, tuple] = {
    "conv11c": ("enc0_conv1", False), "conv12c": ("enc0_conv2", False),
    "conv21c": ("enc1_conv1", False), "conv22c": ("enc1_conv2", False),
    "conv31c": ("enc2_conv1", False), "conv32c": ("enc2_conv2", False),
    "conv41c": ("enc3_conv1", False), "conv42c": ("enc3_conv2", False),
    "conv51c": ("bottleneck_conv1", False), "conv52c": ("bottleneck_conv2", False),
    "upconv4": ("up3", True),
    "conv41e": ("dec3_conv1", False), "conv42e": ("dec3_conv2", False),
    "upconv3": ("up2", True),
    "conv31e": ("dec2_conv1", False), "conv32e": ("dec2_conv2", False),
    "upconv2": ("up1", True),
    "conv21e": ("dec1_conv1", False), "conv22e": ("dec1_conv2", False),
    "upconv1": ("up0", True),
    "conv11e": ("dec0_conv1", False), "conv12e": ("dec0_conv2", False),
    "finalconv": ("head", False),
}


def kernel_to_conv_weight(k: np.ndarray) -> np.ndarray:
    """JAX [kH, kW, I, O] -> torch Conv2d [O, I, kH, kW]."""
    return np.transpose(k, (3, 2, 0, 1))


def kernel_to_convtranspose_weight(k: np.ndarray) -> np.ndarray:
    """JAX ConvTranspose [kH, kW, I, O] (spatially flipped relative to
    torch's) -> torch ConvTranspose2d [I, O, kH, kW]."""
    return np.transpose(np.ascontiguousarray(k[::-1, ::-1]), (2, 3, 0, 1))


def conv_weight_to_kernel(w: np.ndarray) -> np.ndarray:
    """torch Conv2d [O, I, kH, kW] -> JAX [kH, kW, I, O]."""
    return np.transpose(w, (2, 3, 1, 0))


def convtranspose_weight_to_kernel(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d [I, O, kH, kW] -> JAX ConvTranspose
    [kH, kW, I, O] with the spatial flip."""
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]


def _is_transpose(name: str) -> bool:
    return name.startswith("up")


def state_dict_from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``{'params': {...}}`` (or the inner dict), leaves numpy arrays ->
    the port's state_dict (f32 tensors)."""
    p = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in p.items():
        k = np.asarray(leaf["kernel"], np.float32)
        w = (kernel_to_convtranspose_weight(k) if _is_transpose(name)
             else kernel_to_conv_weight(k))
        sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        sd[f"{name}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], np.float32))
    return sd


def params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, dict]:
    """Inverse of `state_dict_from_jax_params`: the port's state_dict -> a
    JAX-layout ``{'params': {name: {'kernel', 'bias'}}}`` tree of f32 numpy
    arrays."""
    p: Dict[str, dict] = {}
    for key, value in sd.items():
        name, _, kind = key.rpartition(".")
        a = value.detach().cpu().float().numpy()
        if kind == "weight":
            a = (convtranspose_weight_to_kernel(a) if _is_transpose(name)
                 else conv_weight_to_kernel(a))
            p.setdefault(name, {})["kernel"] = np.ascontiguousarray(a)
        else:
            p.setdefault(name, {})["bias"] = a
    return {"params": p}


def state_dict_from_reference(sd: Mapping[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """Rename a reference U-Net state_dict (``conv11c`` ... ``finalconv``)
    to the port's layer names; the layouts already match."""
    out: Dict[str, torch.Tensor] = {}
    for ref_name, (name, _) in NAME_MAP.items():
        for suffix in ("weight", "bias"):
            key = f"{ref_name}.{suffix}"
            if key not in sd:
                raise KeyError(f"missing {key} in state_dict — not a reference "
                               f"U-Net checkpoint?")
            out[f"{name}.{suffix}"] = torch.as_tensor(sd[key])
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` state_dict as the port's state_dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return state_dict_from_reference(sd)
