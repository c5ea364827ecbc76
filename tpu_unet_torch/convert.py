"""Carry weights into `tpu_unet_torch.models.UNet`.

The port's layers take the JAX package's names (``enc0_conv1`` ... ``head``)
in PyTorch's layouts, so:

* a JAX parameter tree converts with the shared layout transforms of
  ``tpu_unet/convert.py`` (the transposed convs keep their spatial flip) and
  keeps its names;
* a reference ``.pth`` state_dict is already in PyTorch's layouts and is only
  renamed, through the shared ``NAME_MAP``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from tpu_unet.convert import (NAME_MAP, kernel_to_conv_weight,
                              kernel_to_convtranspose_weight)


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
