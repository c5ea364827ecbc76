"""Multi-head attention for the port's transformer layers
(`models.transunet`): softmax(q k^T / sqrt(d)) v over [B, H, N, d].

On the card it is ``F.scaled_dot_product_attention``, whose fused kernels
keep the softmax's sums in float32; on the CPU the same call. The model
calls it through its own module attribute, so a wrapper set there from
outside sees every call while the count here stays with the function."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v: [B, H, N, d] -> [B, H, N, d]. Every call
    counts in ``attention.launches``."""
    attention.launches += 1
    return F.scaled_dot_product_attention(q, k, v)


#: Calls of `attention` since the count was last set to 0.
attention.launches = 0
