"""Operations and bytes of the U-Net's work, from its shapes, and the
published peaks of one NVIDIA H100 (SXM, dense, at its 700 W limit).

A call's bound is the larger of its bytes over the memory rate and its
operations over the peak rate of their type. Each input byte is counted
read once and each output byte written once, whatever a kernel reads again.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    """The least seconds the card could take for `nbytes` and `ops`."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def conv_cost(batch: int, h: int, w: int, cin: int, cout: int, in_bytes: int,
              out_bytes: int, vec_bytes: int) -> Tuple[int, int]:
    """(bytes, operations) of one 3x3 valid conv with a per-channel epilogue,
    x [batch, h, w, cin] -> [batch, h-2, w-2, cout]; `vec_bytes` per output
    channel for its epilogue vectors (a bias, or alpha and beta)."""
    out_px = batch * (h - 2) * (w - 2)
    nbytes = (batch * h * w * cin * in_bytes + 9 * cin * cout * in_bytes
              + vec_bytes * cout + out_px * cout * out_bytes)
    return nbytes, 2 * out_px * 9 * cin * cout


def unet_shapes(widths: Sequence[int], size: int, in_channels: int = 1
                ) -> Tuple[List[Tuple[int, int, int]], List[Tuple[int, int, int]], int]:
    """The U-Net's layers on a size x size input: ([(input side, cin, cout)]
    of the 3x3 convs in forward order, [(input side, cin, cout)] of the 2x2
    up-convs, the output side). `widths` has depth + 1 entries."""
    depth = len(widths) - 1
    s, cin, convs, ups = size, in_channels, [], []
    for d in range(depth):
        convs += [(s, cin, widths[d]), (s - 2, widths[d], widths[d])]
        s, cin = (s - 4) // 2, widths[d]
    convs += [(s, cin, widths[-1]), (s - 2, widths[-1], widths[-1])]
    s -= 4
    for d in reversed(range(depth)):
        ups.append((s, widths[d + 1], widths[d]))
        s *= 2
        convs += [(s, 2 * widths[d], widths[d]), (s - 2, widths[d], widths[d])]
        s -= 4
    return convs, ups, s


def forward_flops(widths: Sequence[int], size: int, in_channels: int = 1,
                  num_classes: int = 2) -> int:
    """Operations of one forward pass over one size x size tile: the 3x3
    convs, the up-convs and the 1x1 head (300.86 GFLOP at 572, 64 wide)."""
    convs, ups, out = unet_shapes(widths, size, in_channels)
    f = sum(2 * 9 * ci * co * (s - 2) ** 2 for s, ci, co in convs)
    f += sum(2 * ci * co * 4 * s * s for s, ci, co in ups)
    return f + 2 * widths[0] * num_classes * out * out
