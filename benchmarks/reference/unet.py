"""The plain U-Net of Ronneberger et al. 2015 (arXiv:1505.04597, Fig. 1)
in PyTorch float32, the benchmark's reference. It imports nothing of the
program.

23 layers: per level two 3x3 valid convs with ReLU and a 2x2 max-pool, two
bottleneck convs, per level a 2x2 stride-2 up-conv, a centre-cropped skip
concatenated before it ([skip, up]) and two 3x3 convs, then a 1x1 head. NHWC
input [B, H, W, 1], f32 logits [B, h, w, 2] out. The weights are named as
the program's state_dict names them (``enc0_conv1.weight``, OIHW; the
up-convs' ``[Cin, Cout, 2, 2]``).

`quant(name, role, t)` is applied to each conv's input (role 'x'), weight
(role 'w') and output after its ReLU (role 'y') when given: the control
runs the same network in a lower precision through it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Quant = Callable[[str, str, torch.Tensor], torch.Tensor]


def widths(mcfg: dict):
    return [mcfg["base_width"] * mcfg.get("width_mult", 1) * 2 ** i
            for i in range(mcfg["depth"] + 1)]


def layer_shapes(mcfg: dict) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """{layer: (weight shape, fan-in kernel area)} in forward order."""
    w, depth = widths(mcfg), mcfg["depth"]
    out = {}
    for d in range(depth):
        cin = mcfg["in_channels"] if d == 0 else w[d - 1]
        out[f"enc{d}_conv1"] = ((w[d], cin, 3, 3), 9 * cin)
        out[f"enc{d}_conv2"] = ((w[d], w[d], 3, 3), 9 * w[d])
    out["bottleneck_conv1"] = ((w[depth], w[depth - 1], 3, 3), 9 * w[depth - 1])
    out["bottleneck_conv2"] = ((w[depth], w[depth], 3, 3), 9 * w[depth])
    for d in reversed(range(depth)):
        out[f"up{d}"] = ((w[d + 1], w[d], 2, 2), 4 * w[d + 1])
        out[f"dec{d}_conv1"] = ((w[d], 2 * w[d], 3, 3), 9 * 2 * w[d])
        out[f"dec{d}_conv2"] = ((w[d], w[d], 3, 3), 9 * w[d])
    out["head"] = ((mcfg["num_classes"], w[0], 1, 1), w[0])
    return out


#: The biases' spread: small against the activations, so that a bias the
#: program dropped or doubled still shows in the logits.
BIAS_STD = 0.05


def make_params(mcfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights from `seed`: one normal draw on the device,
    cut into He-normal kernels (std sqrt(2 / fan-in)) and biases of std
    `BIAS_STD`; f32, keyed by the program's state_dict names."""
    shapes = layer_shapes(mcfg)
    sizes = []
    for name, (shape, _) in shapes.items():
        sizes += [math.prod(shape), shape[1] if name.startswith("up") else shape[0]]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for name, (shape, fan_in) in shapes.items():
        n = math.prod(shape)
        out[f"{name}.weight"] = flat[off:off + n].reshape(shape) * math.sqrt(2.0 / fan_in)
        off += n
        nb = shape[1] if name.startswith("up") else shape[0]
        out[f"{name}.bias"] = flat[off:off + nb] * BIAS_STD
        off += nb
    return out


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN convs and matmuls while the reference runs."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def center_crop(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Centre crop of NCHW `x` to h x w (offsets int((H - h) / 2))."""
    y0, x0 = int((x.shape[2] - h) * 0.5), int((x.shape[3] - w) * 0.5)
    return x[:, :, y0:y0 + h, x0:x0 + w]


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, mcfg: dict,
            quant: Optional[Quant] = None,
            capture: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """x [B, H, W, 1] f32 -> logits [B, h, w, C] f32. `capture` receives
    every 3x3 conv's output after its ReLU, every up-conv's output and the
    head's, by layer name (NHWC), and each conv's input under
    ``<name>:in`` (NCHW)."""
    q = quant or (lambda name, role, t: t)

    def conv(name, t, relu=True):
        wgt, b = params[f"{name}.weight"], params[f"{name}.bias"]
        if capture is not None:
            capture[f"{name}:in"] = t
        y = F.conv2d(q(name, "x", t), q(name, "w", wgt), b)
        y = q(name, "y", F.relu(y)) if relu else y
        if capture is not None:
            capture[name] = y.permute(0, 2, 3, 1)
        return y

    depth = mcfg["depth"]
    t = x.float().permute(0, 3, 1, 2)
    skips = []
    for d in range(depth):
        t = conv(f"enc{d}_conv2", conv(f"enc{d}_conv1", t))
        skips.append(t)
        t = F.max_pool2d(t, 2)
    t = conv("bottleneck_conv2", conv("bottleneck_conv1", t))
    for d in reversed(range(depth)):
        name = f"up{d}"
        t = F.conv_transpose2d(q(name, "x", t), q(name, "w", params[f"{name}.weight"]),
                               params[f"{name}.bias"], stride=2)
        if capture is not None:
            capture[name] = t.permute(0, 2, 3, 1)
        t = torch.cat([center_crop(skips[d], t.shape[2], t.shape[3]), t], dim=1)
        t = conv(f"dec{d}_conv2", conv(f"dec{d}_conv1", t))
    return conv("head", t, relu=False).permute(0, 2, 3, 1)


def forward_blocks(params, x: torch.Tensor, mcfg: dict, block: int,
                   quant: Optional[Quant] = None) -> torch.Tensor:
    """`forward` over `x` in blocks of `block` tiles, with no autograd."""
    with torch.no_grad():
        return torch.cat([forward(params, x[i:i + block], mcfg, quant)
                          for i in range(0, x.shape[0], block)])
