"""The plain TransUNet R50-ViT-B/16 (Chen et al. 2021, arXiv:2102.04306) in
PyTorch float32, the benchmark's reference for its TransUNet cells. It
imports nothing of the program.

It follows the official code (github.com/Beckschen/TransUNet,
``networks/vit_seg_modeling.py``, ``vit_seg_modeling_resnet_skip.py``,
``vit_seg_configs.py::get_r50_b16_config``): a ResNet-50 v2 trunk of
weight-standardised convs (biased variance, eps 1e-5) each followed by
GroupNorm(32, eps 1e-6) (a projection by GroupNorm(C, C), eps 1e-5), the
7x7 stride-2 root, the 3x3 stride-2 max-pool with padding 0, the stride on
each unit's 3x3 conv, the skips zero-padded at the bottom and right to
``img_size / 4 / (i + 1)``, a one-channel slice repeated to 3 channels; the
1x1 patch conv plus the position table, pre-LN ViT blocks (LN eps 1e-6,
softmax(q k^T / sqrt(d)) v, exact GELU) and the final LN; the decoder's
conv (no bias) + BatchNorm (eps 1e-5, running statistics) + ReLU layers,
the x2 bilinear upsample with align_corners=True, the concat [up, skip],
the 3x3 head. Left out: dropout (inference).

The configuration is a dict of ``img_size``, ``in_channels``,
``num_classes``, ``hidden``, ``heads``, ``layers``, ``mlp``,
``resnet_units``, ``decoder_channels``, ``n_skip``; the weights are named as
the official state_dict (and the program) names them. NHWC input [B, S, S,
1] in, float32 NHWC logits out.

`quant(name, role, t)` is applied to every conv's and linear's input (role
'x') and weight (role 'w', after the standardisation) when given: the
control runs the same network in a lower precision through it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Quant = Callable[[str, str, torch.Tensor], torch.Tensor]

WIDTH = 64
TRUNK = "transformer.embeddings.hybrid_model."

#: The draws' spreads: norms' and BatchNorms' scales 1 + NORM_SPREAD * N,
#: their shifts and running means NORM_SPREAD * N, running variances
#: exp(2 * NORM_SPREAD * N); conv and linear biases BIAS_STD * N; the
#: position table POS_STD * N, as large as the tokens it is added to, so
#: that a table left out shows in the logits. Each bottleneck unit's last
#: GroupNorm (``gn3``) scales by RESIDUAL_SCALE * (1 + NORM_SPREAD * N), a
#: residual branch started small as in a zero-initialised one (Goyal et al.
#: 2017): at scale 1 the 16 units of random weights are chaotic, and the
#: trunk's output in bfloat16 is a third off its float32 value, which
#: leaves the tokens nothing a comparison can hold; at 0.1 it is 2% off.
NORM_SPREAD = 0.1
RESIDUAL_SCALE = 0.1
BIAS_STD = 0.05
POS_STD = 1.0


def param_shapes(m: dict) -> Dict[str, tuple]:
    """{state_dict name: shape} in forward order."""
    out: Dict[str, tuple] = {}

    def norm(name, c):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c,), (c,)

    out[TRUNK + "root.conv.weight"] = (WIDTH, 3, 7, 7)
    norm(TRUNK + "root.gn", WIDTH)
    cin = WIDTH
    for s, units in enumerate(m["resnet_units"], 1):
        mid, cout = WIDTH * 2 ** (s - 1), WIDTH * 2 ** (s + 1)
        for u in range(1, units + 1):
            p = f"{TRUNK}body.block{s}.unit{u}."
            out[p + "conv1.weight"] = (mid, cin, 1, 1)
            norm(p + "gn1", mid)
            out[p + "conv2.weight"] = (mid, mid, 3, 3)
            norm(p + "gn2", mid)
            out[p + "conv3.weight"] = (cout, mid, 1, 1)
            norm(p + "gn3", cout)
            if u == 1:
                out[p + "downsample.weight"] = (cout, cin, 1, 1)
                norm(p + "gn_proj", cout)
            cin = cout
    h = m["hidden"]
    e = "transformer.embeddings."
    out[e + "patch_embeddings.weight"] = (h, cin, 1, 1)
    out[e + "patch_embeddings.bias"] = (h,)
    out[e + "position_embeddings"] = (1, (m["img_size"] // 16) ** 2, h)
    for i in range(m["layers"]):
        p = f"transformer.encoder.layer.{i}."
        norm(p + "attention_norm", h)
        for lin in ("query", "key", "value", "out"):
            out[f"{p}attn.{lin}.weight"], out[f"{p}attn.{lin}.bias"] = (h, h), (h,)
        norm(p + "ffn_norm", h)
        out[p + "ffn.fc1.weight"], out[p + "ffn.fc1.bias"] = (m["mlp"], h), (m["mlp"],)
        out[p + "ffn.fc2.weight"], out[p + "ffn.fc2.bias"] = (h, m["mlp"]), (h,)
    norm("transformer.encoder.encoder_norm", h)

    def conv_bn(name, ci, co):
        out[f"{name}.0.weight"] = (co, ci, 3, 3)
        for k in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.1.{k}"] = (co,)

    conv_bn("decoder.conv_more", h, 512)
    skips = [c if i < m["n_skip"] else 0 for i, c in enumerate((8 * WIDTH, 4 * WIDTH, WIDTH, 0))]
    ci = 512
    for i, (co, sk) in enumerate(zip(m["decoder_channels"], skips)):
        conv_bn(f"decoder.blocks.{i}.conv1", ci + sk, co)
        conv_bn(f"decoder.blocks.{i}.conv2", co, co)
        ci = co
    out["segmentation_head.0.weight"] = (m["num_classes"], ci, 3, 3)
    out["segmentation_head.0.bias"] = (m["num_classes"],)
    return out


def _is_norm(name: str) -> bool:
    """GroupNorm (``.gn*``), LayerNorm (``*norm``) and the decoder's
    BatchNorms (``<conv>.1.weight``, the second of a conv's pair), and not
    the matrices of ``layer.1.`` or ``blocks.1.``."""
    return ".gn" in name or "norm" in name or name.split(".")[-2] == "1"


def make_params(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights from `seed`: one normal draw on the device,
    cut into He-normal conv kernels (std sqrt(2 / fan-in)), linears and the
    patch conv of std sqrt(1 / fan-in), and the spreads above; f32, keyed
    by the official state_dict names."""
    shapes = param_shapes(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        z = flat[off:off + math.prod(shape)].reshape(shape)
        off += math.prod(shape)
        if name.endswith("running_var"):
            t = torch.exp(2 * NORM_SPREAD * z)
        elif _is_norm(name):
            t = (1.0 if name.endswith("weight") else 0.0) + NORM_SPREAD * z
            if name.endswith("gn3.weight"):
                t = RESIDUAL_SCALE * t
        elif "position" in name:
            t = POS_STD * z
        elif len(shape) == 1:
            t = BIAS_STD * z
        else:
            fan_in = math.prod(shape[1:])
            gain = 1.0 if (len(shape) == 2 or "patch" in name) else 2.0
            t = z * math.sqrt(gain / fan_in)
        out[name] = t
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


def forward(p: Dict[str, torch.Tensor], x: torch.Tensor, m: dict,
            quant: Optional[Quant] = None, tokens: bool = False):
    """x [B, S, S, in_channels] f32 -> logits [B, S, S, num_classes] f32;
    with `tokens`, (logits, the encoded tokens [B, N, hidden] after the
    final LN)."""
    q = quant or (lambda name, role, t: t)

    def conv(name, t, w, bias=None, stride=1, padding=0):
        return F.conv2d(q(name, "x", t), q(name, "w", w), bias, stride, padding)

    def std_conv(t, name, stride=1, padding=0):
        w = p[name]
        v, mu = torch.var_mean(w, dim=[1, 2, 3], keepdim=True, unbiased=False)
        return conv(name, t, (w - mu) / torch.sqrt(v + 1e-5), None, stride, padding)

    def gn(t, name, groups=32, eps=1e-6):
        return F.group_norm(t, groups, p[f"{name}.weight"], p[f"{name}.bias"], eps)

    def lin(z, name):
        return F.linear(q(name, "x", z), q(name, "w", p[f"{name}.weight"]), p[f"{name}.bias"])

    x = x.float().permute(0, 3, 1, 2)
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    b, _, in_size, _ = x.shape
    # the trunk (ResNetV2.forward)
    t = F.relu(gn(std_conv(x, TRUNK + "root.conv.weight", 2, 3), TRUNK + "root.gn"))
    features = [t]
    t = F.max_pool2d(t, kernel_size=3, stride=2, padding=0)
    stages = m["resnet_units"]
    for s, units in enumerate(stages, 1):
        for u in range(1, units + 1):
            n = f"{TRUNK}body.block{s}.unit{u}."
            stride = 2 if (s > 1 and u == 1) else 1
            r = t
            if u == 1:
                r = std_conv(t, n + "downsample.weight", stride)
                r = gn(r, n + "gn_proj", r.shape[1], 1e-5)
            y = F.relu(gn(std_conv(t, n + "conv1.weight"), n + "gn1"))
            y = F.relu(gn(std_conv(y, n + "conv2.weight", stride, 1), n + "gn2"))
            t = F.relu(r + gn(std_conv(y, n + "conv3.weight"), n + "gn3"))
        if s < len(stages):
            right = int(in_size / 4 / s)
            feat = t
            if t.shape[2] != right:
                feat = torch.zeros((b, t.shape[1], right, right), device=t.device)
                feat[:, :, :t.shape[2], :t.shape[3]] = t
            features.append(feat)
    features = features[::-1]
    # the ViT (Embeddings, Encoder)
    e = "transformer.embeddings."
    t = conv(e + "patch_embeddings.weight", t, p[e + "patch_embeddings.weight"],
             p[e + "patch_embeddings.bias"])
    t = t.flatten(2).transpose(-1, -2) + p[e + "position_embeddings"]
    nb, n_tok, hid = t.shape
    heads = m["heads"]
    d = hid // heads

    def ln(z, name):
        return F.layer_norm(z, (hid,), p[f"{name}.weight"], p[f"{name}.bias"], 1e-6)

    for i in range(m["layers"]):
        L = f"transformer.encoder.layer.{i}."
        z = ln(t, L + "attention_norm")
        qh, kh, vh = (lin(z, f"{L}attn.{k}").view(nb, n_tok, heads, d).permute(0, 2, 1, 3)
                      for k in ("query", "key", "value"))
        probs = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(d), dim=-1)
        t = t + lin((probs @ vh).permute(0, 2, 1, 3).reshape(nb, n_tok, hid), L + "attn.out")
        z = ln(t, L + "ffn_norm")
        t = t + lin(F.gelu(lin(z, L + "ffn.fc1")), L + "ffn.fc2")
    t = ln(t, "transformer.encoder.encoder_norm")
    encoded = t
    # the decoder (DecoderCup, SegmentationHead)
    side = int(math.sqrt(n_tok))

    def conv_bn_relu(z, name):
        y = conv(f"{name}.0.weight", z, p[f"{name}.0.weight"], None, 1, 1)
        y = F.batch_norm(y, p[f"{name}.1.running_mean"], p[f"{name}.1.running_var"],
                         p[f"{name}.1.weight"], p[f"{name}.1.bias"], False, 0.0, 1e-5)
        return F.relu(y)

    t = conv_bn_relu(t.permute(0, 2, 1).contiguous().view(nb, hid, side, side), "decoder.conv_more")
    for i in range(len(m["decoder_channels"])):
        t = F.interpolate(t, scale_factor=2, mode="bilinear", align_corners=True)
        if i < m["n_skip"]:
            t = torch.cat([t, features[i]], dim=1)
        t = conv_bn_relu(t, f"decoder.blocks.{i}.conv1")
        t = conv_bn_relu(t, f"decoder.blocks.{i}.conv2")
    h = "segmentation_head.0."
    t = conv(h + "weight", t, p[h + "weight"], p[h + "bias"], 1, 1).permute(0, 2, 3, 1)
    return (t, encoded) if tokens else t


def forward_blocks(params, x: torch.Tensor, m: dict, block: int,
                   quant: Optional[Quant] = None, tokens: bool = False):
    """`forward` over `x` in blocks of `block` slices, with no autograd."""
    with torch.no_grad():
        outs = [forward(params, x[i:i + block], m, quant, tokens)
                for i in range(0, x.shape[0], block)]
    if tokens:
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    return torch.cat(outs)


def slices(frames: np.ndarray) -> np.ndarray:
    """[N, S, S] frames -> [N, S, S, 1] f32 network inputs: each min/ptp
    normalised, the whole frame one tile (every conv is same-padded)."""
    f = frames.astype(np.float64)
    lo = f.min(axis=(1, 2), keepdims=True)
    f = (f - lo) / np.maximum(f.max(axis=(1, 2), keepdims=True) - lo, 1e-12)
    return f[..., None].astype(np.float32)


def class_labels(instances: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Instance ids (0 the background) -> class ids: instance k of class
    1 + (k - 1) mod (num_classes - 1), the background 0."""
    return torch.where(instances > 0, 1 + (instances - 1) % (num_classes - 1), 0)


def metrics(maps: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """[N, 2] per slice: IoU of the nonzero masks and pixel error (the
    share of pixels whose class differs), in float64."""
    p = (maps != 0).reshape(maps.shape[0], -1)
    g = (labels != 0).reshape(labels.shape[0], -1)
    inter = (p & g).sum(1).astype(np.float64)
    union = (p | g).sum(1).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        iou = inter / union
    pe = (maps != labels).reshape(maps.shape[0], -1).mean(1, dtype=np.float64)
    return np.stack([iou, pe], axis=1)
