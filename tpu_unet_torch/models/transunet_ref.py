"""The plain float32 TransUNet R50-ViT-B/16: the reference the port's
`models.transunet.TransUNet` is held to. Plain ``torch`` operations in
NCHW, no kernel of the port, TF32 off for cuDNN and matmuls while it runs.

It follows the official code (github.com/Beckschen/TransUNet,
``networks/vit_seg_modeling.py`` and ``vit_seg_modeling_resnet_skip.py``)
line for line: ``StdConv2d`` (biased variance, eps 1e-5), GroupNorm(32,
eps 1e-6) after every trunk conv and GroupNorm(C, C) (eps 1e-5) after each
projection, the root's 7x7 stride-2 conv, GroupNorm and ReLU, the 3x3
stride-2 max-pool with padding 0, the stride on each unit's 3x3 conv, the
skips zero-padded at the bottom and right to ``img_size / 4 / (i + 1)``
(stage 2 runs on the unpadded map), a one-channel input repeated to 3
channels; the 1x1 patch conv plus the position table, pre-LN blocks (LN eps
1e-6, softmax(q k^T / sqrt(d)) v, exact GELU), the final LN; the decoder's
``Conv2dReLU`` (conv without bias, BatchNorm eps 1e-5 with its running
statistics, ReLU), ``UpsamplingBilinear2d(scale_factor=2)`` (align_corners
True), the concat [up, skip], and the 3x3 head with no upsampling.

Departures: dropout is left out (inference), and BatchNorm and GroupNorm
run as ``F.batch_norm``/``F.group_norm`` of the same parameters rather than
modules. `params` is a state_dict of the official names
(`models.transunet.param_shapes`); `cfg` a `TransUNetConfig`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

_TRUNK = "transformer.embeddings.hybrid_model."


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


def _std_conv(x, w, stride=1, padding=0):
    v, m = torch.var_mean(w, dim=[1, 2, 3], keepdim=True, unbiased=False)
    return F.conv2d(x, (w - m) / torch.sqrt(v + 1e-5), None, stride, padding)


def _gn(x, p, name, groups, eps=1e-6):
    return F.group_norm(x, groups, p[f"{name}.weight"], p[f"{name}.bias"], eps)


def _unit(x, p, name, stride):
    residual = x
    if f"{name}.downsample.weight" in p:
        residual = _std_conv(x, p[f"{name}.downsample.weight"], stride)
        c = residual.shape[1]
        residual = _gn(residual, p, f"{name}.gn_proj", c, 1e-5)
    y = F.relu(_gn(_std_conv(x, p[f"{name}.conv1.weight"]), p, f"{name}.gn1", 32))
    y = F.relu(_gn(_std_conv(y, p[f"{name}.conv2.weight"], stride, 1), p, f"{name}.gn2", 32))
    y = _gn(_std_conv(y, p[f"{name}.conv3.weight"]), p, f"{name}.gn3", 32)
    return F.relu(residual + y)


def resnet(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg):
    """The official ``ResNetV2.forward``: NCHW x -> (stage 3's map, the skips
    from the deepest)."""
    b, _, in_size, _ = x.shape
    x = F.relu(_gn(_std_conv(x, p[_TRUNK + "root.conv.weight"], 2, 3), p, _TRUNK + "root.gn", 32))
    features = [x]
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=0)
    for s, units in enumerate(cfg.resnet_units):
        for u in range(1, units + 1):
            x = _unit(x, p, f"{_TRUNK}body.block{s + 1}.unit{u}", 2 if (s > 0 and u == 1) else 1)
        if s == len(cfg.resnet_units) - 1:
            break
        right_size = int(in_size / 4 / (s + 1))
        if x.shape[2] != right_size:
            pad = right_size - x.shape[2]
            assert 0 < pad < 3, (x.shape, right_size)
            feat = torch.zeros((b, x.shape[1], right_size, right_size), device=x.device)
            feat[:, :, 0:x.shape[2], 0:x.shape[3]] = x
        else:
            feat = x
        features.append(feat)
    return x, features[::-1]


def vit(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    """Stage 3's NCHW map -> [B, N, hidden] encoded tokens."""
    e = "transformer.embeddings."
    x = F.conv2d(x, p[e + "patch_embeddings.weight"], p[e + "patch_embeddings.bias"])
    t = x.flatten(2).transpose(-1, -2) + p[e + "position_embeddings"]
    b, n, hid = t.shape
    d = hid // cfg.heads

    def lin(z, name):
        return F.linear(z, p[f"{name}.weight"], p[f"{name}.bias"])

    def ln(z, name):
        return F.layer_norm(z, (hid,), p[f"{name}.weight"], p[f"{name}.bias"], 1e-6)

    def heads(z):
        return z.view(b, n, cfg.heads, d).permute(0, 2, 1, 3)

    for i in range(cfg.layers):
        L = f"transformer.encoder.layer.{i}."
        z = ln(t, L + "attention_norm")
        q, k, v = (heads(lin(z, f"{L}attn.{m}")) for m in ("query", "key", "value"))
        probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
        ctx = (probs @ v).permute(0, 2, 1, 3).reshape(b, n, hid)
        t = t + lin(ctx, L + "attn.out")
        z = ln(t, L + "ffn_norm")
        t = t + lin(F.gelu(lin(z, L + "ffn.fc1")), L + "ffn.fc2")
    return ln(t, "transformer.encoder.encoder_norm")


def _conv_bn_relu(p, x, name):
    y = F.conv2d(x, p[f"{name}.0.weight"], None, 1, 1)
    y = F.batch_norm(y, p[f"{name}.1.running_mean"], p[f"{name}.1.running_var"],
                     p[f"{name}.1.weight"], p[f"{name}.1.bias"], False, 0.0, 1e-5)
    return F.relu(y)


def decoder(p: Dict[str, torch.Tensor], t: torch.Tensor, features, cfg) -> torch.Tensor:
    """The official ``DecoderCup`` and ``SegmentationHead``: tokens -> NCHW
    logits."""
    b, n, hid = t.shape
    h = w = int(math.sqrt(n))
    x = t.permute(0, 2, 1).contiguous().view(b, hid, h, w)
    x = _conv_bn_relu(p, x, "decoder.conv_more")
    for i in range(len(cfg.decoder_channels)):
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
        if i < cfg.n_skip:
            x = torch.cat([x, features[i]], dim=1)
        x = _conv_bn_relu(p, x, f"decoder.blocks.{i}.conv1")
        x = _conv_bn_relu(p, x, f"decoder.blocks.{i}.conv2")
    return F.conv2d(x, p["segmentation_head.0.weight"], p["segmentation_head.0.bias"], padding=1)


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg) -> torch.Tensor:
    """NHWC x [B, S, S, in_channels] -> float32 NHWC logits [B, S, S,
    num_classes], with no autograd."""
    p = {k: v.float() for k, v in params.items()}
    with exact_f32(), torch.no_grad():
        x = x.float().permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        y, features = resnet(p, x, cfg)
        t = vit(p, y, cfg)
        return decoder(p, t, features, cfg).permute(0, 2, 3, 1)
