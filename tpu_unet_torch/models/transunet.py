"""TransUNet R50-ViT-B/16 (Chen et al. 2021, arXiv:2102.04306) in PyTorch,
in bfloat16 with float32 sums.

The equations are those of the official code (github.com/Beckschen/TransUNet,
``networks/vit_seg_modeling.py`` and ``vit_seg_modeling_resnet_skip.py``),
and the parameters carry its state_dict names
(``transformer.embeddings.hybrid_model.root.conv.weight`` ...
``segmentation_head.0.weight``) in its layouts, so a checkpoint of it loads
as it is:

* **ResNet-50 v2 trunk.** Weight-standardised convs (eps 1e-5), each
  followed by GroupNorm(32, eps 1e-6): a 7x7 stride-2 root (3 -> 64) with
  GN and ReLU, a 3x3 stride-2 max-pool with padding 0 (256 -> 127 at 512),
  and three stages of `resnet_units` bottleneck units (64, 128, 256 wide;
  256, 512, 1024 out; the stride on the 3x3 conv; the first unit's
  projection a 1x1 conv and a per-channel GroupNorm, eps 1e-5). A
  one-channel input is repeated to 3 channels. The root's map and stages
  1 and 2's are the decoder's skips; stage 1's 127^2 map is zero-padded
  at the bottom and right to 128^2, and stage 2 runs on the unpadded one.
* **ViT-B/16.** Stage 3's map (stride 16) through a 1x1 conv to `hidden`
  plus a learned position table; `layers` pre-LN blocks (LN eps 1e-6,
  `heads` heads, an MLP of width `mlp` with exact GELU) and a final LN.
* **CUP decoder.** The tokens back on their grid, a 3x3 conv (-> 512) +
  BN + ReLU, then per block a x2 bilinear upsample with align_corners=True,
  the concat [up, skip] and two 3x3 conv + BN + ReLU
  (`decoder_channels`); the last block has no skip. The head is a 3x3 conv
  with no activation.

Every conv is same-padded, so the output is the input's size: the engine
serves a whole frame as one tile (`tile_plan`).

Execution. Tensors stay NHWC from end to end: the library convs see them
through channels-last views, the tokens are the stage-3 map flattened, and
the decoder's maps are NHWC for K1. The weight standardisation, the
BatchNorm fold into the decoder convs' weights and biases, the root's
three input channels summed for a one-channel input, the fused QKV weight
and the casts to the compute dtype are done once, when the weights are
first used after a load (`prepare`), not a request. GroupNorm, LayerNorm
and softmax keep their statistics in float32. The decoder's 3x3 conv +
BN + ReLU layers call `conv3x3_bias_relu` (K1 on the card, its plain
version on the CPU) on a zero-bordered NHWC buffer under
``conv_impl='pallas'``, ``F.conv2d`` under 'xla'; attention is
`ops.attention.attention` (``F.scaled_dot_product_attention``, its calls
counted in ``attention.launches``). Both are looked up as this module's
attributes at each call, so a wrapper set on the module from outside sees
every call.

On a CUDA device with autograd off and ``cuda_graphs`` set (the default),
the forward of each input shape is captured once as a CUDA graph and
replayed (`TransUNet._replay`): a forward launches ~1000 kernels, many of
them short (the trunk's GroupNorm statistics at 32^2), and launched one by
one from Python the card waits on the host between them, by as much as the
host is slow. A replay runs no Python: its spans do not open and the
calls' counters (``attention.launches``, ``conv3x3_bias_relu.launches``)
do not move. With ``cuda_graphs`` cleared the forward runs eagerly, the
same kernels launched one by one, and names its parts in a profile.

Spans (`utils.profiling.span`): ``transunet.resnet``, ``transunet.vit``,
``transunet.decoder`` around the three parts of each eager forward.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tpu_unet_torch.config import TransUNetConfig
from tpu_unet_torch.core.geometry import TilePlan, whole_frame_plan
from tpu_unet_torch.ops.attention import attention
from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu
from tpu_unet_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: The trunk's width (the official width_factor 1) and the decoder's first
#: conv's output channels (``DecoderCup.head_channels``).
RESNET_WIDTH = 64
HEAD_CHANNELS = 512
GN_GROUPS = 32
GN_EPS, PROJ_GN_EPS, WS_EPS, LN_EPS, BN_EPS = 1e-6, 1e-5, 1e-5, 1e-6, 1e-5

_TRUNK = "transformer.embeddings.hybrid_model."
_EMBED = "transformer.embeddings."
_ENCODER = "transformer.encoder."


def stage_widths(stage: int) -> Tuple[int, int, int]:
    """(the first unit's input channels, mid channels, output channels) of
    trunk stage `stage` (1-based)."""
    w = RESNET_WIDTH
    cin = w if stage == 1 else w * 2 ** stage
    return cin, w * 2 ** (stage - 1), w * 2 ** (stage + 1)


def skip_channels(cfg: TransUNetConfig) -> List[int]:
    """The channels each decoder block concatenates from the trunk: stage
    2's, stage 1's, the root's, then none (``n_skip`` of them)."""
    w = RESNET_WIDTH
    return [c if i < cfg.n_skip else 0 for i, c in enumerate((8 * w, 4 * w, w, 0))]


def param_shapes(cfg: TransUNetConfig) -> Dict[str, Tuple[int, ...]]:
    """{state_dict name: shape} in forward order; BatchNorm running
    statistics (``running_mean``, ``running_var``) are buffers."""
    out: Dict[str, Tuple[int, ...]] = {}

    def gn(name, c):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c,), (c,)

    out[_TRUNK + "root.conv.weight"] = (RESNET_WIDTH, 3, 7, 7)
    gn(_TRUNK + "root.gn", RESNET_WIDTH)
    for s, units in enumerate(cfg.resnet_units, 1):
        cin, mid, cout = stage_widths(s)
        for u in range(1, units + 1):
            p = f"{_TRUNK}body.block{s}.unit{u}."
            c = cin if u == 1 else cout
            out[p + "conv1.weight"] = (mid, c, 1, 1)
            gn(p + "gn1", mid)
            out[p + "conv2.weight"] = (mid, mid, 3, 3)
            gn(p + "gn2", mid)
            out[p + "conv3.weight"] = (cout, mid, 1, 1)
            gn(p + "gn3", cout)
            if u == 1:
                out[p + "downsample.weight"] = (cout, c, 1, 1)
                gn(p + "gn_proj", cout)
    n = (cfg.img_size // 16) ** 2
    out[_EMBED + "patch_embeddings.weight"] = (cfg.hidden, stage_widths(3)[2], 1, 1)
    out[_EMBED + "patch_embeddings.bias"] = (cfg.hidden,)
    out[_EMBED + "position_embeddings"] = (1, n, cfg.hidden)
    for i in range(cfg.layers):
        p = f"{_ENCODER}layer.{i}."
        gn(p + "attention_norm", cfg.hidden)
        for lin in ("query", "key", "value", "out"):
            out[f"{p}attn.{lin}.weight"] = (cfg.hidden, cfg.hidden)
            out[f"{p}attn.{lin}.bias"] = (cfg.hidden,)
        gn(p + "ffn_norm", cfg.hidden)
        out[p + "ffn.fc1.weight"], out[p + "ffn.fc1.bias"] = (cfg.mlp, cfg.hidden), (cfg.mlp,)
        out[p + "ffn.fc2.weight"], out[p + "ffn.fc2.bias"] = (cfg.hidden, cfg.mlp), (cfg.hidden,)
    gn(_ENCODER + "encoder_norm", cfg.hidden)

    def conv_bn(name, cin, cout):
        out[f"{name}.0.weight"] = (cout, cin, 3, 3)
        for k in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.1.{k}"] = (cout,)

    conv_bn("decoder.conv_more", cfg.hidden, HEAD_CHANNELS)
    ins = [HEAD_CHANNELS] + list(cfg.decoder_channels[:-1])
    for i, (cin, cout, sk) in enumerate(zip(ins, cfg.decoder_channels, skip_channels(cfg))):
        conv_bn(f"decoder.blocks.{i}.conv1", cin + sk, cout)
        conv_bn(f"decoder.blocks.{i}.conv2", cout, cout)
    out["segmentation_head.0.weight"] = (cfg.num_classes, cfg.decoder_channels[-1], 3, 3)
    out["segmentation_head.0.bias"] = (cfg.num_classes,)
    return out


def _is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def standardize(w: torch.Tensor) -> torch.Tensor:
    """The official ``StdConv2d``'s weight: each output filter less its mean
    over its biased standard deviation (eps `WS_EPS`), in float32."""
    w = w.float()
    var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (w - mean) / torch.sqrt(var + WS_EPS)


def fold_bn(w: torch.Tensor, gamma, beta, mean, var) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight, bias) of a bias-free conv followed by inference BatchNorm
    (eps `BN_EPS`), in float32."""
    s = gamma.float() / torch.sqrt(var.float() + BN_EPS)
    return w.float() * s[:, None, None, None], beta.float() - mean.float() * s


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A library conv of NHWC `x` with a channels-last OIHW `w`, NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, bias, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


def group_norm(x: torch.Tensor, groups: int, affine, eps: float, relu: bool = True,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm of NHWC `x` with its affine (float32 gamma, beta), then
    `residual` added and a ReLU. The statistics are float32 sums over each
    channel, then over each group; one pass of x * scale + shift in x's
    dtype applies them."""
    b, h, w, c = x.shape
    gamma, beta = affine
    xs = x.reshape(b, h * w, c)
    n = h * w * (c // groups)
    s1 = xs.sum(1, dtype=torch.float32).view(b, groups, -1).sum(2)
    s2 = torch.linalg.vector_norm(xs, 2, dim=1, dtype=torch.float32).square_()
    mean = s1.div_(n)
    var = s2.view(b, groups, -1).sum(2).div_(n).sub_(mean * mean).clamp_min_(0)
    rstd = var.add_(eps).rsqrt_()
    scale = gamma.view(groups, -1) * rstd[:, :, None]
    shift = beta.view(groups, -1) - mean[:, :, None] * scale
    y = torch.addcmul(shift.view(b, 1, 1, c).to(x.dtype), x, scale.view(b, 1, 1, c).to(x.dtype))
    if residual is not None:
        y += residual
    return y.relu_() if relu else y


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample with align_corners=True (the official
    ``nn.UpsamplingBilinear2d``) of NHWC `x`."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


def bordered_cat(parts: List[torch.Tensor], h: int, w: int) -> torch.Tensor:
    """[B, h + 2, w + 2, sum C] NHWC: the channel concat of `parts`, each at
    the top left of an h x w map and zero past its own extent (the zero
    padding of stage 1's skip), inside a one-pixel zero border."""
    b = parts[0].shape[0]
    buf = parts[0].new_zeros((b, h + 2, w + 2, sum(p.shape[3] for p in parts)))
    c = 0
    for p in parts:
        buf[:, 1:1 + p.shape[1], 1:1 + p.shape[2], c:c + p.shape[3]] = p
        c += p.shape[3]
    return buf


class TransUNet(nn.Module):
    """TransUNet R50-ViT-B/16. Input NHWC [B, S, S, in_channels] with S =
    `cfg.img_size`; output float32 logits [B, S, S, num_classes].

    Weights are drawn from `generator` (default: a generator seeded 0).
    ``cuda_graphs``: replay a captured forward on a CUDA device with
    autograd off (the module's docstring); clear it for the eager forward."""

    def __init__(self, cfg: TransUNetConfig = TransUNetConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        for name, shape in param_shapes(cfg).items():
            *path, leaf = name.split(".")
            owner = self
            for part in path:
                if not hasattr(owner, part):
                    owner.add_module(part, nn.Module())
                owner = getattr(owner, part)
            if _is_buffer(name):
                owner.register_buffer(leaf, torch.empty(shape))
            else:
                owner.register_parameter(leaf, nn.Parameter(torch.empty(shape)))
        self._prep: Optional[SimpleNamespace] = None
        self.cuda_graphs = True
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Convs and linears N(0, 2 / fan-in) and N(0, 1 / fan-in), the
        position table N(0, 0.02^2), norms and biases at identity and zero,
        BatchNorm statistics 0 and 1."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        state = self.state_dict()
        for name, t in state.items():
            if name.endswith(("running_var",)) or (
                    t.dim() == 1 and name.endswith("weight")):
                t.fill_(1.0)
            elif t.dim() == 1 or name.endswith("running_mean"):
                t.zero_()
            else:
                fan_in = math.prod(t.shape[1:])
                std = 0.02 if "position" in name else math.sqrt(
                    (2.0 if t.dim() == 4 else 1.0) / fan_in)
                t.copy_(torch.randn(t.shape, generator=generator) * std)
        self._prep = None

    def tile_plan(self, image_h: int, image_w: int, tile_out=None) -> TilePlan:
        """The engine's plan (infer/tiles.py): the whole frame as one tile,
        which has to be the network's `img_size` square (its position table
        is fixed)."""
        s = self.cfg.img_size
        if (image_h, image_w) != (s, s) or tile_out not in (None, s, (s, s)):
            raise ValueError(f"TransUNet serves whole {s}x{s} frames, got {image_h}x{image_w}"
                             f" with tile_out {tile_out!r}")
        return whole_frame_plan(image_h, image_w)

    def load_state_dict(self, *args, **kwargs):
        out = super().load_state_dict(*args, **kwargs)
        self._prep = None
        return out

    def _apply(self, fn, *args, **kwargs):
        self._prep = None
        return super()._apply(fn, *args, **kwargs)

    @torch.no_grad()
    def prepare(self) -> SimpleNamespace:
        """The forward's weights, derived once from the parameters on their
        device: standardised, folded, fused and cast. A load or a move of
        the module drops them; a change to a parameter in place needs
        ``model.prepare()`` again."""
        cfg, dt = self.cfg, self.compute_dtype
        sd = self.state_dict()
        cl = torch.channels_last

        def gn(name):
            return sd[name + ".weight"].float(), sd[name + ".bias"].float()

        def mat(name):                 # a 1x1 conv or linear as [Cout, Cin]
            w = sd[name]
            return w.reshape(w.shape[0], -1).to(dt)

        root = standardize(sd[_TRUNK + "root.conv.weight"])
        if cfg.in_channels == 1:       # conv(repeat(x, 3), w) = conv(x, sum of w over its inputs)
            root = root.sum(1, keepdim=True)
        p = SimpleNamespace(root=root.to(dt).contiguous(memory_format=cl),
                            root_gn=gn(_TRUNK + "root.gn"), stages=[], blocks=[], dec=[],
                            graphs={})
        for s, units in enumerate(cfg.resnet_units, 1):
            stage = []
            for u in range(1, units + 1):
                q = f"{_TRUNK}body.block{s}.unit{u}."
                unit = SimpleNamespace(
                    stride=2 if (s > 1 and u == 1) else 1,
                    w1=mat_std(sd, q + "conv1.weight", dt), gn1=gn(q + "gn1"),
                    w2=standardize(sd[q + "conv2.weight"]).to(dt).contiguous(memory_format=cl),
                    gn2=gn(q + "gn2"), w3=mat_std(sd, q + "conv3.weight", dt), gn3=gn(q + "gn3"),
                    proj=None)
                if u == 1:
                    unit.proj = standardize(sd[q + "downsample.weight"]).to(dt).contiguous(
                        memory_format=cl)
                    unit.gn_proj = gn(q + "gn_proj")
                stage.append(unit)
            p.stages.append(stage)
        p.patch_w = mat(_EMBED + "patch_embeddings.weight")
        p.patch_b = sd[_EMBED + "patch_embeddings.bias"].to(dt)
        p.pos = sd[_EMBED + "position_embeddings"][0].to(dt)
        for i in range(cfg.layers):
            q = f"{_ENCODER}layer.{i}."
            a = q + "attn."
            p.blocks.append(SimpleNamespace(
                ln1=(sd[q + "attention_norm.weight"].to(dt), sd[q + "attention_norm.bias"].to(dt)),
                qkv_w=torch.cat([sd[f"{a}{n}.weight"] for n in ("query", "key", "value")]).to(dt),
                qkv_b=torch.cat([sd[f"{a}{n}.bias"] for n in ("query", "key", "value")]).to(dt),
                out_w=mat(a + "out.weight"), out_b=sd[a + "out.bias"].to(dt),
                ln2=(sd[q + "ffn_norm.weight"].to(dt), sd[q + "ffn_norm.bias"].to(dt)),
                fc1_w=mat(q + "ffn.fc1.weight"), fc1_b=sd[q + "ffn.fc1.bias"].to(dt),
                fc2_w=mat(q + "ffn.fc2.weight"), fc2_b=sd[q + "ffn.fc2.bias"].to(dt)))
        p.enc_norm = (sd[_ENCODER + "encoder_norm.weight"].to(dt),
                      sd[_ENCODER + "encoder_norm.bias"].to(dt))

        def conv_bn(name):
            w, b = fold_bn(sd[name + ".0.weight"], *(sd[f"{name}.1.{k}"] for k in
                                                     ("weight", "bias", "running_mean",
                                                      "running_var")))
            if cfg.conv_impl == "pallas":     # K1's HWIO kernel, its bias in float32
                return w.permute(2, 3, 1, 0).to(dt).contiguous(), b
            return w.to(dt).contiguous(memory_format=cl), b.to(dt)

        p.conv_more = conv_bn("decoder.conv_more")
        for i in range(len(cfg.decoder_channels)):
            p.dec.append((conv_bn(f"decoder.blocks.{i}.conv1"),
                          conv_bn(f"decoder.blocks.{i}.conv2")))
        p.head = (sd["segmentation_head.0.weight"].to(dt).contiguous(memory_format=cl),
                  sd["segmentation_head.0.bias"].to(dt))
        self._prep = p
        return p

    # -- the three parts -------------------------------------------------------

    def _unit(self, x: torch.Tensor, u: SimpleNamespace) -> torch.Tensor:
        """One pre-activation bottleneck unit (the official
        ``PreActBottleneck``), NHWC."""
        r = x
        if u.proj is not None:
            r = group_norm(_conv(x, u.proj, u.stride), u.proj.shape[0], u.gn_proj, PROJ_GN_EPS,
                           relu=False)
        y = group_norm(F.linear(x, u.w1), GN_GROUPS, u.gn1, GN_EPS)
        y = group_norm(_conv(y, u.w2, u.stride, 1), GN_GROUPS, u.gn2, GN_EPS)
        return group_norm(F.linear(y, u.w3), GN_GROUPS, u.gn3, GN_EPS, residual=r)

    def _resnet(self, x: torch.Tensor, p: SimpleNamespace):
        """NHWC input -> (stage 3's map, [stage 2's, stage 1's, the root's])."""
        y = group_norm(_conv(x.to(self.compute_dtype), p.root, 2, 3), GN_GROUPS, p.root_gn,
                       GN_EPS)
        feats = [y]
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1).contiguous()
        for s, stage in enumerate(p.stages):
            for u in stage:
                y = self._unit(y, u)
            if s < len(p.stages) - 1:
                feats.append(y)
        return y, feats[::-1]

    def _vit(self, y: torch.Tensor, p: SimpleNamespace) -> torch.Tensor:
        """Stage 3's NHWC map -> [B, N, hidden] encoded tokens."""
        cfg = self.cfg
        b, n, hid, heads = y.shape[0], y.shape[1] * y.shape[2], cfg.hidden, cfg.heads
        t = F.linear(y.reshape(b, n, -1), p.patch_w, p.patch_b)
        t += p.pos
        for blk in p.blocks:
            z = F.layer_norm(t, (hid,), *blk.ln1, eps=LN_EPS)
            q, k, v = F.linear(z, blk.qkv_w, blk.qkv_b).view(b, n, 3, heads, -1).permute(
                2, 0, 3, 1, 4).unbind(0)
            o = attention(q, k, v).transpose(1, 2).reshape(b, n, hid)
            t += F.linear(o, blk.out_w, blk.out_b)
            z = F.layer_norm(t, (hid,), *blk.ln2, eps=LN_EPS)
            t += F.linear(F.gelu(F.linear(z, blk.fc1_w, blk.fc1_b)), blk.fc2_w, blk.fc2_b)
        return F.layer_norm(t, (hid,), *p.enc_norm, eps=LN_EPS)

    def _conv_bn_relu(self, xb: torch.Tensor, wb) -> torch.Tensor:
        """relu(conv3x3(x) + b) of a zero-bordered NHWC `xb`, BN folded in."""
        w, b = wb
        if self.cfg.conv_impl == "pallas":
            return conv3x3_bias_relu(xb, w, b)
        return _conv(xb, w, bias=b).relu_()

    def _decoder(self, t: torch.Tensor, skips: List[torch.Tensor],
                 p: SimpleNamespace) -> torch.Tensor:
        """Encoded tokens and the trunk's skips -> float32 NHWC logits."""
        b, n, hid = t.shape
        s = math.isqrt(n)
        x = self._conv_bn_relu(bordered_cat([t.view(b, s, s, hid)], s, s), p.conv_more)
        for i, (c1, c2) in enumerate(p.dec):
            x = upsample2(x)
            h, w = x.shape[1], x.shape[2]
            parts = [x, skips[i]] if i < self.cfg.n_skip else [x]
            x = self._conv_bn_relu(bordered_cat(parts, h, w), c1)
            x = self._conv_bn_relu(bordered_cat([x], h, w), c2)
        return _conv(x, p.head[0], padding=1, bias=p.head[1]).float()

    def _run(self, x: torch.Tensor, p: SimpleNamespace) -> torch.Tensor:
        with span("transunet.resnet"):
            y, skips = self._resnet(x, p)
        with span("transunet.vit"):
            t = self._vit(y, p)
        with span("transunet.decoder"):
            return self._decoder(t, skips, p)

    def _replay(self, x: torch.Tensor, p: SimpleNamespace) -> torch.Tensor:
        """The forward as a CUDA graph, one for each input shape, kept with
        the prepared weights it reads: the first call of a shape runs
        eagerly (every lazy initialisation and library choice is made
        then), the second captures, later ones replay. A replay launches
        the ~1000 kernels of a forward at once, so the card does not wait
        on the host's launches between them. Returns a fresh tensor."""
        key = (tuple(x.shape), x.dtype, x.device)
        g = p.graphs.get(key)
        if g is None:
            p.graphs[key] = SimpleNamespace(graph=None)
            return self._run(x, p)
        if g.graph is None:
            g.x = x.clone()
            g.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g.graph):
                g.out = self._run(g.x, p)
        g.x.copy_(x)
        g.graph.replay()
        return g.out.clone()

    def _prepared(self, x: torch.Tensor) -> SimpleNamespace:
        """The prepared weights, once `x`'s shape is checked."""
        s = self.cfg.img_size
        if tuple(x.shape[1:]) != (s, s, self.cfg.in_channels):
            raise ValueError(f"expected NHWC [B, {s}, {s}, {self.cfg.in_channels}], got "
                             f"{tuple(x.shape)}")
        return self._prep if self._prep is not None else self.prepare()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [B, S, S, in_channels] -> float32 NHWC logits. On a CUDA
        device with autograd off and ``cuda_graphs`` set, a replayed CUDA
        graph (`_replay`); else the eager forward."""
        p = self._prepared(x)
        if self.cuda_graphs and x.is_cuda and not torch.is_grad_enabled():
            return self._replay(x, p)
        return self._run(x, p)

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The ViT's encoded tokens [B, N, hidden] (after its final LN, in
        the compute dtype) of NHWC `x`, as the forward computes them; run
        eagerly."""
        p = self._prepared(x)
        return self._vit(self._resnet(x, p)[0], p)


def mat_std(sd: Dict[str, torch.Tensor], name: str, dtype) -> torch.Tensor:
    """A standardised 1x1 conv's weight as a [Cout, Cin] matrix."""
    w = standardize(sd[name])
    return w.reshape(w.shape[0], -1).to(dtype)


def _check_config(cfg: TransUNetConfig) -> None:
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got "
                         f"{cfg.compute_dtype!r}")
    if cfg.conv_impl not in ("xla", "pallas"):
        raise ValueError(f"conv_impl must be 'xla' or 'pallas', got {cfg.conv_impl!r}")
    if cfg.in_channels not in (1, 3):
        raise ValueError(f"in_channels must be 1 (repeated to 3) or 3, got {cfg.in_channels}")
    if len(cfg.resnet_units) != 3 or len(cfg.decoder_channels) != 4:
        raise ValueError("the R50 trunk has 3 stages and the decoder 4 blocks, got "
                         f"{cfg.resnet_units} and {cfg.decoder_channels}")
    if not 0 <= cfg.n_skip <= 3:
        raise ValueError(f"n_skip must be 0..3 (the trunk has 3 skips), got {cfg.n_skip}")
    if cfg.img_size % 16 or cfg.hidden % cfg.heads:
        raise ValueError(f"img_size must be a multiple of 16 and hidden of heads, got "
                         f"{cfg.img_size}, {cfg.hidden}, {cfg.heads}")
