"""Int8 and int4 quantized U-Net serving (counterpart of
``tpu_unet/infer/quant.py``).

* Post-training quantization, symmetric: per-tensor activation scales
  (calibrated: abs-max over sample tiles / 127) and per-output-channel
  weight scales.
* The 3x3 convs whose input has at least `min_channels` channels (default
  128: 14 of the 18 at full width) run int8 x int8 -> int32 with a fused
  scale + bias + ReLU + requantize epilogue, and int8 activations between
  them. Two routes, with equal results: ``impl='pallas'`` runs K3, the
  hand-written Hopper kernel (`ops.conv_tiles.conv3x3_fused`), and
  ``impl='xla'`` the library route (`ops.conv_tiles.conv3x3_int8_xla`,
  im2col + cuBLASLt's int8 GEMM on the card).
* Max-pool runs on int8 directly (order-preserving); the upconvs, the
  low-channel convs and the 1x1 head stay bf16 with f32 sums; decoder
  concats happen in int8 (the skip is requantized in place, and float skips
  are captured already quantized at the concat scale).
* ``phase_level0`` ('bf16' or 'int8') runs level 0 on the 2x2 phase
  decomposition (ops/phase.py): 3x3 convs become 2x2 convs at 4x the
  channels, pool0 a max over the phase groups, up0 one matmul, and dec0's
  concat two split-kernel convs, each source at its own scale. 'int8' also
  quantizes the packed ``enc0_conv2`` and ``dec0_conv2`` (packed cin 4 x
  w0); under ``impl='pallas'`` those two run through the Hopper kernel
  `ops.conv_kxk.conv_rows3_col`, under 'xla' through the library route. The
  split int8 ``dec0_conv1`` (two int32 sums with a scale each) takes the
  library accumulate under both, as the JAX package's does.
* The int4 tier (w4a4, `q4names`: by default every int8 conv outside level
  0) runs its convs on int4-range values stored as int8
  (`ops.conv_tiles.conv3x3_int4_xla`: the int8 library route on the card,
  under both impls, as the JAX package runs XLA's int4 conv under both).
  Post-ReLU activations are shifted-u4 (u - 8, u in [0, 15]) at the
  calibrated scale x 127/15, with the constant 8 * sum(w) added to the
  int32 sums; an int4 decoder conv1 runs as two sums over its two sources
  (the skip in shifted-u4, the upconv output in signed s4 at x 127/7),
  never building the concat. Each encoding boundary requantizes in place
  (int8 <-> u4s: round(q * s_from / s_to)).

`QuantParams` holds the JAX package's layouts (HWIO kernels, the spatially
flipped transposed-conv kernels of ``up{d}``) as CPU tensors, so a
``.npz`` written by either package serves in the other; `QuantInference`
converts them to its device and PyTorch's layouts once.

The float convs run in f32 on bf16-valued tensors and add the f32 bias
before one bf16 rounding, as the JAX package's ``preferred_element_type``
convs do. On the card they may run in TF32: a bf16 value is exact in TF32,
so the products are those of f32. There, under a config whose 3x3 convs
run on K1 (``conv_impl='pallas'``, as the bf16 model routes them), the
float 3x3 convs outside the paired and packed forms run on K1
(`ops.conv_pallas.conv3x3_bias_relu`): bf16 NHWC in, the f32 bias, ReLU and
the one rounding in its epilogue. Only the order of the f32 sums differs.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_unet_torch.config import ModelConfig
from tpu_unet_torch.convert import kernel_to_convtranspose_weight, params_from_state_dict
from tpu_unet_torch.models.unet import _max_pool2, center_crop_or_pad
from tpu_unet_torch.ops import phase as ph
from tpu_unet_torch.ops.conv_kxk import conv_rows3_col
from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu as conv3x3_k1
from tpu_unet_torch.ops.conv_tiles import (_scalar, conv3x3_fused, conv3x3_int4_acc,
                                           conv3x3_int4_xla, conv3x3_int8_xla,
                                           conv_int8_acc, int4_epilogue,
                                           quantize_activations, quantize_activations_s4,
                                           quantize_activations_u4s, quantize_weights,
                                           quantize_weights_int4, requantize_i8_to_u4s,
                                           requantize_u4s_to_i8, tf32_for_bf16_values)
from tpu_unet_torch.utils.profiling import span

# 4-bit activation scales come from the int8 calibration: the clip range is
# the same, only the level count changes (shifted-u4 has 16 levels, s4 15).
_U4 = 127.0 / 15.0
_S4 = 127.0 / 7.0


def _conv_names(cfg: ModelConfig) -> Tuple[str, ...]:
    names = []
    for d in range(cfg.depth):
        names += [f"enc{d}_conv1", f"enc{d}_conv2"]
    names += ["bottleneck_conv1", "bottleneck_conv2"]
    for d in reversed(range(cfg.depth)):
        names += [f"dec{d}_conv1", f"dec{d}_conv2"]
    return tuple(names)


def default_quant_names(cfg: ModelConfig, min_channels: int = 128) -> FrozenSet[str]:
    """The 3x3 convs whose cin (the contraction depth) reaches
    `min_channels`: the set the JAX package measured int8 to win on."""
    w = cfg.widths
    out = set()
    for d in range(cfg.depth):
        cin1 = cfg.in_channels if d == 0 else w[d - 1]
        if cin1 >= min_channels:
            out.add(f"enc{d}_conv1")
        if w[d] >= min_channels:
            out.add(f"enc{d}_conv2")
    if w[cfg.depth - 1] >= min_channels:
        out.add("bottleneck_conv1")
    if w[cfg.depth] >= min_channels:
        out.add("bottleneck_conv2")
    for d in range(cfg.depth):
        if 2 * w[d] >= min_channels:
            out.add(f"dec{d}_conv1")
        if w[d] >= min_channels:
            out.add(f"dec{d}_conv2")
    return frozenset(out)


def default_int4_names(cfg: ModelConfig, min_channels: int = 128) -> FrozenSet[str]:
    """The int4 tier's conv set: every int8 conv outside level 0, which
    carries the finest spatial detail (and has its own phase-packed
    formulation)."""
    level0 = {"enc0_conv1", "enc0_conv2", "dec0_conv1", "dec0_conv2"}
    return frozenset(default_quant_names(cfg, min_channels) - level0)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def calibrate(model, sample_batch) -> Dict[str, float]:
    """Run the float `model` on representative tiles and record per-tensor
    activation scales: {name: scale} for every conv output (post-ReLU max /
    127), every upconv and the head (abs-max / 127), and the input.

    `sample_batch` [B, H, W, 1] should be normalized like serving inputs."""
    x = torch.as_tensor(sample_batch, dtype=torch.float32).to(_model_device(model))
    captured: Dict[str, torch.Tensor] = {}
    model(x, capture=captured)
    scales: Dict[str, float] = {"input": float(x.abs().max()) / 127.0}
    for name, out in captured.items():
        if name.startswith(("enc", "dec", "bottleneck")):
            m = float(out.max().clamp_min(0.0))     # the consumed post-ReLU max
        else:                                       # up{d} (signed) and head
            m = float(out.abs().max())
        scales[name] = max(m, 1e-6) / 127.0
    return scales


@dataclasses.dataclass
class QuantParams:
    """Serving parameters, CPU tensors in the JAX package's layouts: int8
    HWIO kernels with per-output-channel scales and f32 biases for the
    quantized convs, bf16 kernels (f32 for the level-0 convs) and f32 biases
    for the float rest; `q4names`/`q4conv`, the int4 tier's (int4-range
    HWIO kernels stored as int8), are disjoint from `qnames`."""

    cfg: ModelConfig
    qnames: FrozenSet[str]
    scales: Dict[str, float]
    qconv: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]  # (w_q, s_w, bias)
    fconv: Dict[str, Tuple[torch.Tensor, torch.Tensor]]                # (kernel, bias)
    q4names: FrozenSet[str] = frozenset()
    q4conv: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict)


# The level-0 convs keep f32 kernels in fconv, as the JAX package stores them
# (its phase engine quantizes them from full precision).
_LEVEL0_CONVS = ("enc0_conv1", "enc0_conv2", "dec0_conv1", "dec0_conv2")


def _jax_layout(params) -> Mapping:
    """The inner ``{name: {'kernel', 'bias'}}`` JAX-layout tree of `params`:
    a port UNet, its state_dict, or a JAX-layout tree."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if any("." in str(k) for k in params):
        params = params_from_state_dict(params)
    return params.get("params", params)


def _cpu_f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).clone()


def prepare_quant_params(cfg: ModelConfig, params, scales: Dict[str, float],
                         qnames: Optional[FrozenSet[str]] = None,
                         q4names: Optional[FrozenSet[str]] = None) -> QuantParams:
    """Quantize the weights of `params` (a port UNet, its state_dict, or a
    JAX-layout parameter tree) for serving with the calibrated `scales`.
    A conv in both `qnames` and `q4names` runs int4."""
    if qnames is None:
        qnames = default_quant_names(cfg)
    q4names = frozenset(q4names or ())
    qnames = frozenset(qnames) - q4names
    p = _jax_layout(params)
    qconv, fconv, q4conv = {}, {}, {}
    for name in _conv_names(cfg):
        kernel = _cpu_f32(p[name]["kernel"])
        bias = _cpu_f32(p[name]["bias"])
        if name in q4names:
            w_q, s_w = quantize_weights_int4(kernel)
            q4conv[name] = (w_q, s_w, bias)
        elif name in qnames:
            w_q, s_w = quantize_weights(kernel)
            qconv[name] = (w_q, s_w, bias)
        else:
            fconv[name] = (kernel if name in _LEVEL0_CONVS
                           else kernel.to(torch.bfloat16), bias)
    for name in [f"up{d}" for d in range(cfg.depth)] + ["head"]:
        fconv[name] = (_cpu_f32(p[name]["kernel"]).to(torch.bfloat16),
                       _cpu_f32(p[name]["bias"]))
    return QuantParams(cfg=cfg, qnames=qnames, scales=dict(scales), qconv=qconv,
                       fconv=fconv, q4names=q4names, q4conv=q4conv)


class QuantInference:
    """Mixed int8/bf16 forward with the U-Net's geometry (both skip
    variants). `impl`: 'pallas' (K3) or 'xla' (the int8 library route);
    `layer_impl` overrides it per conv name. `block_rows=None` asks K3 for
    the per-shape TPU configs (`best_config`), which it validates and does
    not need. `upconv_impl`: 'xla' (transposed conv) or 'matmul' (one
    matmul + depth-to-space). `phase_level0`: None, 'bf16' or 'int8' (see
    the module docstring). `device`: where it runs, default 'cuda'; without
    a card pass ``device='cpu'``."""

    def __init__(self, qp: QuantParams, impl: str = "xla",
                 block_rows: Optional[int] = None,
                 interpret: Optional[bool] = None,
                 layer_impl: Optional[Dict[str, str]] = None,
                 upconv_impl: str = "xla",
                 phase_level0: Optional[str] = None,
                 device=None):
        if impl not in ("pallas", "xla"):
            raise ValueError(f"impl must be 'pallas' or 'xla', got {impl!r}")
        if phase_level0 not in (None, "bf16", "int8"):
            raise ValueError(f"phase_level0 must be None, 'bf16' or 'int8', got "
                             f"{phase_level0!r}")
        if phase_level0 and qp.cfg.skip_variant != "paper":
            raise ValueError("phase_level0 requires the paper skip variant (the parity "
                             "skip is captured post-pool, outside the packed domain)")
        if phase_level0 and qp.cfg.in_channels != 1:
            raise ValueError("phase_level0 expects the 1-channel input")
        if upconv_impl not in ("xla", "matmul"):
            raise ValueError(f"upconv_impl must be 'xla' or 'matmul', got {upconv_impl!r}")
        for name, li in (layer_impl or {}).items():
            if li not in ("pallas", "xla"):
                raise ValueError(f"layer_impl[{name!r}] must be 'pallas' or 'xla', got {li!r}")
        del interpret                     # the CPU runs K3's plain version
        self.qp = qp
        self.impl = impl
        self.block_rows = block_rows
        self.layer_impl = dict(layer_impl or {})
        self.upconv_impl = upconv_impl
        if device is None and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device=\"cpu\" to serve on the CPU")
        self.device = torch.device(device or "cuda")
        dev = self.device
        # the weights in PyTorch's layouts on the device, once
        self._wq = {n: w.to(dev).contiguous() for n, (w, _, _) in qp.qconv.items()}
        self._wq4 = {n: w.to(dev).contiguous() for n, (w, _, _) in qp.q4conv.items()}
        # K1 takes the float 3x3 convs on a card when the config routes its
        # 3x3 convs there (`_fconv_hwio`)
        self._k1 = self.device.type == "cuda" and qp.cfg.conv_impl == "pallas"
        self._fconv, self._up = {}, {}
        for name, (k, b) in qp.fconv.items():
            k = k.to(torch.bfloat16).float()
            if name.startswith("up"):
                wt = torch.from_numpy(kernel_to_convtranspose_weight(k.numpy()).copy())
                self._up[name] = (wt.to(dev), b.to(dev))
            elif name == "head":
                self._head = (k[0, 0].to(dev), b.to(dev))        # [C, O]
            else:
                self._fconv[name] = (k.permute(3, 2, 0, 1).contiguous().to(dev), b.to(dev))
        self._epilogues: Dict[Tuple[str, float, bool], Tuple[torch.Tensor, torch.Tensor]] = {}
        self._scalars: Dict[Tuple[float, torch.dtype], torch.Tensor] = {}
        self._paired: Dict[str, object] = {}
        self.phase_level0 = phase_level0
        self._phase = self._phase_prep(phase_level0) if phase_level0 else None

    # -- primitives ---------------------------------------------------------

    def _scalar(self, s: float, dtype=torch.float32) -> torch.Tensor:
        """`s` as a 0-dim tensor on the device, made once."""
        key = (s, dtype)
        if key not in self._scalars:
            self._scalars[key] = _scalar(s, self.device, dtype)
        return self._scalars[key]

    def _deq(self, v: torch.Tensor, s) -> torch.Tensor:
        """Dequantize by encoding: None = float already; a float = int8 at
        that scale, multiplied in bf16 by bf16(s); ('u4s', s4) = shifted-u4,
        (q + 8) * s4 in f32, rounded to bf16."""
        if s is None:
            return v
        with span("quant.convert"):
            if isinstance(s, tuple):
                return ((v.float() + 8.0) * self._scalar(s[1])).to(torch.bfloat16)
            return v.to(torch.bfloat16) * self._scalar(s, torch.bfloat16)

    def _quantize(self, v: torch.Tensor, s: float) -> torch.Tensor:
        with span("quant.convert"):
            return quantize_activations(v, self._scalar(s))

    def _epilogue_vectors(self, name: str, s_in: float, paired: bool = False):
        """alpha = s_in * s_w / s_out and beta = bias / s_out in f32,
        computed on the CPU as JAX computes them, then kept on the device;
        each twice over (`paired`) for the block-diagonal kernel. An int4
        conv's s_out is its calibrated scale x 127/15 (shifted-u4 out)."""
        key = (name, s_in, paired)
        if key not in self._epilogues:
            if name in self.qp.q4names:
                _, s_w, bias = self.qp.q4conv[name]
                s_out = self.qp.scales[name] * _U4
            else:
                _, s_w, bias = self.qp.qconv[name]
                s_out = self.qp.scales[name]
            alpha = (s_in * s_w / s_out).float()
            beta = (bias / s_out).float()
            if paired:
                alpha, beta = torch.cat([alpha, alpha]), torch.cat([beta, beta])
            self._epilogues[key] = (alpha.to(self.device), beta.to(self.device))
        return self._epilogues[key]

    @staticmethod
    def _blockdiag(k: torch.Tensor, ci_dim: int = -2, co_dim: int = -1) -> torch.Tensor:
        """`k` with its input and output channel dims doubled and `k` on the
        diagonal: a conv of the channel-paired tensor (two images side by
        side in the channels) that keeps the images independent."""
        z = torch.zeros_like(k)
        return torch.cat([torch.cat([k, z], co_dim), torch.cat([z, k], co_dim)], ci_dim)

    def _paired_weights(self, name: str):
        """The block-diagonal form of `name`'s weights on the device, made
        once: the int8 HWIO kernel of a quantized conv, else (kernel, bias)
        of a float conv (OIHW) or of the head ([C, O])."""
        if name not in self._paired:
            if name in self.qp.qnames:
                self._paired[name] = self._blockdiag(self._wq[name])
            else:
                k, b = self._head if name == "head" else self._fconv[name]
                dims = (0, 1) if name == "head" else (1, 0)
                self._paired[name] = (self._blockdiag(k, *dims), torch.cat([b, b]))
        return self._paired[name]

    @functools.cached_property
    def _fconv_hwio(self) -> Dict[str, torch.Tensor]:
        """K1's bf16 HWIO kernels of the float 3x3 convs, built once, on the
        first forward that takes K1; an engine off K1 never builds them."""
        return {name: k.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
                for name, (k, _) in self._fconv.items()}

    def _conv_f(self, name: str, v: torch.Tensor, paired: bool = False) -> torch.Tensor:
        if self._k1 and not paired:
            with span("quant.float"):
                return conv3x3_k1(v.to(torch.bfloat16).contiguous(), self._fconv_hwio[name],
                                  self._fconv[name][1])
        k, b = self._paired_weights(name) if paired else self._fconv[name]
        with span("quant.float"):
            with tf32_for_bf16_values():
                y = F.conv2d(v.to(torch.bfloat16).float().permute(0, 3, 1, 2), k)
            return torch.relu(y.permute(0, 2, 3, 1) + b).to(torch.bfloat16)

    def _conv(self, name: str, v: torch.Tensor, s_in, paired: bool = False):
        """One 3x3 conv + ReLU. (v, s_in) -> (v, s_out); s None = float
        (bf16), a float = int8 at that scale, ('u4s', s4) = shifted-u4.
        `paired`: v holds two batch images side by side in the channels, and
        the conv runs with the block-diagonal kernel."""
        qp = self.qp
        if name in qp.q4names:
            # inputs are post-ReLU here (the decoder conv1s take
            # _conv_i4_split), so the shifted-u4 encoding applies
            if isinstance(s_in, tuple):            # chained u4s
                s_in4 = s_in[1]
            elif s_in is None:
                s_in4 = qp.scales[self._input_scale_key(name)] * _U4
                with span("quant.convert"):
                    v = quantize_activations_u4s(v, self._scalar(s_in4))
            else:                                  # int8 at scale s_in
                s_in4 = s_in * _U4
                with span("quant.convert"):
                    v = requantize_i8_to_u4s(v, s_in, s_in4)
            alpha, beta = self._epilogue_vectors(name, s_in4)
            y = conv3x3_int4_xla(v, self._wq4[name], alpha, beta, out_kind="u4s",
                                 shifted=True)
            return y, ("u4s", qp.scales[name] * _U4)
        if name not in qp.qnames:
            return self._conv_f(name, self._deq(v, s_in), paired=paired), None
        with span("quant.convert"):
            if isinstance(s_in, tuple):
                # u4s feeding an int8 conv: requantize to the tensor's
                # calibrated int8 scale (the exact requantize of the
                # dequantized value)
                s4, s_in = s_in[1], qp.scales[self._input_scale_key(name)]
                v = requantize_u4s_to_i8(v, s4, s_in)
            elif s_in is None:
                s_in = qp.scales[self._input_scale_key(name)]
                v = self._quantize(v, s_in)
            v = v.contiguous()
        alpha, beta = self._epilogue_vectors(name, s_in, paired)
        w_q = self._paired_weights(name) if paired else self._wq[name]
        if self.layer_impl.get(name, self.impl) == "xla":
            return conv3x3_int8_xla(v, w_q, alpha, beta, out_kind="int8"), qp.scales[name]
        y = conv3x3_fused(v, w_q, alpha, beta, out_kind="int8",
                          block_rows=self.block_rows,
                          variant="auto" if self.block_rows is None else "nconcat")
        return y, qp.scales[name]

    def _conv_i4_split(self, d: int, u: torch.Tensor, skip):
        """The int4 decoder conv1 without building the concat: the kernel
        splits by source along Cin ([skip | up], the concat's order), each
        source at its own 4-bit scale (the skip post-ReLU in shifted-u4, the
        signed upconv output in s4), and the two int32 sums meet in f32."""
        qp = self.qp
        name = f"dec{d}_conv1"
        w_q = self._wq4[name]
        c_skip = qp.cfg.widths[d]
        sk, sk_s = skip
        s_up4 = qp.scales[f"up{d}"] * _S4
        with span("quant.convert"):
            if isinstance(sk_s, tuple):
                s_sk4 = sk_s[1]
            elif sk_s is None:
                s_sk4 = qp.scales[f"enc{d}_conv2"] * _U4
                sk = quantize_activations_u4s(sk, self._scalar(s_sk4))
            else:
                s_sk4 = sk_s * _U4
                sk = requantize_i8_to_u4s(sk, sk_s, s_sk4)
            # shifted-u4 stores a zero activation as -8: the parity variant's
            # pad fills -8, or the +8 * sum(w) correction would add a phantom
            # activation across the padded region
            sk = center_crop_or_pad(sk, u.shape[1:3], fill=-8)
            u_q = quantize_activations_s4(u, self._scalar(s_up4))
        acc_sk = conv3x3_int4_acc(sk, w_q[:, :, :c_skip], shifted=True)
        acc_up = conv3x3_int4_acc(u_q, w_q[:, :, c_skip:], shifted=False)
        # two products and a sum, each rounded to f32, as JAX rounds them
        t = acc_sk.float() * self._scalar(s_sk4) + acc_up.float() * self._scalar(s_up4)
        alpha, beta = self._epilogue_vectors(name, 1.0)   # s_w / s_out4: 1.0 * s_w is exact
        return int4_epilogue(t, alpha, beta, out_kind="u4s"), ("u4s", qp.scales[name] * _U4)

    def _upconv(self, name: str, v: torch.Tensor) -> torch.Tensor:
        """2x2 stride-2 transposed conv, f32 sums of bf16 values, + f32 bias,
        one bf16 rounding."""
        wt, b = self._up[name]
        with span("quant.float"):
            x = v.to(torch.bfloat16).float()
            with tf32_for_bf16_values():
                if self.upconv_impl == "matmul":
                    bsz, h, w, cin = x.shape
                    co = wt.shape[1]
                    y = x.reshape(-1, cin) @ wt.permute(0, 2, 3, 1).reshape(cin, 4 * co)
                    y = (y.reshape(bsz, h, w, 2, 2, co) + b).to(torch.bfloat16)
                    return y.permute(0, 1, 3, 2, 4, 5).reshape(bsz, 2 * h, 2 * w, co)
                y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=2)
            return (y.permute(0, 2, 3, 1) + b).to(torch.bfloat16)

    # -- the phase-packed level 0 -------------------------------------------

    def _phase_prep(self, mode: str) -> Dict[str, tuple]:
        """Level 0's parameters in their packed forms on the device, once:
        packed kernels (int8 HWIO for the int8 convs, bf16-valued OIHW for
        the float ones), epilogue vectors lifted to the phase-major channel
        order by ``np.tile(v, 4)`` (numpy f32, as the JAX package computes
        them), up0 as one matmul, and dec0_conv1 split by source."""
        qp, dev = self.qp, self.device
        w0 = qp.cfg.widths[0]
        bad_q4 = sorted(qp.q4names & set(_LEVEL0_CONVS))
        if bad_q4:
            raise ValueError("phase_level0 serves level 0 in bf16/int8; int4 level-0 convs "
                             f"are unsupported (q4names contains: {bad_q4})")
        if (mode == "int8"
                or not {"enc0_conv2", "dec0_conv1", "dec0_conv2"}.isdisjoint(qp.qnames)):
            missing = [k for k in ("enc0_conv1", "enc0_conv2", "up0", "dec0_conv1",
                                   "dec0_conv2") if k not in qp.scales]
            if missing:
                raise ValueError("phase_level0 needs the full calibration scale set "
                                 f"(calibrate() records it); missing: {missing}")
        if "enc0_conv1" in qp.qnames:
            raise ValueError("phase_level0 runs enc0_conv1 in bf16 (its packed cin is 4); "
                             "build the QuantParams with enc0_conv1 outside qnames")

        def np32(t) -> np.ndarray:
            return t.float().numpy()

        def packed_f(kernel: np.ndarray, bias: np.ndarray):
            k = torch.from_numpy(ph.phase_pack_kernel(kernel)).to(torch.bfloat16).float()
            return (k.permute(3, 2, 0, 1).contiguous().to(dev),
                    torch.from_numpy(np.tile(bias, 4)).to(dev))

        def pack_i8(w_q: torch.Tensor) -> torch.Tensor:
            k = ph.phase_pack_kernel(w_q.numpy().astype(np.int32)).astype(np.int8)
            return torch.from_numpy(k).to(dev)

        def fold(s_in: float, s_w: np.ndarray, bias: np.ndarray, s_out: float):
            """alpha = s_in * s_w / s_out and beta = bias / s_out, tiled."""
            alpha = np.tile(np.asarray(s_in * s_w, np.float32) / s_out, 4)
            beta = np.tile(np.asarray(bias, np.float32) / s_out, 4)
            return torch.from_numpy(alpha).to(dev), torch.from_numpy(beta).to(dev)

        P: Dict[str, tuple] = {}
        k1, b1 = qp.fconv["enc0_conv1"]
        P["enc0_conv1"] = packed_f(np32(k1), np32(b1))

        def level0_pair(name: str, s_in_key: str) -> tuple:
            if name in qp.qnames:          # the production int8 weights
                w_q, s_w, bias = qp.qconv[name]
            elif mode == "int8":
                k, bias = qp.fconv[name]
                w_q, s_w = quantize_weights(k.float())
            else:
                return ("bf16",) + packed_f(*(np32(t) for t in qp.fconv[name]))
            alpha, beta = fold(qp.scales[s_in_key], np32(s_w), np32(bias), qp.scales[name])
            return ("int8", pack_i8(w_q), alpha, beta, qp.scales[name])

        P["enc0_conv2"] = level0_pair("enc0_conv2", "enc0_conv1")
        P["dec0_conv2"] = level0_pair("dec0_conv2", "dec0_conv1")

        ku, bu = qp.fconv["up0"]
        m, bm = ph.phase_upconv_weights(np32(ku), np32(bu))
        P["up0"] = (torch.from_numpy(m.copy()).to(torch.bfloat16).float().to(dev),
                    torch.from_numpy(bm).to(dev))

        # dec0_conv1 split by source (skip | up, the concat's order); the int8
        # halves share the whole kernel's per-output-channel weight scales
        if "dec0_conv1" in qp.qnames:
            w_q, s_w, bias = qp.qconv["dec0_conv1"]
            s_sk, s_up = qp.scales["enc0_conv2"], qp.scales["up0"]
            s_out = qp.scales["dec0_conv1"]
            a_sk, beta = fold(s_sk, np32(s_w), np32(bias), s_out)
            a_up, _ = fold(s_up, np32(s_w), np32(bias), s_out)
            P["dec0_conv1"] = ("int8", pack_i8(w_q[:, :, :w0]), pack_i8(w_q[:, :, w0:]),
                               a_sk, a_up, beta, s_out, s_sk, s_up)
        else:
            k, b = (np32(t) for t in qp.fconv["dec0_conv1"])
            ksk, bb = packed_f(k[:, :, :w0], b)
            kup, _ = packed_f(k[:, :, w0:], np.zeros_like(b))
            P["dec0_conv1"] = ("bf16", ksk, kup, bb)
        kh, bh = qp.fconv["head"]              # [1, 1, C, O]: the per-phase matmul
        P["head"] = (kh.float().to(dev), bh.to(dev))
        return P

    def _conv_packed_f(self, v: torch.Tensor, k: torch.Tensor, b: torch.Tensor
                       ) -> torch.Tensor:
        """relu(conv2x2(v, k) + b) of bf16 values summed in f32 (k packed
        OIHW), one bf16 rounding: a packed float conv."""
        with span("quant.float"):
            with tf32_for_bf16_values():
                y = F.conv2d(v.to(torch.bfloat16).float().permute(0, 3, 1, 2), k)
            return torch.relu(y.permute(0, 2, 3, 1) + b).to(torch.bfloat16)

    def _conv_packed_i8(self, name: str, v: torch.Tensor, spec: tuple) -> torch.Tensor:
        """A packed int8 conv (int8 in, int8 out): the Hopper kernel under
        'pallas', the library route under 'xla'."""
        _, wp, alpha, beta, _ = spec
        with span("quant.convert"):
            v = v.contiguous()
        if self.layer_impl.get(name, self.impl) == "xla":
            return conv3x3_int8_xla(v, wp, alpha, beta, out_kind="int8")
        return conv_rows3_col(v, wp, alpha, beta)

    def _phase_dec0(self, v: torch.Tensor, s, skip, cut) -> torch.Tensor:
        """Packed dec0: up0 as one matmul (its output already packed), the
        concat as two split-kernel convs (each source at its own scale), the
        packed dec0 convs and the head; depth-to-space only on the logits."""
        qp, P = self.qp, self._phase
        km, bm = P["up0"]
        with span("quant.float"), tf32_for_bf16_values():
            u = (self._deq(v, s).to(torch.bfloat16).float() @ km + bm).to(torch.bfloat16)
        if cut("up0", u):
            return u
        sk_p, sk_s = skip
        # the full-resolution margin is the packed sizes' difference
        with span("quant.convert"):
            skc = ph.phase_crop(sk_p, sk_p.shape[1] - u.shape[1])
        spec = P["dec0_conv1"]
        if spec[0] == "int8":
            _, wsk, wup, a_sk, a_up, beta, s_out, s_sk, s_up = spec
            sk_q = skc if sk_s is not None else self._quantize(skc, s_sk)
            acc = (conv_int8_acc(sk_q, wsk).float() * a_sk
                   + conv_int8_acc(self._quantize(u, s_up), wup).float() * a_up)
            y = torch.relu(acc + beta)
            v, s = torch.round(y).clamp_(0.0, 127.0).to(torch.int8), s_out
        else:
            _, ksk, kup, bb = spec
            with span("quant.float"):
                skb = self._deq(skc, sk_s).to(torch.bfloat16).float().permute(0, 3, 1, 2)
                with tf32_for_bf16_values():
                    acc = F.conv2d(skb, ksk) + F.conv2d(u.float().permute(0, 3, 1, 2), kup)
                v, s = torch.relu(acc.permute(0, 2, 3, 1) + bb).to(torch.bfloat16), None
        if cut("dec0_conv1", v):
            return v
        spec = P["dec0_conv2"]
        if spec[0] == "int8":
            if s is None:
                v = self._quantize(v, qp.scales["dec0_conv1"])
            v, s = self._conv_packed_i8("dec0_conv2", v, spec), spec[4]
        else:
            v, s = self._conv_packed_f(self._deq(v, s), *spec[1:]), None
        if cut("dec0_conv2", v):
            return v
        kh, bh = P["head"]
        with span("quant.float"):
            with tf32_for_bf16_values():
                y = ph.phase_head_matmul(self._deq(v, s).to(torch.bfloat16), kh, bh)
            return ph.depth_to_space(y)

    def _input_scale_key(self, name: str) -> str:
        """Calibration key of a quantized conv's float input tensor (the
        producing tensor: pooling keeps the scale)."""
        if name == "enc0_conv1":
            return "input"
        if name.startswith("dec") and name.endswith("_conv1"):
            return name + ":cat"
        if name.endswith("_conv2"):
            return name[:-1] + "1"
        if name == "bottleneck_conv1":
            return f"enc{self.qp.cfg.depth - 1}_conv2"
        d = int(name[3])           # enc{d}_conv1, d > 0
        return f"enc{d - 1}_conv2"

    # -- forward ------------------------------------------------------------

    @torch.inference_mode()
    def apply(self, x: torch.Tensor, stop_after: Optional[str] = None) -> torch.Tensor:
        """x [B, H, W, 1] f32 (normalized) -> f32 logits, U-Net geometry.

        `stop_after`: return the tensor right after the named stage
        ('enc{d}_conv{i}', 'pool{d}', 'bottleneck_conv{i}', 'up{d}',
        'dec{d}_conv{i}'): int8 after a quantized conv, bf16 otherwise;
        level 0's stages packed under `phase_level0`."""
        cfg, qp = self.qp.cfg, self.qp

        def cut(name, t):
            return stop_after is not None and name == stop_after

        def capture_skip(d, v, s):
            """A float skip feeding a quantized decoder conv is stored
            quantized at once (quantize and crop commute): int8 at the
            concat scale, or shifted-u4 at its own scale for an int4 conv."""
            key = f"dec{d}_conv1:cat"
            if s is None and f"dec{d}_conv1" in qp.qnames and key in qp.scales:
                return self._quantize(v, qp.scales[key]), qp.scales[key]
            if (s is None and f"dec{d}_conv1" in qp.q4names
                    and f"enc{d}_conv2" in qp.scales):
                s4 = qp.scales[f"enc{d}_conv2"] * _U4
                with span("quant.convert"):
                    return quantize_activations_u4s(v, self._scalar(s4)), ("u4s", s4)
            return v, s

        with span("quant.convert"):
            v, s = x.to(self.device, torch.float32).to(torch.bfloat16), None
        skips = []
        for d in range(cfg.depth):
            if d == 0 and self._phase is not None:
                P = self._phase
                y = self._conv_packed_f(ph.space_to_depth(v), *P["enc0_conv1"])
                if cut("enc0_conv1", y):       # packed [.., 4 * w0]
                    return y
                spec = P["enc0_conv2"]
                if spec[0] == "int8":
                    v, s = self._conv_packed_i8("enc0_conv2", self._quantize(
                        y, qp.scales["enc0_conv1"]), spec), spec[4]
                else:
                    v, s = self._conv_packed_f(y, *spec[1:]), None
                if cut("enc0_conv2", v):       # packed
                    return v
                skips.append((v, s))           # packed, at its own scale
                v = ph.phase_pool(v)           # exits the packed domain
                if cut("pool0", v):
                    return v
                continue
            v, s = self._conv(f"enc{d}_conv1", v, s)
            if cut(f"enc{d}_conv1", v):
                return v
            v, s = self._conv(f"enc{d}_conv2", v, s)
            if cut(f"enc{d}_conv2", v):
                return v
            if cfg.skip_variant == "paper":
                skips.append(capture_skip(d, v, s))
            v = _max_pool2(v)              # order-preserving: valid on int8
            if cfg.skip_variant == "parity":
                skips.append(capture_skip(d, v, s))
            if cut(f"pool{d}", v):
                return v
        v, s = self._conv("bottleneck_conv1", v, s)
        if cut("bottleneck_conv1", v):
            return v
        v, s = self._conv("bottleneck_conv2", v, s)
        if cut("bottleneck_conv2", v):
            return v

        for d in reversed(range(cfg.depth)):
            if d == 0 and self._phase is not None:
                return self._phase_dec0(v, s, skips[0], cut)
            u = self._upconv(f"up{d}", self._deq(v, s))
            if cut(f"up{d}", u):
                return u
            sk, sk_s = skips[d]
            name = f"dec{d}_conv1"
            if name in qp.q4names:
                v, s = self._conv_i4_split(d, u, skips[d])
            elif name in qp.qnames:
                # the concat in int8: the int8 skip is requantized directly
                # (round(q * sk_s / s_cat) is the requantize of its
                # dequantized value) and the bf16 upconv output quantized
                s_cat = qp.scales[name + ":cat"]
                with span("quant.convert"):
                    if sk_s is None:
                        sk_q = self._quantize(sk, s_cat)
                    elif isinstance(sk_s, tuple):  # a u4s skip from an int4 conv
                        sk_q = requantize_u4s_to_i8(sk, sk_s[1], s_cat)
                    elif sk_s == s_cat:
                        sk_q = sk
                    else:
                        ratio = self._scalar(float(np.float32(sk_s / s_cat)))
                        sk_q = torch.round(sk.float() * ratio).clamp_(-127.0, 127.0)
                        sk_q = sk_q.to(torch.int8)
                    sk_q = center_crop_or_pad(sk_q, u.shape[1:3])
                    cat = torch.cat([sk_q, self._quantize(u, s_cat)], dim=-1)
                v, s = self._conv(name, cat, s_cat)
            else:
                sk = center_crop_or_pad(self._deq(sk, sk_s), u.shape[1:3])
                v, s = self._conv(name, torch.cat([sk, u], dim=-1), None)
            if cut(name, v):
                return v
            v, s = self._conv(f"dec{d}_conv2", v, s)
            if cut(f"dec{d}_conv2", v):
                return v

        k, b = self._head
        with span("quant.float"):
            with tf32_for_bf16_values():
                y = self._deq(v, s).float() @ k
            return y + b


def calibration_batch(images, size: int = 188, n: int = 2) -> torch.Tensor:
    """Normalized [n, size, size, 1] f32 center crops of eval images for
    `calibrate`. Each whole image is normalized first, then cropped, as
    serving normalizes whole images before tiling."""
    out = []
    for img in list(images)[:max(n, 1)]:
        a = np.asarray(img, np.float32)
        a = (a - a.min()) / max(np.ptp(a), 1e-12)
        h, w = a.shape
        if h < size or w < size:
            a = np.pad(a, ((0, max(0, size - h)), (0, max(0, size - w))),
                       mode="reflect")
            h, w = a.shape
        y0, x0 = (h - size) // 2, (w - size) // 2
        out.append(a[y0:y0 + size, x0:x0 + size])
    return torch.from_numpy(np.ascontiguousarray(np.stack(out)[..., None]))


def add_concat_scales(cfg: ModelConfig, scales: Dict[str, float]) -> Dict[str, float]:
    """Each decoder concat's scale from its two sources: max(skip post-ReLU
    scale, |upconv| scale). Skip source: enc{d}_conv2."""
    out = dict(scales)
    for d in range(cfg.depth):
        if f"enc{d}_conv2" in scales and f"up{d}" in scales:
            out[f"dec{d}_conv1:cat"] = max(scales[f"enc{d}_conv2"], scales[f"up{d}"])
    return out


def save_quant_params(path: str, qp: QuantParams) -> None:
    """Write `qp` to one .npz, in the JAX package's format (bf16 tensors
    stored as f32), so either package serves it."""
    arrays = {}
    for name, (w_q, s_w, bias) in qp.qconv.items():
        arrays[f"q:{name}:w"] = w_q.cpu().numpy()
        arrays[f"q:{name}:s"] = s_w.cpu().numpy()
        arrays[f"q:{name}:b"] = bias.cpu().numpy()
    for name, (w_q, s_w, bias) in qp.q4conv.items():
        arrays[f"q4:{name}:w"] = w_q.cpu().numpy()
        arrays[f"q4:{name}:s"] = s_w.cpu().numpy()
        arrays[f"q4:{name}:b"] = bias.cpu().numpy()
    for name, (k, b) in qp.fconv.items():
        arrays[f"f:{name}:k"] = k.cpu().float().numpy()
        arrays[f"f:{name}:b"] = b.cpu().numpy()
    meta = {
        "cfg": dataclasses.asdict(qp.cfg),
        "qnames": sorted(qp.qnames),
        "q4names": sorted(qp.q4names),
        "scales": qp.scales,
    }
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    if not path.endswith(".npz"):
        path += ".npz"         # np.savez appends it anyway; keep load symmetric
    np.savez(path, **arrays)


def load_quant_params(path: str) -> QuantParams:
    """Inverse of `save_quant_params`; reads the JAX package's files too."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path += ".npz"
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        cfg = ModelConfig(**meta["cfg"])
        qconv, fconv, q4conv = {}, {}, {}
        for key in z.files:
            kind, _, rest = key.partition(":")
            if kind in ("q", "q4") and rest.endswith(":w"):
                name = rest[:-2]
                (qconv if kind == "q" else q4conv)[name] = tuple(
                    torch.from_numpy(np.array(z[f"{kind}:{name}:{x}"])) for x in "wsb")
            elif kind == "f" and rest.endswith(":k"):
                name = rest[:-2]
                k = torch.from_numpy(np.array(z[f"f:{name}:k"], np.float32))
                fconv[name] = (k if name in _LEVEL0_CONVS else k.to(torch.bfloat16),
                               torch.from_numpy(np.array(z[f"f:{name}:b"])))
    return QuantParams(cfg=cfg, qnames=frozenset(meta["qnames"]),
                       scales=dict(meta["scales"]), qconv=qconv, fconv=fconv,
                       q4names=frozenset(meta.get("q4names", ())), q4conv=q4conv)


def build_quant_inference(model, sample_batch, min_channels: int = 128,
                          impl: str = "xla", block_rows: Optional[int] = None,
                          interpret: Optional[bool] = None,
                          layer_impl: Optional[Dict[str, str]] = None,
                          phase_level0: Optional[str] = None,
                          int4: bool = False,
                          int4_names: Optional[FrozenSet[str]] = None,
                          ) -> QuantInference:
    """Calibrate the port UNet `model` (which holds its weights) on
    `sample_batch`, quantize it, and build the engine on the model's
    device. A model under ``cfg.phase_level0`` is calibrated through its
    packed forward, as the JAX package's is: its level-0 outputs are the
    same values in another order. `int4=True` serves `default_int4_names`
    in int4; `int4_names` names the int4 set instead."""
    cfg = model.cfg
    scales = add_concat_scales(cfg, calibrate(model, sample_batch))
    if int4_names is None and int4:
        int4_names = default_int4_names(cfg, min_channels)
    qp = prepare_quant_params(cfg, model, scales, default_quant_names(cfg, min_channels),
                              q4names=int4_names)
    return QuantInference(qp, impl=impl, block_rows=block_rows, interpret=interpret,
                          layer_impl=layer_impl, phase_level0=phase_level0,
                          device=_model_device(model))
