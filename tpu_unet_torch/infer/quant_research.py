"""The research formulations of the int8 serving forward (counterpart of
``tpu_unet/infer/quant_research.py``): ``ResearchQuantInference``.

Two level-0 formulations that the JAX package built, tested and measured
slower than its production forward on its TPU (their times on the H100
are in PERF.md), kept runnable beside the production
``QuantInference.apply`` (infer/quant.py), which stays free of their
branches:

* ``pair_level0``: fold batch image i and image i + B/2 into the channels
  at level 0 (K6a, `ops.interleave.pair_batch_channels`), run the level-0
  convs with block-diagonal kernels, unpair after the pool (K6b), and run
  the dec0 tail and the head paired, interleaving the paired skip with the
  paired upconv output (K6c);
* ``fused_enc0`` / ``fused_concat``: enc0's conv + conv + pool (and the
  int8 capture of the paper skip) as one kernel (K4,
  `ops.fused_level0.enc0_chain`), and each quantized decoder concat +
  requantize as one kernel (K5, `ops.fused_level0.concat_quantize`).

On a CPU tensor each kernel's wrapper runs its plain version; on the card
it launches the kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tpu_unet_torch.infer.quant import QuantInference, QuantParams
from tpu_unet_torch.models.unet import _max_pool2, center_crop_or_pad
from tpu_unet_torch.ops.conv_tiles import tf32_for_bf16_values
from tpu_unet_torch.ops.fused_level0 import concat_quantize, enc0_chain
from tpu_unet_torch.ops.interleave import (interleave_pairs, pair_batch_channels,
                                           unpair_batch_channels)


class ResearchQuantInference(QuantInference):
    """QuantInference plus the research level-0 formulations.

    Accepts every production argument, plus:
      pair_level0      fold batch pairs into channels at level 0
      fused_enc0       run enc0 conv1 + conv2 + pool0 as one kernel (K4)
      fused_concat     run each quantized decoder concat as one kernel (K5)
      fused_enc0_opts  enc0_chain's knobs (block_rows, block_cols,
                       pool_mode), checked and passed on
    With none of the three flags, `apply` is the production forward."""

    def __init__(self, qp: QuantParams, *, pair_level0: bool = False,
                 fused_enc0: bool = False, fused_concat: bool = False,
                 fused_enc0_opts: Optional[Dict[str, object]] = None, **kwargs):
        # The conflicts are checked first, as ValueErrors, as the JAX
        # package's are.
        research = pair_level0 or fused_enc0 or fused_concat
        if kwargs.get("phase_level0") and research:
            raise ValueError("phase_level0 is a level-0 formulation of its own; combine it "
                             "with none of pair_level0/fused_enc0/fused_concat")
        if qp.q4names and research:
            raise ValueError("the int4 serving path composes with the production "
                             "formulations (phase_level0, plain int8) only; not with "
                             "pair_level0/fused_enc0/fused_concat")
        super().__init__(qp, **kwargs)
        self.pair_level0 = pair_level0
        self.fused_enc0 = fused_enc0
        self.fused_concat = fused_concat
        self.fused_enc0_opts = dict(fused_enc0_opts or {})
        self._enc0 = None

    def _enc0_weights(self):
        """enc0's kernels as bf16 HWIO and its f32 biases on the device,
        made once: the values the JAX package hands enc0_chain."""
        if self._enc0 is None:
            self._enc0 = tuple(
                t.to(self.device, dtype) for name in ("enc0_conv1", "enc0_conv2")
                for t, dtype in zip(self.qp.fconv[name], (torch.bfloat16, torch.float32)))
        return self._enc0

    # -- forward (all formulations interleaved, as the JAX package's) --------

    @torch.inference_mode()
    def apply(self, x: torch.Tensor, stop_after: Optional[str] = None) -> torch.Tensor:
        """x [B, H, W, 1] f32 (normalized) -> f32 logits; the production
        apply's contract, through the research formulations that are on."""
        if not (self.pair_level0 or self.fused_enc0 or self.fused_concat):
            return super().apply(x, stop_after=stop_after)
        cfg, qp = self.qp.cfg, self.qp
        bsz = x.shape[0]
        pair0 = (self.pair_level0 and bsz % 2 == 0 and bsz > 1
                 and "enc0_conv1" not in qp.qnames and "enc0_conv2" not in qp.qnames)

        # The 1-channel input and the 2-channel logits stay on torch.cat.
        def pair(t):          # [B, H, W, C] -> [B/2, H, W, 2C]: image i with i + B/2
            if t.shape[-1] < 8:
                return torch.cat([t[:bsz // 2], t[bsz // 2:]], dim=-1)
            return pair_batch_channels(t)

        def unpair(t):
            c = t.shape[-1] // 2
            if c < 8:
                return torch.cat([t[..., :c], t[..., c:]], dim=0)
            return unpair_batch_channels(t)

        def cut(name):
            return stop_after is not None and name == stop_after

        def capture_skip(d, v, s):
            key = f"dec{d}_conv1:cat"
            if s is None and f"dec{d}_conv1" in qp.qnames and key in qp.scales:
                return self._quantize(v, qp.scales[key]), qp.scales[key]
            return v, s

        v, s = x.to(self.device, torch.float32).to(torch.bfloat16), None
        skips = []
        paired_skip = None
        fused_enc0 = (self.fused_enc0 and stop_after is None and not pair0
                      and cfg.skip_variant == "paper" and cfg.in_channels == 1
                      and "enc0_conv1" not in qp.qnames and "enc0_conv2" not in qp.qnames)
        for d in range(cfg.depth):
            if d == 0 and fused_enc0:
                key = "dec0_conv1:cat"
                s_skip = (qp.scales[key] if "dec0_conv1" in qp.qnames and key in qp.scales
                          else 0.0)
                skip, v = enc0_chain(v, *self._enc0_weights(), skip_scale=s_skip,
                                     **self.fused_enc0_opts)
                skips.append((skip, s_skip if s_skip else None))
                s = None
                continue
            if d == 0 and pair0:
                vp = self._conv_f("enc0_conv1", pair(v), paired=True)
                if cut("enc0_conv1"):
                    return vp
                vp = self._conv_f("enc0_conv2", vp, paired=True)
                if cut("enc0_conv2"):
                    return vp
                if cfg.skip_variant == "paper":
                    paired_skip = vp
                vp = _max_pool2(vp)
                if cfg.skip_variant == "parity":
                    paired_skip = vp
                skips.append((None, None))       # dec0 reads paired_skip instead
                v, s = unpair(vp), None
                if cut("pool0"):
                    return v
                continue
            v, s = self._conv(f"enc{d}_conv1", v, s)
            if cut(f"enc{d}_conv1"):
                return v
            v, s = self._conv(f"enc{d}_conv2", v, s)
            if cut(f"enc{d}_conv2"):
                return v
            if cfg.skip_variant == "paper":
                skips.append(capture_skip(d, v, s))
            v = _max_pool2(v)
            if cfg.skip_variant == "parity":
                skips.append(capture_skip(d, v, s))
            if cut(f"pool{d}"):
                return v
        v, s = self._conv("bottleneck_conv1", v, s)
        if cut("bottleneck_conv1"):
            return v
        v, s = self._conv("bottleneck_conv2", v, s)
        if cut("bottleneck_conv2"):
            return v

        for d in reversed(range(cfg.depth)):
            u = self._upconv(f"up{d}", self._deq(v, s))
            if cut(f"up{d}"):
                return u
            sk, sk_s = skips[d]
            name = f"dec{d}_conv1"
            if d == 0 and paired_skip is not None:
                # The paired tail: pair the upconv output, interleave it with
                # the paired skip into each image's [skip | up] layout, run
                # dec0 and the head with block-diagonal kernels, and unpair
                # only the logits.
                skp = center_crop_or_pad(paired_skip, u.shape[1:3])
                if name in qp.qnames:
                    # quantized before the interleave: it then moves int8
                    s_cat = qp.scales[name + ":cat"]
                    cat_p = interleave_pairs(self._quantize(skp, s_cat),
                                             pair(self._quantize(u, s_cat)))
                    v, s = self._conv(name, cat_p, s_cat, paired=True)
                else:
                    v, s = self._conv(name, interleave_pairs(skp, pair(u)), None,
                                      paired=True)
                if cut("dec0_conv1"):
                    return v
                v, s = self._conv("dec0_conv2", v, s, paired=True)
                if cut("dec0_conv2"):
                    return v
                k, b = self._paired_weights("head")
                with tf32_for_bf16_values():
                    y = self._deq(v, s).float() @ k
                return unpair(y + b)
            if name in qp.qnames:
                s_cat = qp.scales[name + ":cat"]
                if sk_s is None:
                    sk_q = self._quantize(sk, s_cat)
                elif sk_s == s_cat:
                    sk_q = sk
                else:
                    ratio = self._scalar(float(np.float32(sk_s / s_cat)))
                    sk_q = torch.round(sk.float() * ratio).clamp_(-127.0, 127.0)
                    sk_q = sk_q.to(torch.int8)
                sk_q = center_crop_or_pad(sk_q, u.shape[1:3])
                if self.fused_concat:
                    cat = concat_quantize(sk_q, u, s_cat)
                else:
                    cat = torch.cat([sk_q, self._quantize(u, s_cat)], dim=-1)
                v, s = self._conv(name, cat, s_cat)
            else:
                sk = center_crop_or_pad(self._deq(sk, sk_s), u.shape[1:3])
                v, s = self._conv(name, torch.cat([sk, u], dim=-1), None)
            if cut(name):
                return v
            v, s = self._conv(f"dec{d}_conv2", v, s)
            if cut(f"dec{d}_conv2"):
                return v

        k, b = self._head
        with tf32_for_bf16_values():
            y = self._deq(v, s).float() @ k
        return y + b
