"""Operations and bytes of TransUNet R50-ViT-B/16's work, from its shapes
(a configuration's `model` block: reference/transunet.py's keys). The
peaks and `bound_s` are costs.py's.

Operations are the multiply-adds of the convs, the linears and the two
attention products (2 each); norms, activations, softmax, the upsample and
the pooling are not counted (about 0.1% of the total at 512).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmarks import costs

WIDTH = 64


def _out(s: int, k: int, stride: int, pad: int) -> int:
    return (s + 2 * pad - k) // stride + 1


def trunk_convs(m: dict) -> List[Tuple[int, int, int, int]]:
    """(output side, cin, cout, kernel side) of every conv of the ResNet
    trunk, the root's on the 3 channels a one-channel slice is repeated to."""
    s = _out(m["img_size"], 7, 2, 3)
    out = [(s, 3, WIDTH, 7)]
    s = _out(s, 3, 2, 0)                          # the max-pool: 256 -> 127 at 512
    cin = WIDTH
    for st, units in enumerate(m["resnet_units"], 1):
        mid, cout = WIDTH * 2 ** (st - 1), WIDTH * 2 ** (st + 1)
        for u in range(units):
            stride = 2 if (st > 1 and u == 0) else 1
            so = _out(s, 3, stride, 1)
            out += [(s, cin, mid, 1), (so, mid, mid, 3), (so, mid, cout, 1)]
            if u == 0:
                out.append((so, cin, cout, 1))
            s, cin = so, cout
    return out


def vit_ops(m: dict) -> Dict[str, int]:
    """{'linear': the patch conv and the blocks' linears, 'attention': the
    q k^T and p v products} of one slice."""
    n, h, f = (m["img_size"] // 16) ** 2, m["hidden"], m["mlp"]
    lin = 2 * n * WIDTH * 16 * h + m["layers"] * 2 * n * (4 * h * h + 2 * h * f)
    return {"linear": lin, "attention": m["layers"] * 2 * 2 * n * n * h}


def decoder_convs(m: dict) -> List[Tuple[int, int, int]]:
    """(output side, cin, cout) of the decoder's 3x3 convs and the head."""
    s = m["img_size"] // 16
    skips = [c if i < m["n_skip"] else 0 for i, c in enumerate((8 * WIDTH, 4 * WIDTH, WIDTH, 0))]
    out = [(s, m["hidden"], 512)]
    cin = 512
    for cout, sk in zip(m["decoder_channels"], skips):
        s *= 2
        out += [(s, cin + sk, cout), (s, cout, cout)]
        cin = cout
    return out + [(s, cin, m["num_classes"])]


def forward_flops(m: dict) -> Dict[str, int]:
    """Operations of one forward over one slice, by part: {'resnet', 'vit',
    'attention' (inside 'vit'), 'decoder', 'total'} (336.79 GFLOP at 512)."""
    resnet = sum(2 * s * s * ci * co * k * k for s, ci, co, k in trunk_convs(m))
    v = vit_ops(m)
    dec = sum(2 * s * s * ci * co * 9 for s, ci, co in decoder_convs(m))
    vit = v["linear"] + v["attention"]
    return {"resnet": resnet, "vit": vit, "attention": v["attention"], "decoder": dec,
            "total": resnet + vit + dec}


def attention_cost(q: Tuple[int, ...], elem_bytes: int) -> Tuple[int, int]:
    """(bytes, operations) of one attention call on q, k, v of shape
    [B, H, N, d]: q, k, v read and the output written once; 2 * 2 * B * H *
    N^2 * d operations."""
    b, h, n, d = q
    return 4 * b * h * n * d * elem_bytes, 4 * b * h * n * n * d


def attention_bound_s(q: Tuple[int, ...], dtype: str) -> float:
    """The least seconds the card could take for one attention call on q,
    k, v of shape `q` in `dtype` ('bfloat16' or 'float32')."""
    nbytes, ops = attention_cost(q, 2 if dtype == "bfloat16" else 4)
    return costs.bound_s(nbytes, ops, "bf16" if dtype == "bfloat16" else "f32")
