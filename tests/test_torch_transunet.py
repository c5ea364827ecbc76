"""TransUNet R50-ViT-B/16 in the port (models/transunet.py) against its
plain float32 reference (models/transunet_ref.py), on seeded random weights
at a small size, and served whole-frame by `TileInference`; the engine's
metrics over class ids.

The small size keeps the trunk's widths (64 to 1024 channels) with 1, 1, 2
units, and narrows the ViT (hidden 64, 4 heads, 2 blocks) and the decoder
(32, 16, 8, 8) at a 64 x 64 input, 9 classes: a 64^2 input takes the odd
path of a 512^2 one (32 -> 15 after the max-pool, stage 1's skip
zero-padded to 16).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tpu_unet_torch.models.transunet as tu
from tpu_unet_torch.config import TransUNetConfig
from tpu_unet_torch.infer.tiles import TileInference
from tpu_unet_torch.losses.metrics import batch_evaluation_metrics
from tpu_unet_torch.models import transunet_ref
from tpu_unet_torch.utils.profiling import trace_capture

SMALL = TransUNetConfig(img_size=64, hidden=64, heads=4, layers=2, mlp=128,
                        resnet_units=(1, 1, 2), decoder_channels=(32, 16, 8, 8),
                        compute_dtype="float32")
#: f32 logits: the port sums in other orders than the reference (one-pass
#: GroupNorm statistics, BatchNorm folded into the weights, the root's
#: input channels summed, fused QKV), ~1e-7 relative a layer over ~60
#: layers; measured max |diff| 2e-6 on logits of magnitude ~1.7.
F32_TOL = 1e-4
#: bf16 logits, RMS gap to the f32 reference over the reference's RMS:
#: the port reads ~0.01 and a run with every conv and linear input and
#: weight in fp8 ~0.10, so the bar sits 3x above the one and 3x below
#: the other.
BF16_BAR = 0.03


def _params(cfg=SMALL, seed=1):
    """Weights from a seed, with norms, BatchNorm statistics and biases away
    from their identities, so that a dropped or misapplied one shows."""
    gen = torch.Generator().manual_seed(seed)
    model = tu.TransUNet(cfg, generator=gen)
    sd = model.state_dict()
    with torch.no_grad():
        for name, t in sd.items():
            if t.dim() == 1:
                z = torch.randn(t.shape, generator=gen)
                t.copy_(torch.exp(0.2 * z) if name.endswith("var") else t + 0.1 * z)
        pos = sd["transformer.embeddings.position_embeddings"]
        pos.copy_(torch.randn(pos.shape, generator=gen))
    return sd


def _model(cfg=SMALL, params=None):
    m = tu.TransUNet(cfg)
    m.load_state_dict(params if params is not None else _params(cfg))
    return m.eval()


def _x(n=2, seed=2):
    return torch.rand(n, 64, 64, 1, generator=torch.Generator().manual_seed(seed))


def _rel_rms(a, b):
    return float((a - b).square().mean().sqrt() / b.square().mean().sqrt())


@pytest.fixture(scope="module")
def reference():
    params = _params()
    x = _x()
    return params, x, transunet_ref.forward(params, x, SMALL)


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
def test_f32_logits_match_the_reference(reference, conv_impl):
    params, x, want = reference
    model = _model(dataclasses.replace(SMALL, conv_impl=conv_impl), params)
    with torch.no_grad():
        got = model(x)
    assert got.shape == (2, 64, 64, 9) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_encode_gives_the_references_tokens(reference):
    """`encode`, the tokens the benchmark's check holds to its reference:
    the ViT's output after its final LN, as the forward computes it."""
    params, x, _ = reference
    model = _model(params=params)
    p = {k: v.float() for k, v in params.items()}
    with torch.no_grad():
        got = model.encode(x)
        want = transunet_ref.vit(p, transunet_ref.resnet(
            p, x.permute(0, 3, 1, 2).repeat(1, 3, 1, 1), SMALL)[0], SMALL)
    assert got.shape == (2, 16, 64)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


def _fp8(t):
    s = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def test_bf16_logits_within_a_bar_fp8_fails(reference, monkeypatch):
    params, x, want = reference
    model = _model(dataclasses.replace(SMALL, compute_dtype="bfloat16", conv_impl="pallas"),
                   params)
    with torch.no_grad():
        bf16 = _rel_rms(model(x), want)
    conv2d, linear = F.conv2d, F.linear
    monkeypatch.setattr(F, "conv2d", lambda x, w, *a, **k: conv2d(_fp8(x), _fp8(w), *a, **k))
    monkeypatch.setattr(F, "linear", lambda x, w, *a, **k: linear(_fp8(x), _fp8(w), *a, **k))
    fp8 = _rel_rms(transunet_ref.forward(params, x, SMALL), want)
    assert bf16 < BF16_BAR < fp8, (bf16, fp8)


def test_the_odd_path_of_a_64_input(reference):
    """32 -> 15 after the pool; stage 1's 15^2 skip enters the decoder
    zero-padded to 16^2, as the reference pads it, and stage 2 runs on the
    unpadded map (15 -> 8)."""
    params, x, _ = reference
    model = _model(params=params)
    with torch.no_grad():
        y, skips = model._resnet(x, model.prepare())
        _, ref_skips = transunet_ref.resnet({k: v.float() for k, v in params.items()},
                                            x.permute(0, 3, 1, 2).repeat(1, 3, 1, 1), SMALL)
    assert [tuple(s.shape[1:3]) for s in skips] == [(8, 8), (15, 15), (32, 32)]
    assert tuple(y.shape[1:3]) == (4, 4)
    assert [tuple(s.shape[2:]) for s in ref_skips] == [(8, 8), (16, 16), (32, 32)]
    padded = tu.bordered_cat([skips[1]], 16, 16)[:, 1:-1, 1:-1]
    assert (padded[:, 15] == 0).all() and (padded[:, :, 15] == 0).all()
    torch.testing.assert_close(padded.permute(0, 3, 1, 2), ref_skips[1], rtol=F32_TOL,
                               atol=F32_TOL)


def test_bn_fold_and_weight_standardisation():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 12, 9, 9, generator=gen)
    w = torch.randn(16, 12, 3, 3, generator=gen)
    gamma, beta, mean = (torch.randn(16, generator=gen) for _ in range(3))
    var = torch.rand(16, generator=gen) + 0.5
    wf, bf = tu.fold_bn(w, gamma, beta, mean, var)
    want = F.batch_norm(F.conv2d(x, w, padding=1), mean, var, gamma, beta, False, 0.0, 1e-5)
    torch.testing.assert_close(F.conv2d(x, wf, bf, padding=1), want, rtol=1e-5, atol=1e-5)
    ws = tu.standardize(w).numpy()
    flat = w.numpy().reshape(16, -1).astype(np.float64)
    want = (flat - flat.mean(1, keepdims=True)) / np.sqrt(flat.var(1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(ws.reshape(16, -1), want, rtol=1e-5, atol=1e-6)


def test_attention_is_the_softmax_formula():
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 3, 17, 8, generator=gen) for _ in range(3))
    want = torch.softmax(q @ k.transpose(-1, -2) / 8 ** 0.5, -1) @ v
    torch.testing.assert_close(tu.attention(q, k, v), want, rtol=1e-5, atol=1e-5)


def test_the_decoder_convs_on_k1_match_a_padded_conv(reference, monkeypatch):
    """Each of the decoder's nine 3x3 conv + BN + ReLU calls, on the CPU
    (K1's plain version), against F.conv2d with padding 1 of the same
    folded weights on the unbordered input."""
    params, x, _ = reference
    model = _model(dataclasses.replace(SMALL, conv_impl="pallas"), params)
    calls = []
    k1 = tu.conv3x3_bias_relu

    def spy(xb, w, b):
        y = k1(xb, w, b)
        calls.append((xb, w, b, y))
        return y

    monkeypatch.setattr(tu, "conv3x3_bias_relu", spy)
    with torch.no_grad():
        model(x)
    assert len(calls) == 9
    for xb, w, b, y in calls:
        inner = xb[:, 1:-1, 1:-1].permute(0, 3, 1, 2)
        want = F.relu(F.conv2d(inner, w.permute(3, 2, 0, 1), b, padding=1)).permute(0, 2, 3, 1)
        assert (xb[:, 0] == 0).all() and (xb[:, :, -1] == 0).all()
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


def test_launches_and_spans_of_a_forward(reference):
    params, x, _ = reference
    model = _model(params=params)
    tu.attention.launches = 0
    with torch.no_grad(), trace_capture() as prof:
        model(x)
    assert tu.attention.launches == 2
    names = [e.name for e in prof.events()]
    for span in ("transunet.resnet", "transunet.vit", "transunet.decoder"):
        assert names.count(span) == 1, span


def test_prepared_weights_follow_a_load(reference):
    params, x, want = reference
    model = _model(params=_params(seed=9))
    with torch.no_grad():
        model(x)
        model.load_state_dict(params)
        torch.testing.assert_close(model(x), want, rtol=F32_TOL, atol=F32_TOL)


def test_the_config_is_checked():
    for bad in ({"n_skip": 4}, {"conv_impl": "triton"}, {"in_channels": 2},
                {"resnet_units": (3, 4)}, {"heads": 5}):
        with pytest.raises(ValueError):
            tu.TransUNet(dataclasses.replace(SMALL, **bad))


# -- the engine ----------------------------------------------------------------

@pytest.mark.parametrize("frames,batch_tiles", [(1, 4), (3, 2)], ids=["one-frame", "filled-chunk"])
def test_engine_serves_whole_frames(reference, frames, batch_tiles):
    """`TileInference` over the same-padded model: one whole-frame tile a
    slice, margin 0; its class maps are the model's own argmax of the
    min/ptp-normalised frames, for one frame and for a chunk filled up."""
    params, _, _ = reference
    model = _model(params=params)
    engine = TileInference(model, 64, 64, batch_tiles=batch_tiles)
    p = engine.plan
    assert (p.num_tiles, p.pad, p.tile_in, p.tile_out) == (1, 0, 64, 64)
    gen = torch.Generator().manual_seed(5)
    images = torch.rand(frames, 64, 64, generator=gen) * 200 + 20
    labels = torch.randint(0, 9, (frames, 64, 64), generator=gen).to(torch.uint8)
    metrics, preds = engine.evaluate_batch(images.numpy(), labels.numpy())
    lo = images.amin((1, 2), keepdim=True)
    norm = (images - lo) / (images.amax((1, 2), keepdim=True) - lo)
    with torch.no_grad():
        want = model(norm[..., None]).argmax(-1).int()
    assert torch.equal(preds, want)
    torch.testing.assert_close(metrics, batch_evaluation_metrics(want, labels))


def test_engine_refuses_other_frames(reference):
    model = _model(params=reference[0])
    for h, w, tile_out in ((64, 96, None), (60, 60, None), (64, 64, 32)):
        with pytest.raises(ValueError):
            TileInference(model, h, w, tile_out=tile_out)


def test_pixel_error_over_class_ids():
    """Two classes: the old mean absolute difference, bit for bit; nine:
    the share of pixels whose class differs."""
    gen = torch.Generator().manual_seed(6)
    preds = torch.randint(0, 2, (3, 17, 19), generator=gen, dtype=torch.int32)
    labels = torch.randint(0, 2, (3, 17, 19), generator=gen).to(torch.uint8)
    got = batch_evaluation_metrics(preds, labels)
    old = torch.abs(preds.float() - labels.float()).flatten(1).mean(1)
    assert torch.equal(got[:, 1], old)
    preds = torch.randint(0, 9, (3, 17, 19), generator=gen, dtype=torch.int32)
    labels = torch.randint(0, 9, (3, 17, 19), generator=gen).to(torch.uint8)
    got = batch_evaluation_metrics(preds, labels).numpy()
    p, l_ = preds.numpy(), labels.numpy()
    np.testing.assert_allclose(got[:, 1], (p != l_).reshape(3, -1).mean(1), rtol=1e-6)
    inter = ((p != 0) & (l_ != 0)).reshape(3, -1).sum(1)
    union = ((p != 0) | (l_ != 0)).reshape(3, -1).sum(1)
    np.testing.assert_allclose(got[:, 0], inter / union, rtol=1e-6)


def test_no_span_opens_inside_the_wrapped_calls(reference, monkeypatch):
    """`conv3x3_bias_relu` and `attention` replaced, as the benchmark's
    harness replaces them, by themselves inside a marker range: each marker
    is reached, and no program range lies inside one."""
    params, x, _ = reference
    model = _model(dataclasses.replace(SMALL, conv_impl="pallas"), params)
    for attr, marker in (("conv3x3_bias_relu", "k1"), ("attention", "attn")):
        fn = getattr(tu, attr)

        def wrapped(*args, _fn=fn, _marker=marker):
            with torch.profiler.record_function(_marker):
                return _fn(*args)
        monkeypatch.setattr(tu, attr, wrapped)
    with torch.no_grad(), trace_capture() as prof:
        model(x)
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    program = [e for e in events if e[0].startswith(("transunet.", "tiles."))]
    for marker, count in (("k1", 9), ("attn", 2)):
        calls = [e for e in events if e[0] == marker]
        assert len(calls) == count, marker
        assert not [p for p in program for c in calls if c[1] <= p[1] and p[2] <= c[2]], marker
