"""The port's int4 serving tier (the int4 helpers of
tpu_unet_torch/ops/conv_tiles.py, the q4 half of infer/quant.py and
its .npz files) against the JAX package on the CPU, given the same numpy
weights, scales and inputs: the helpers and every integer stage bit for
bit, the logits at rtol 1e-4 (as tests/test_torch_quant.py holds the int8
tier); each encoding boundary an int4_names subset makes, in both skip
variants; the split decoder conv's -8 pad against integer math; the phase
engine's refusal of int4 level-0 convs; the .npz files both ways. One
input size serves them all: JAX's eager ops compile once per shape. Then
evaluate(quant='int4'|'int4-phase') calibrated once and served from disk
with the tier check, and the CLI's --quant int4|int4-phase; evaluate
against JAX's is held in test_torch_quant_eval.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_unet.infer import quant as jq
from tpu_unet.ops import conv_tiles as jct
from tpu_unet_torch import cli
from tpu_unet_torch.data import synthetic_dataset
from tpu_unet_torch.data.tiff import read_tiff
from tpu_unet_torch.infer import evaluate
from tpu_unet_torch.infer import quant as tq
from tpu_unet_torch.ops import conv_tiles as tct
from tests.test_torch_quant import (MIN_CHANNELS, STAGES, _jnp, _np, _t, make_nets,
                                    one_forward)

# 220 is the smallest input whose parity skip is padded up (dec3: a 10^2
# skip under a 12^2 upconv output), which the int4 split pads with -8
SIZE = 220


def _i(rng, lo, hi, shape):
    return rng.randint(lo, hi + 1, shape).astype(np.int8)


# ------------------------------------------------------------------ the helpers


def test_quantize_weights_int4_bit_equal():
    rng = np.random.RandomState(0)
    w = (rng.randn(3, 3, 6, 10) * 0.1).astype(np.float32)
    w[..., 3] = 0.0                                  # an all-zero channel
    q, s = tct.quantize_weights_int4(_t(w))
    jqw, js = jct.quantize_weights_int4(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert int(q.abs().max()) == 7
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("scale", [0.01, 0.5, 1 / 15, 0.37])
def test_activation_quantizers_bit_equal(scale):
    """u4s and s4 of f32 and bf16 inputs, values on the rounding boundaries
    included (half to even, as jnp.round)."""
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 7, 9, 5) * 4 * scale).astype(np.float32)
    x[0, 0, 0] = np.array([0.5, 1.5, -2.5, 7.5, 300.0], np.float32) * np.float32(scale)
    for xt, xj in ((_t(x), jnp.asarray(x)),
                   (_t(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16))):
        for port, ref in ((tct.quantize_activations_u4s, jct.quantize_activations_u4s),
                          (tct.quantize_activations_s4, jct.quantize_activations_s4)):
            got = port(xt, scale)
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref(xj, scale)))


@pytest.mark.parametrize("s8,s4", [(1.0, 127.0 / 15.0), (0.013, 0.013 * 127.0 / 15.0),
                                   (0.02, 0.031)])
def test_requantizers_bit_equal(s8, s4):
    rng = np.random.RandomState(2)
    v8 = _i(rng, 0, 127, (2, 5, 6, 7))
    v4 = _i(rng, -8, 7, (2, 5, 6, 7))
    np.testing.assert_array_equal(tct.requantize_i8_to_u4s(_t(v8), s8, s4).numpy(),
                                  np.asarray(jct.requantize_i8_to_u4s(jnp.asarray(v8), s8, s4)))
    np.testing.assert_array_equal(tct.requantize_u4s_to_i8(_t(v4), s4, s8).numpy(),
                                  np.asarray(jct.requantize_u4s_to_i8(jnp.asarray(v4), s4, s8)))


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("shape,cout", [((2, 12, 12, 16), 8), ((1, 9, 13, 24), 40)])
def test_int4_accumulate_bit_equal(shape, cout, shifted):
    """The int32 sums against JAX's CPU emulation, and (shifted) against
    the unsigned conv of u = x + 8 in plain integer math."""
    rng = np.random.RandomState(3)
    x = _i(rng, -8, 7, shape) if shifted else _i(rng, -7, 7, shape)
    w = _i(rng, -7, 7, (3, 3, shape[-1], cout))
    got = tct.conv3x3_int4_acc(_t(x), _t(w), shifted=shifted)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jct.conv3x3_int4_acc(jnp.asarray(x), jnp.asarray(w), shifted=shifted)))
    u = x.astype(np.int64) + (8 if shifted else 0)
    oracle = sum(np.einsum("bhwc,co->bhwo", u[:, dy:dy + shape[1] - 2, dx:dx + shape[2] - 2],
                           w[dy, dx].astype(np.int64)) for dy in range(3) for dx in range(3))
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("out_kind", ["bf16", "int8", "u4s"])
def test_int4_epilogue_and_conv_bit_equal(out_kind):
    """int4_epilogue of int32 sums and of f32 sums (the split conv's), and
    conv3x3_int4_xla in both encodings."""
    rng = np.random.RandomState(4)
    alpha = (rng.rand(8) * 0.1).astype(np.float32)
    beta = (rng.randn(8) * 0.5).astype(np.float32)
    for acc in (rng.randint(-400, 400, (2, 6, 6, 8)).astype(np.int32),
                (rng.randn(2, 6, 6, 8) * 300).astype(np.float32)):
        got = tct.int4_epilogue(_t(acc), _t(alpha), _t(beta), out_kind=out_kind)
        want = _jnp(jct.int4_epilogue(jnp.asarray(acc), jnp.asarray(alpha),
                                      jnp.asarray(beta), out_kind=out_kind))
        np.testing.assert_array_equal(_np(got), want)
    for shifted in (False, True):
        x = _i(rng, -8, 7, (1, 8, 9, 16))
        w = _i(rng, -7, 7, (3, 3, 16, 8))
        got = tct.conv3x3_int4_xla(_t(x), _t(w), _t(alpha), _t(beta), out_kind=out_kind,
                                   shifted=shifted)
        assert got.dtype == (torch.bfloat16 if out_kind == "bf16" else torch.int8)
        np.testing.assert_array_equal(_np(got), _jnp(jct.conv3x3_int4_xla(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), jnp.asarray(beta),
            out_kind=out_kind, shifted=shifted)))


def test_int4_accumulate_checks_its_arguments():
    x, w = torch.zeros(1, 5, 5, 8, dtype=torch.int8), torch.zeros(3, 3, 8, 4, dtype=torch.int8)
    assert tct.conv3x3_int4_acc(x, w).shape == (1, 3, 3, 4)
    with pytest.raises(TypeError, match="int8"):
        tct.conv3x3_int4_acc(x.float(), w)
    with pytest.raises(ValueError, match="HWIO"):
        tct.conv3x3_int4_acc(x, w[:, :, :4])
    with pytest.raises(ValueError, match="out_kind"):
        tct.int4_epilogue(torch.zeros(4, dtype=torch.int32), torch.ones(4), torch.ones(4),
                          out_kind="int4")


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def nets():
    out = make_nets()
    out["x"] = np.random.RandomState(6).rand(1, SIZE, SIZE, 1).astype(np.float32)
    # the port's calibration (held to JAX's in test_torch_quant.py) feeds both
    out["scales"] = tq.add_concat_scales(out["cfg"], tq.calibrate(
        out["float32"], torch.from_numpy(out["x"])))
    return out


def _qps(nets, qnames=None, q4names=None, skip="paper"):
    """One QuantParams per package from the same weights and scales: int8
    `qnames` (default: every conv of MIN_CHANNELS input channels or more),
    int4 `q4names` (default: those outside level 0)."""
    jcfg = dataclasses.replace(nets["jmodel"].cfg, skip_variant=skip)
    if qnames is None:
        qnames = jq.default_quant_names(jcfg, MIN_CHANNELS)
    if q4names is None:
        q4names = jq.default_int4_names(jcfg, MIN_CHANNELS)
    jqp = jq.prepare_quant_params(jcfg, nets["params"], nets["scales"], qnames, q4names=q4names)
    tqp = tq.prepare_quant_params(dataclasses.replace(nets["cfg"], skip_variant=skip),
                                  nets["float32"], nets["scales"], qnames, q4names=q4names)
    return jqp, tqp


def _assert_q4_equal(tqp, jqp):
    assert tqp.q4names == jqp.q4names and tqp.qnames == jqp.qnames
    assert set(tqp.q4conv) == set(jqp.q4conv) and set(tqp.qconv) == set(jqp.qconv)
    assert set(tqp.fconv) == set(jqp.fconv)
    for table in ("q4conv", "qconv", "fconv"):
        for name, arrays in getattr(jqp, table).items():
            for got, want in zip(getattr(tqp, table)[name], arrays):
                np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=f"{table} {name}")


def test_prepare_int4_params_bit_equal(nets):
    jqp, tqp = _qps(nets)
    _assert_q4_equal(tqp, jqp)
    assert len(tqp.q4conv) == 13 and tqp.q4names.isdisjoint(tqp.qnames)
    assert tqp.qnames == {"dec0_conv1"}                  # int4 takes precedence
    for w_q, _, _ in tqp.q4conv.values():
        assert w_q.dtype == torch.int8 and int(w_q.abs().max()) <= 7
    # from the JAX-layout tree too
    again = tq.prepare_quant_params(nets["cfg"], nets["params"], nets["scales"],
                                    tq.default_quant_names(nets["cfg"], MIN_CHANNELS),
                                    q4names=tq.default_int4_names(nets["cfg"], MIN_CHANNELS))
    _assert_q4_equal(again, jqp)


def _jax_stages(jqp, x, phase_level0=None, stages=STAGES):
    """JAX's eager outputs at `stages` and the logits."""
    qi = jq.QuantInference(jqp, impl="xla", phase_level0=phase_level0)
    with jax.disable_jit():
        seen, logits = one_forward(qi, x)
    assert set(stages) <= set(seen), set(stages) - set(seen)
    return {**{st: np.asarray(seen[st]) for st in stages}, "logits": np.asarray(logits)}


def _assert_stages_match(qi, x, want, stages=STAGES):
    """Every stage of the port's engine `qi` equals JAX's bit for bit (int8
    storage of int8 and u4s stages, bf16 of the float ones); the logits at
    rtol 1e-4. Returns how many stages were integer."""
    n_int = 0
    seen, logits = one_forward(qi, x)
    for st in stages:
        got = seen[st]
        assert got.shape == want[st].shape, st
        if want[st].dtype == np.int8:
            n_int += 1
            assert got.dtype == torch.int8, st
        np.testing.assert_array_equal(_np(got), _jnp(want[st]), err_msg=st)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want["logits"], rtol=1e-4, atol=1e-5)
    return n_int


@pytest.fixture(scope="module")
def int4_stages(nets):
    """JAX's eager stages of the default int4 set, per skip variant, and of
    int4-phase ('phase', paper skips)."""
    x = jnp.asarray(nets["x"])
    out = {skip: _jax_stages(_qps(nets, skip=skip)[0], x) for skip in ("paper", "parity")}
    out["phase"] = _jax_stages(_qps(nets)[0], x, phase_level0="int8")
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("skip", ["paper", "parity"])
def test_every_int4_stage_matches_jax(nets, int4_stages, skip, impl):
    """The default int4 set (13 int4 convs, dec0_conv1 int8): every stage
    bit for bit under both impls; under 'parity' dec3's split conv pads its
    u4s skip with -8."""
    tqp = _qps(nets, skip=skip)[1]
    qi = tq.QuantInference(tqp, impl=impl, device="cpu")
    assert _assert_stages_match(qi, torch.from_numpy(nets["x"]), int4_stages[skip]) >= 16


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_int4_phase_stages_match_jax(nets, int4_stages, impl):
    """int4-phase: level 0 phase-packed in int8 under the int4 mid-depth."""
    qi = tq.QuantInference(_qps(nets)[1], impl=impl, phase_level0="int8", device="cpu")
    _assert_stages_match(qi, torch.from_numpy(nets["x"]), int4_stages["phase"])


def test_build_int4_inference(nets):
    """build_quant_inference(int4=True) and int4_names= pick the sets as
    JAX's does."""
    model = nets["bfloat16"]
    x = torch.from_numpy(nets["x"][:1])
    qi = tq.build_quant_inference(model, x, min_channels=MIN_CHANNELS, int4=True)
    assert qi.qp.q4names == tq.default_int4_names(model.cfg, MIN_CHANNELS)
    assert qi.qp.qnames == {"dec0_conv1"} and qi.device == torch.device("cpu")
    qi = tq.build_quant_inference(model, x, min_channels=MIN_CHANNELS,
                                  int4_names=frozenset({"dec2_conv2"}))
    assert qi.qp.q4names == {"dec2_conv2"} and "dec2_conv2" not in qi.qp.qnames
    assert qi.apply(x).shape == (1, SIZE - 184, SIZE - 184, 2)


# ------------------------------------------------------ encoding boundaries

# case: (convs taken out of the int8 set, the int4 set, the stages around
# its boundaries)
BOUNDARIES = {
    # float -> u4s (enc1_conv1 is float), u4s pooled -> int8 (enc2_conv1),
    # a u4s skip into an int8 concat (dec1_conv1)
    "float_to_u4s": ((), {"enc1_conv2"}, ["enc1_conv2", "pool1", "enc2_conv1", "dec1_conv1"]),
    # int8 -> u4s, and again u4s -> int8 (enc3_conv1) and a u4s skip
    "int8_to_u4s": ((), {"enc2_conv2"}, ["enc2_conv2", "enc3_conv1", "dec2_conv1"]),
    # a u4s chain, then u4s -> int8 (enc3_conv1)
    "u4s_to_u4s": ((), {"enc2_conv1", "enc2_conv2"}, ["enc2_conv1", "enc2_conv2",
                                                      "enc3_conv1"]),
    # u4s -> int8 inside a level (enc2_conv2 int8 from u4s)
    "u4s_to_int8": ((), {"enc2_conv1"}, ["enc2_conv1", "enc2_conv2", "dec2_conv1"]),
    # a float skip (enc1_conv2 float) captured as u4s, the split, then u4s ->
    # int8 (dec1_conv2)
    "float_skip_as_u4s": (("enc1_conv2",), {"dec1_conv1"}, ["enc1_conv2", "dec1_conv1",
                                                           "dec1_conv2"]),
    # an int8 skip requantized to u4s in the split, then u4s -> int8
    "int8_skip_split": ((), {"dec1_conv1"}, ["dec1_conv1", "dec1_conv2"]),
}


@pytest.mark.parametrize("skip", ["paper", "parity"])
@pytest.mark.parametrize("case", list(BOUNDARIES))
def test_encoding_boundaries_match_jax(nets, case, skip):
    """Each encoding boundary an int4_names subset makes, in both skip
    variants: the stages around it bit for bit, the logits at rtol 1e-4.
    (The float convs are bit-equal at these weights too: most convs are
    quantized.)"""
    out8, q4names, stages = BOUNDARIES[case]
    qnames = jq.default_quant_names(nets["jmodel"].cfg, MIN_CHANNELS) - set(out8)
    jqp, tqp = _qps(nets, qnames, frozenset(q4names), skip)
    assert tqp.q4names == q4names
    want = _jax_stages(jqp, jnp.asarray(nets["x"]), stages=stages)
    _assert_stages_match(tq.QuantInference(tqp, device="cpu"), torch.from_numpy(nets["x"]),
                         want, stages)


@pytest.mark.parametrize("skip_kind", ["u4s", "int8", "float"])
def test_split_decoder_conv_pads_with_minus_8(nets, skip_kind):
    """The int4 decoder conv1 with a skip smaller than the upconv output
    (padded up, as the parity variant pads it) equals JAX's, and its padded
    region holds real zeros: the composed integer math of the unshifted
    skip zero-padded equals it bit for bit."""
    jqp, tqp = _qps(nets)
    d, c = 1, nets["cfg"].widths[1]
    rng = np.random.RandomState(7)
    u = (rng.randn(1, 16, 16, c) * 0.3).astype(np.float32)
    s4 = nets["scales"][f"enc{d}_conv2"] * tq._U4
    if skip_kind == "u4s":
        sk, s = _i(rng, -8, 7, (1, 12, 12, c)), ("u4s", s4)
    elif skip_kind == "int8":
        sk, s = _i(rng, 0, 127, (1, 12, 12, c)), nets["scales"][f"enc{d}_conv2"]
    else:
        sk, s = (rng.rand(1, 12, 12, c) * 0.2).astype(np.float32), None
    qi = tq.QuantInference(tqp, device="cpu")
    got, (tag, s_out4) = qi._conv_i4_split(d, _t(u), (_t(sk), s))
    want, (jtag, js_out4) = jq.QuantInference(jqp)._conv_i4_split(
        d, jnp.asarray(u), (jnp.asarray(sk), s))
    assert (tag, s_out4) == (jtag, js_out4) == ("u4s", nets["scales"][f"dec{d}_conv1"] * tq._U4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if skip_kind != "u4s":
        return
    w_q, s_w, bias = (t.numpy() for t in tqp.q4conv[f"dec{d}_conv1"])
    sk_u = np.pad(sk.astype(np.int64) + 8, ((0, 0), (2, 2), (2, 2), (0, 0)))   # real zeros
    u_q = tct.quantize_activations_s4(_t(u), nets["scales"][f"up{d}"] * tq._S4).numpy()

    def conv(a, k):
        return sum(np.einsum("bhwc,co->bhwo", a[:, dy:dy + 14, dx:dx + 14],
                             k[dy, dx].astype(np.int64)) for dy in range(3) for dx in range(3))

    t = (conv(sk_u, w_q[:, :, :c]).astype(np.float32) * np.float32(s4)
         + conv(u_q.astype(np.int64), w_q[:, :, c:]).astype(np.float32)
         * np.float32(nets["scales"][f"up{d}"] * tq._S4))
    y = np.maximum(t * (s_w / np.float32(s_out4)) + bias / np.float32(s_out4), 0.0)
    np.testing.assert_array_equal(got.numpy(), (np.clip(np.round(y), 0, 15) - 8).astype(np.int8))


def test_phase_engine_refuses_int4_level0(nets):
    """phase_level0 with an int4 level-0 conv raises JAX's ValueError."""
    jqp, tqp = _qps(nets, q4names=frozenset({"enc0_conv2", "enc1_conv2"}))
    for qp, make in ((tqp, lambda qp: tq.QuantInference(qp, phase_level0="int8",
                                                        device="cpu")),
                     (jqp, lambda qp: jq.QuantInference(qp, phase_level0="int8"))):
        with pytest.raises(ValueError, match="int4 level-0"):
            make(qp)
    # served plain, the int4 level-0 conv runs
    assert tq.QuantInference(tqp, device="cpu").apply(
        torch.from_numpy(nets["x"])).isfinite().all()


def test_int4_npz_crosses_both_ways(nets, tmp_path):
    """An int4 .npz written by JAX serves in the port, one written by the
    port serves in JAX: the same QuantParams, the engine's logits."""
    jqp, tqp = _qps(nets)
    x = nets["x"]
    jq.save_quant_params(str(tmp_path / "jax"), jqp)
    from_jax = tq.load_quant_params(str(tmp_path / "jax"))
    _assert_q4_equal(from_jax, jqp)
    np.testing.assert_array_equal(
        tq.QuantInference(from_jax, device="cpu").apply(torch.from_numpy(x)).numpy(),
        tq.QuantInference(tqp, device="cpu").apply(torch.from_numpy(x)).numpy())
    tq.save_quant_params(str(tmp_path / "port.npz"), tqp)
    from_port = jq.load_quant_params(str(tmp_path / "port.npz"))
    assert from_port.q4names == jqp.q4names and set(from_port.q4conv) == set(jqp.q4conv)
    with jax.disable_jit():
        np.testing.assert_array_equal(
            np.asarray(jq.QuantInference(from_port).apply(jnp.asarray(x))),
            np.asarray(jq.QuantInference(jqp).apply(jnp.asarray(x))))


# ------------------------------------------------------ evaluate and the CLI

EVAL_DATA = dict(n_images=2, h=64, w=64, n_cells=3, crop=20, seed=3)


def test_evaluate_int4_calibrates_once_and_checks_the_tier(nets, tmp_path, monkeypatch):
    """A missing quant_path is calibrated and written with the int4 set; the
    next int4 and int4-phase evaluations are served from it; a file of the
    other tier raises JAX's ValueError in both directions."""
    model = nets["bfloat16"]
    data = synthetic_dataset(**EVAL_DATA)
    calls = []
    real = tq.calibrate
    monkeypatch.setattr(tq, "calibrate", lambda *a, **k: calls.append(1) or real(*a, **k))
    p4, p8 = str(tmp_path / "int4"), str(tmp_path / "int8")
    first = evaluate(model, data, verbose=False, quant="int4", quant_path=p4)
    assert calls == [1] and tq.load_quant_params(p4).q4names == \
        tq.default_int4_names(model.cfg)
    second = evaluate(model, data, verbose=False, quant="int4", quant_path=p4)
    phase = evaluate(model, data, verbose=False, quant="int4-phase", quant_path=p4)
    assert calls == [1] and np.isfinite(phase["pe_mean"])
    assert {k: v for k, v in first.items() if k != "seconds"} == \
        {k: v for k, v in second.items() if k != "seconds"}
    evaluate(model, data, verbose=False, quant="int8", quant_path=p8)
    for quant, path, have in (("int4", p8, "int8"), ("int8-phase", p4, "int4")):
        with pytest.raises(ValueError, match=f"holds an {have}-tier QuantParams"):
            evaluate(model, data, verbose=False, quant=quant, quant_path=path)


@pytest.fixture(scope="module")
def cli_checkpoint(tmp_path_factory):
    """The 'best' checkpoint of a base-width-8 run of epoch 0 on the CLI's
    synthetic fixture: wide enough that the default sets (convs of 128 or
    more input channels) hold int4 convs."""
    out = str(tmp_path_factory.mktemp("cli4") / "models")
    assert cli.main(["-m", "TRAINING", "-d", "synthetic", "--epochs", "0",
                     "--base-width", "8", "--quiet", "--out-dir", out, "--platform", "cpu"]) == 0
    return os.path.join(out, "synthetic", "all", "models", "best")


@pytest.mark.parametrize("quant", ["int4", "int4-phase"])
def test_cli_serves_int4(cli_checkpoint, quant, monkeypatch):
    """TESTING --quant int4|int4-phase exits 0 through the int4 convs (the
    plain int4 conv for bottleneck_conv2, the split for dec3_conv1) and
    exports 0/255 maps and metrics in [0, 1]."""
    calls = []
    for name in ("conv3x3_int4_xla", "conv3x3_int4_acc"):
        real = getattr(tq, name)
        monkeypatch.setattr(tq, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    assert cli.main(["-m", "TESTING", "-d", "synthetic", "-n", cli_checkpoint, "--quiet",
                     "--quant", quant, "--platform", "cpu"]) == 0
    assert {"conv3x3_int4_xla", "conv3x3_int4_acc"} <= set(calls)
    out = cli_checkpoint + "_test"
    iou = np.loadtxt(os.path.join(out, "test_iou.out"))
    assert 0.0 <= iou[0] <= 1.0
    (pred,) = read_tiff(os.path.join(out, "preds", "pred0.tif"))
    assert pred.shape == (256, 256) and set(np.unique(pred)) <= {0, 255}
