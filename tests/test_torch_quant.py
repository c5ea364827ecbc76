"""The port's int8 serving (tpu_unet_torch/ops/conv_tiles.py,
infer/quant.py, the int8 path of infer/tester.py) against the JAX package
on the CPU, given the same numpy weights and inputs: the quantizers, K3's
plain version and the int8 library route, weight quantization, calibration,
every stage of the quantized forward, and the .npz files in both
directions. evaluate(quant='int8') is held in test_torch_quant_eval.py."""

import dataclasses
import inspect
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet.infer import quant as jq
from tpu_unet.models import UNet as JaxUNet
from tpu_unet.ops import conv_tiles as jct
from tpu_unet_torch.config import ModelConfig
from tpu_unet_torch.convert import state_dict_from_jax_params
from tpu_unet_torch.infer import quant as tq
from tpu_unet_torch.models import UNet
from tpu_unet_torch.ops import conv_tiles as tct
from tests.test_torch_model import jax_config, numpy_params

SIZE = 188                       # the smallest input; bottleneck 8 (even)
MIN_CHANNELS = 16                # at base width 8: 14 of the 18 convs int8


def _int8(rng, shape, lo=-127, hi=128):
    return rng.randint(lo, hi, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    """A port tensor as numpy, bf16 widened to f32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    """A JAX array as numpy, bf16 widened to f32."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


# ------------------------------------------------------------------ ops


def test_quantizers_bit_equal():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 7, 9, 5) * 2).astype(np.float32)
    # values on the rounding boundaries: half to even, as jnp.round
    x[0, 0, 0] = [0.5, 1.5, -2.5, 300.0, -300.0]
    for scale in (0.01, 1 / 127, 0.37):
        np.testing.assert_array_equal(
            tct.quantize_activations(_t(x), scale).numpy(),
            np.asarray(jct.quantize_activations(jnp.asarray(x), scale)))
    xb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(
        tct.quantize_activations(_t(x).to(torch.bfloat16), 0.05).numpy(),
        np.asarray(jct.quantize_activations(xb, 0.05)))
    w = (rng.randn(3, 3, 6, 10) * 0.1).astype(np.float32)
    w[..., 3] = 0.0                                  # an all-zero channel
    q, s = tct.quantize_weights(_t(w))
    jqw, js = jct.quantize_weights(jnp.asarray(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def _conv_args(rng, shape, cout):
    x = _int8(rng, shape)
    w = _int8(rng, (3, 3, shape[-1], cout))
    alpha = (rng.rand(cout) * 2e-4).astype(np.float32)
    beta = (rng.randn(cout) * 3).astype(np.float32)
    return x, w, alpha, beta


@pytest.mark.parametrize("shape,cout", [((2, 10, 12, 16), 8),    # Cin 16, Cout 8
                                        ((1, 9, 13, 24), 40)])   # ragged rows/Cout
def test_int8_conv_routes_match_jax(shape, cout):
    """K3's plain version, K3's wrapper (its plain version on the CPU) and
    the int8 library route against JAX's XLA int8 conv and its Pallas
    kernel in interpret mode, for both out kinds: bit for bit."""
    x, w, alpha, beta = _conv_args(np.random.RandomState(1), shape, cout)
    jargs = [jnp.asarray(a) for a in (x, w, alpha, beta)]
    targs = [_t(a) for a in (x, w, alpha, beta)]
    for out_kind in ("int8", "bf16"):
        ref = _jnp(jct.conv3x3_int8_xla(*jargs, out_kind=out_kind))
        pallas = _jnp(jct.conv3x3_fused(*jargs, out_kind=out_kind, block_rows=4,
                                        interpret=True))
        np.testing.assert_array_equal(pallas, ref)
        for got in (tct.conv3x3_fused_plain(*targs, out_kind),
                    tct.conv3x3_fused(*targs, out_kind=out_kind, block_rows=4),
                    tct.conv3x3_int8_xla(*targs, out_kind=out_kind)):
            assert got.dtype == (torch.int8 if out_kind == "int8" else torch.bfloat16)
            np.testing.assert_array_equal(_np(got), ref)
    assert tct.conv3x3_fused.launches == 0            # CPU calls don't count


def test_int8_library_route_in_blocks(monkeypatch):
    """The im2col in blocks of whole images and of rows of one image gives
    the one-shot result."""
    x, w, alpha, beta = [_t(a) for a in _conv_args(np.random.RandomState(2),
                                                   (3, 11, 10, 8), 16)]
    whole = tct.conv3x3_int8_xla(x, w, alpha, beta, out_kind="int8")
    for limit in (2 * 9 * 8 * 72, 3 * 8 * 72):     # 2 images; 3 rows
        monkeypatch.setattr(tct, "IM2COL_BYTES", limit)
        assert len(list(tct._row_blocks(3, 9, 8 * 72))) > 1
        torch.testing.assert_close(tct.conv3x3_int8_xla(x, w, alpha, beta, "int8"),
                                   whole, rtol=0, atol=0)


def test_bf16_inputs_match_jax_pallas():
    """bf16 x bf16 -> f32 accumulation (the Pallas body's float kind): the
    plain version against the Pallas kernel in interpret mode, at one bf16
    ulp of the output (the two sum in f32 in other orders)."""
    rng = np.random.RandomState(3)
    x = rng.randn(1, 8, 11, 16).astype(np.float32)
    w = (rng.randn(3, 3, 16, 24) * 0.1).astype(np.float32)
    alpha = np.ones(24, np.float32)
    beta = (rng.randn(24) * 0.1).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref = _jnp(jct.conv3x3_fused(jx, jw, jnp.asarray(alpha), jnp.asarray(beta),
                                 block_rows=4, interpret=True))
    got = tct.conv3x3_fused(_t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16),
                            _t(alpha), _t(beta))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), ref, rtol=2 ** -7, atol=1e-6)


def test_fused_conv_checks_its_tiling_like_jax():
    assert tct.BEST_CONFIGS == jct.BEST_CONFIGS
    for cin, cout in [(64, 128), (512, 512), (16, 8), (128, 300), (640, 1024)]:
        assert tct.best_config(cin, cout) == jct.best_config(cin, cout)
    x, w, alpha, beta = [_t(a) for a in _conv_args(np.random.RandomState(4),
                                                   (1, 6, 6, 16), 24)]
    jargs = [jnp.asarray(a.numpy()) for a in (x, w, alpha, beta)]
    with pytest.raises(ValueError, match="variant"):
        tct.conv3x3_fused(x, w, alpha, beta, variant="winograd")
    with pytest.raises(ValueError, match="variant"):
        jct.conv3x3_fused(*jargs, variant="winograd", interpret=True)
    with pytest.raises(ValueError, match="cout_tile"):
        tct.conv3x3_fused(x, w, alpha, beta, cout_tile=16)
    with pytest.raises(AssertionError):
        jct.conv3x3_fused(*jargs, cout_tile=16, interpret=True)
    with pytest.raises(ValueError, match="out_kind"):
        tct.conv3x3_fused(x, w, alpha, beta, out_kind="f32")
    # 'auto' takes the measured config; None block_rows/cout_tile are filled
    y = tct.conv3x3_fused(x, w, alpha, beta, variant="auto", block_rows=None)
    torch.testing.assert_close(y, tct.conv3x3_fused_plain(x, w, alpha, beta),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\[3, 3, 16, Cout\]"):
        tct.conv3x3_fused(x, w[:, :, :8], alpha, beta)


# ------------------------------------------------- K3's routes on the card

# (layer, input H = W, Cin, Cout) of the 14 int8 convs of a full-width
# 572^2 tile, and the block of the int8 wgmma loop each gets.
INT8_MAIN_PATH = [
    ("enc1_conv2", 282, 128, 128), ("enc2_conv1", 140, 128, 256),
    ("enc2_conv2", 138, 256, 256), ("enc3_conv1", 68, 256, 512),
    ("enc3_conv2", 66, 512, 512), ("bottleneck_conv1", 32, 512, 1024),
    ("bottleneck_conv2", 30, 1024, 1024), ("dec3_conv1", 56, 1024, 512),
    ("dec3_conv2", 54, 512, 512), ("dec2_conv1", 104, 512, 256),
    ("dec2_conv2", 102, 256, 256), ("dec1_conv1", 200, 256, 128),
    ("dec1_conv2", 198, 128, 128), ("dec0_conv1", 392, 128, 64),
]


def test_int8_main_path_is_the_14_quantized_convs():
    names = {name for name, *_ in INT8_MAIN_PATH}
    assert names == tq.default_quant_names(ModelConfig(base_width=64))


@pytest.mark.parametrize("name,s,cin,cout", INT8_MAIN_PATH)
def test_int8_main_path_routes_to_the_wgmma_loop(name, s, cin, cout):
    """Every int8 conv of the serving chunk takes route "sm90", in a 256 x
    128 block, or 128 x 64 at Cout 64 (dec0_conv1). The route reads the
    shape, not the data or the device, so a 4-row slice stands for it."""
    x = torch.zeros((1, 4, s, cin), dtype=torch.int8)
    w = torch.zeros((3, 3, cin, cout), dtype=torch.int8)
    assert tct.conv3x3_fused_route(x, w) == "sm90"
    assert tct.sm90_block(cout) == ((128, 64) if cout == 64 else (256, 128))
    assert tct.sm90_block(cout) in tct.SM90_BLOCKS


def _misaligned_int8(shape):
    buf = torch.zeros(int(np.prod(shape)) + 16, dtype=torch.int8)
    off = (-buf.data_ptr()) % 16 + 1
    return buf[off:off + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("label,x,cout,out_kind,route", [
    ("bf16 x", torch.zeros((1, 5, 5, 16), dtype=torch.bfloat16), 16, "auto", "simple"),
    ("Cin 3", torch.zeros((1, 5, 5, 3), dtype=torch.int8), 16, "auto", "simple"),
    ("Cin 24", torch.zeros((1, 5, 5, 24), dtype=torch.int8), 16, "auto", "simple"),
    ("Cout 5", torch.zeros((1, 5, 5, 16), dtype=torch.int8), 5, "auto", "simple"),
    ("Cout 40, int8 out", torch.zeros((1, 5, 5, 16), dtype=torch.int8), 40, "int8", "simple"),
    ("Cout 40, bf16 out", torch.zeros((1, 5, 5, 16), dtype=torch.int8), 40, "bf16", "sm90"),
    ("Cin 16, Cout 16", torch.zeros((1, 5, 5, 16), dtype=torch.int8), 16, "auto", "sm90"),
    ("misaligned x", _misaligned_int8((1, 5, 5, 16)), 16, "auto", "simple"),
])
def test_k3_route_by_dtype_channels_and_alignment(label, x, cout, out_kind, route):
    w = torch.zeros((3, 3, x.shape[3], cout), dtype=x.dtype)
    assert tct.conv3x3_fused_route(x, w, out_kind) == route, label


@pytest.mark.parametrize("k,cin,cout", [(3, 16, 24), (2, 32, 8), (3, 1, 5)])
def test_k_major_weights_read_the_hwio_kernel(k, cin, cout):
    """Row n of the K-major matrix is output channel n's taps, tap-major with
    ascending channels: element (dy*k + dx)*Cin + c is w[dy, dx, c, n]."""
    w = torch.from_numpy(np.random.RandomState(k + cin).randint(
        -127, 128, (k, k, cin, cout)).astype(np.int8))
    wk = tct.k_major_weights(w)
    assert wk.shape == (cout, k * k * cin) and wk.is_contiguous()
    for dy, dx, c, n in [(0, 0, 0, 0), (k - 1, 0, cin - 1, cout - 1), (0, k - 1, cin // 2, 1),
                         (k - 1, k - 1, 0, cout // 2)]:
        assert wk[n, (dy * k + dx) * cin + c] == w[dy, dx, c, n]
    assert torch.equal(wk.view(cout, k, k, cin).permute(1, 2, 3, 0), w)


def test_k3_forced_route_refuses_what_its_route_does_not_take():
    x, w, alpha, beta = [_t(a) for a in _conv_args(np.random.RandomState(6),
                                                   (1, 6, 6, 24), 16)]
    with pytest.raises(ValueError, match="sm90 route does not take"):
        tct._conv3x3_fused_route_forward(x, w, alpha, beta, "sm90")         # Cin 24
    with pytest.raises(ValueError, match="sm90 route does not take"):
        tct._conv3x3_fused_route_forward(x[..., :16].contiguous().to(torch.bfloat16),
                                         w[:, :, :16].contiguous().to(torch.bfloat16),
                                         alpha, beta, "sm90")                 # bf16 x
    with pytest.raises(ValueError, match="no route"):
        tct._conv3x3_fused_route_forward(x, w, alpha, beta, "cudnn")
    with pytest.raises(ValueError, match="cuda"):
        tct._conv3x3_fused_route_forward(x, w, alpha, beta, "simple")       # a CPU tensor
    assert tct.conv3x3_fused.launches == tct.conv3x3_fused.sm90_launches == 0


# ------------------------------------------------- calibration and weights


def make_nets():
    """The JAX and the port U-Net at base width 8 on the same numpy weights,
    f32 (for calibration) and bf16 (as served), with one numpy input."""
    cfg = ModelConfig(base_width=8)
    jmodel = JaxUNet(jax_config(cfg))
    params = numpy_params(jmodel, SIZE, seed=11)
    out = {"cfg": cfg, "jmodel": jmodel, "params": params,
           "x": np.random.RandomState(5).rand(2, SIZE, SIZE, 1).astype(np.float32)}
    for dtype in ("float32", "bfloat16"):
        model = UNet(dataclasses.replace(cfg, compute_dtype=dtype))
        model.load_state_dict(state_dict_from_jax_params(params))
        out[dtype] = model
    return out


@pytest.fixture(scope="module")
def nets():
    return make_nets()


def test_default_quant_names_match_jax():
    for kw in [{}, {"base_width": 8}, {"base_width": 4, "depth": 3},
               {"base_width": 16, "width_mult": 2}]:
        cfg = ModelConfig(**kw)
        jcfg = jax_config(cfg)
        assert tq._conv_names(cfg) == jq._conv_names(jcfg)
        for mc in (16, 128):
            assert tq.default_quant_names(cfg, mc) == jq.default_quant_names(jcfg, mc)
            assert tq.default_int4_names(cfg, mc) == jq.default_int4_names(jcfg, mc)
    full = tq.default_quant_names(ModelConfig())
    assert len(full) == 14 and {"enc0_conv1", "enc0_conv2", "enc1_conv1",
                                "dec0_conv2"}.isdisjoint(full)


def test_calibrate_matches_jax(nets):
    """The f32 model's scales at rtol 1e-4 (JAX and torch sum f32 convs in
    other orders), the same keys (every conv, up{d}, head, input), and the
    concat scales."""
    x = nets["x"]
    expected = jq.calibrate(nets["jmodel"], nets["params"], jnp.asarray(x))
    got = tq.calibrate(nets["float32"], torch.from_numpy(x))
    assert set(got) == set(expected)
    assert {"input", "head", "up0", "bottleneck_conv2"} <= set(got)
    for k in expected:
        assert got[k] == pytest.approx(expected[k], rel=1e-4), k
    cat = tq.add_concat_scales(nets["cfg"], expected)
    assert cat == jq.add_concat_scales(nets["jmodel"].cfg, expected)
    imgs = [np.random.RandomState(k).rand(150, 230).astype(np.float32) * 9
            for k in range(3)]
    np.testing.assert_array_equal(tq.calibration_batch(imgs).numpy(),
                                  np.asarray(jq.calibration_batch(imgs)))


@pytest.fixture(scope="module")
def qparams(nets):
    """One QuantParams per package from the same weights and scales."""
    scales = jq.add_concat_scales(nets["jmodel"].cfg, jq.calibrate(
        nets["jmodel"], nets["params"], jnp.asarray(nets["x"])))
    names = jq.default_quant_names(nets["jmodel"].cfg, MIN_CHANNELS)
    jqp = jq.prepare_quant_params(nets["jmodel"].cfg, nets["params"], scales, names)
    tqp = tq.prepare_quant_params(nets["cfg"], nets["float32"], scales, names)
    return jqp, tqp


def _assert_qp_equal(tqp, jqp):
    assert tqp.qnames == jqp.qnames and tqp.scales == jqp.scales
    assert dataclasses.asdict(tqp.cfg) == dataclasses.asdict(jqp.cfg)
    assert set(tqp.qconv) == set(jqp.qconv) and set(tqp.fconv) == set(jqp.fconv)
    for name, (w_q, s_w, b) in jqp.qconv.items():
        for got, want in zip(tqp.qconv[name], (w_q, s_w, b)):
            np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=name)
    for name, (k, b) in jqp.fconv.items():
        assert tqp.fconv[name][0].dtype == (torch.float32 if k.dtype == jnp.float32
                                            else torch.bfloat16), name
        np.testing.assert_array_equal(_np(tqp.fconv[name][0]), _jnp(k), err_msg=name)
        np.testing.assert_array_equal(_np(tqp.fconv[name][1]), _jnp(b), err_msg=name)


def test_prepare_quant_params_bit_equal(nets, qparams):
    jqp, tqp = qparams
    _assert_qp_equal(tqp, jqp)
    assert len(tqp.qconv) == 14
    # the same from the port's state_dict and from the JAX-layout tree
    again = tq.prepare_quant_params(nets["cfg"], nets["params"], tqp.scales, tqp.qnames)
    _assert_qp_equal(again, jqp)


# ------------------------------------------------------ the int8 forward

STAGES = ([f"enc{d}_conv{i}" for d in range(4) for i in (1, 2)]
          + [f"pool{d}" for d in range(4)] + ["bottleneck_conv1", "bottleneck_conv2"]
          + [f"up{d}" for d in range(4)]
          + [f"dec{d}_conv{i}" for d in range(4) for i in (1, 2)])


def one_forward(qi, x):
    """Every stage of one forward of the engine `qi` (either package's) and
    its logits. Both engines' apply(stop_after=) call an inner
    ``cut(name, t)`` after each stage and return `t` where the name matches:
    a profile hook on that code object records each (name, t), and a stop
    name no stage has lets the forward run to the logits. This reads what
    apply(x, stop_after=name) returns, from one forward instead of one per
    stage."""
    cut = next(c for c in inspect.unwrap(type(qi).apply).__code__.co_consts
               if isinstance(c, types.CodeType) and c.co_name == "cut")
    seen = {}

    def hook(frame, event, _):
        if event == "call" and frame.f_code is cut:
            t = frame.f_locals["t"]
            seen[frame.f_locals["name"]] = t.clone() if isinstance(t, torch.Tensor) else t

    sys.setprofile(hook)
    try:
        logits = qi.apply(x, stop_after="no such stage")
    finally:
        sys.setprofile(None)
    return seen, logits


@pytest.fixture(scope="module")
def jax_stages(nets, qparams):
    """JAX's impl='xla' outputs at every stage and the logits, per skip
    variant."""
    out = {}
    x = jnp.asarray(nets["x"])
    for skip in ("paper", "parity"):
        jqp = dataclasses.replace(qparams[0], cfg=dataclasses.replace(
            qparams[0].cfg, skip_variant=skip))
        seen, logits = one_forward(jq.QuantInference(jqp, impl="xla"), x)
        out[skip] = {st: np.asarray(seen[st]) for st in STAGES}
        out[skip]["logits"] = np.asarray(logits)
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("skip", ["paper", "parity"])
def test_every_stage_matches_jax(nets, qparams, jax_stages, skip, impl):
    """Given the same QuantParams, every stage of the port's forward equals
    JAX's (impl='xla') bit for bit: the int8 stages, and here the bf16 ones
    too; the logits at rtol 1e-4."""
    tqp = dataclasses.replace(qparams[1], cfg=dataclasses.replace(
        qparams[1].cfg, skip_variant=skip))
    qi = tq.QuantInference(tqp, impl=impl, device="cpu")
    x = torch.from_numpy(nets["x"])
    n_int8 = 0
    seen, logits = one_forward(qi, x)
    assert torch.equal(qi.apply(x, stop_after="pool1"), seen["pool1"])
    for st in STAGES:
        want = jax_stages[skip][st]
        got = seen[st]
        assert got.shape == want.shape, st
        if want.dtype == np.int8:
            n_int8 += 1
            assert got.dtype == torch.int8, st
        np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=st)
    assert n_int8 >= 12
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jax_stages[skip]["logits"],
                               rtol=1e-4, atol=1e-5)


def test_forward_options(nets, qparams, jax_stages):
    """upconv_impl='matmul', a per-layer route mix and block_rows given: the
    same logits as the default engine; phase_level0 serves (held to JAX's
    phase engine in test_torch_quant_phase.py); so does the int4 tier (held
    to JAX's in test_torch_int4.py), which takes precedence over int8."""
    x = torch.from_numpy(nets["x"])
    want = jax_stages["paper"]["logits"]
    tqp = qparams[1]
    for kw in ({"upconv_impl": "matmul"},
               {"impl": "pallas", "layer_impl": {"enc2_conv1": "xla"}, "block_rows": 8}):
        got = tq.QuantInference(tqp, device="cpu", **kw).apply(x).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        tq.QuantInference(tqp, impl="cuda", device="cpu")
    for mode in ("bf16", "int8"):         # item 8, ported: the phase engine
        got = tq.QuantInference(tqp, phase_level0=mode, device="cpu").apply(x).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
    q4 = tq.prepare_quant_params(nets["cfg"], nets["params"], tqp.scales, tqp.qnames,
                                 q4names=frozenset({"dec1_conv1"}))
    assert q4.q4names == {"dec1_conv1"} and set(q4.q4conv) == {"dec1_conv1"}
    assert q4.qnames == tqp.qnames - {"dec1_conv1"}
    got = tq.QuantInference(q4, device="cpu").apply(x).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    qi = tq.build_quant_inference(nets["bfloat16"], x, int4=True)
    assert qi.qp.q4names == tq.default_int4_names(nets["cfg"])
    qi = tq.build_quant_inference(nets["bfloat16"], x, phase_level0="int8")
    assert qi.phase_level0 == "int8" and qi.device == torch.device("cpu")


def test_npz_crosses_both_ways(nets, qparams, jax_stages, tmp_path):
    """A .npz written by JAX serves in the port, and one written by the port
    serves in JAX, with the logits of the engine it came from."""
    jqp, tqp = qparams
    x = nets["x"]
    want = jax_stages["paper"]["logits"]
    jq.save_quant_params(str(tmp_path / "jax"), jqp)
    from_jax = tq.load_quant_params(str(tmp_path / "jax"))
    _assert_qp_equal(from_jax, jqp)
    got = tq.QuantInference(from_jax, device="cpu").apply(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), tq.QuantInference(
        tqp, device="cpu").apply(torch.from_numpy(x)).numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)

    tq.save_quant_params(str(tmp_path / "port.npz"), tqp)
    from_port = jq.load_quant_params(str(tmp_path / "port.npz"))
    assert from_port.cfg == jqp.cfg and from_port.qnames == jqp.qnames
    np.testing.assert_array_equal(
        np.asarray(jq.QuantInference(from_port).apply(jnp.asarray(x))), want)

    j4 = jq.prepare_quant_params(jqp.cfg, nets["params"], jqp.scales, jqp.qnames,
                                 q4names=frozenset({"dec1_conv1"}))
    jq.save_quant_params(str(tmp_path / "int4.npz"), j4)
    t4 = tq.load_quant_params(str(tmp_path / "int4.npz"))     # and it serves
    assert t4.q4names == {"dec1_conv1"} and t4.qnames == j4.qnames
    np.testing.assert_array_equal(t4.q4conv["dec1_conv1"][0].numpy(),
                                  np.asarray(j4.q4conv["dec1_conv1"][0]))
    assert tq.QuantInference(t4, device="cpu").apply(torch.from_numpy(x)).isfinite().all()


# the float 3x3 convs at base width 8 with MIN_CHANNELS 16, and their input
# stages (the int8 dec0_conv1 dequantized at its scale)
FLOAT_CONVS = {"enc0_conv1": None, "enc0_conv2": "enc0_conv1", "enc1_conv1": "pool0",
               "dec0_conv2": "dec0_conv1"}


def test_cpu_keeps_the_library_float_convs_under_pallas(nets, qparams, jax_stages):
    """A config that routes its 3x3 convs to K1 (conv_impl='pallas') serves
    on the CPU through the library expression, bit for bit the engine of
    the 'xla' config (the one held to JAX), under both impls."""
    tqp = qparams[1]
    pallas = dataclasses.replace(tqp, cfg=dataclasses.replace(tqp.cfg, conv_impl="pallas"))
    x = torch.from_numpy(nets["x"])
    want = tq.QuantInference(tqp, device="cpu").apply(x)
    for impl in ("xla", "pallas"):
        qi = tq.QuantInference(pallas, impl=impl, device="cpu")
        assert not qi._k1
        assert torch.equal(qi.apply(x), want), impl
        assert "_fconv_hwio" not in vars(qi)        # K1's kernels never built
    np.testing.assert_allclose(want.numpy(), jax_stages["paper"]["logits"], rtol=1e-4,
                               atol=1e-5)


def test_k1_route_of_the_float_convs_rehearsed(nets, qparams, monkeypatch):
    """The card's K1 route of the float 3x3 convs, taken on the CPU (where
    K1 runs its plain version): one call a float conv per forward with the
    bf16 HWIO kernel and the f32 bias, and each output within 2e-2 of its
    scale of the library expression's on the same input; the paired and
    the phase-packed float convs keep the library expression."""
    tqp = qparams[1]
    x = torch.from_numpy(nets["x"])
    lib = tq.QuantInference(tqp, device="cpu")
    k1 = tq.QuantInference(tqp, device="cpu")
    k1._k1 = True
    calls = []

    def counted(v, w, b):
        calls.append((v.dtype, v.is_contiguous(), w.dtype, tuple(w.shape), b.dtype))
        return conv3x3_k1(v, w, b)
    conv3x3_k1 = tq.conv3x3_k1
    monkeypatch.setattr(tq, "conv3x3_k1", counted)
    logits = k1.apply(x)
    assert logits.shape == lib.apply(x).shape and torch.isfinite(logits).all()
    cin = {"enc0_conv1": 1, "enc0_conv2": 8, "enc1_conv1": 8, "dec0_conv2": 8}
    assert [c[3] for c in calls] == [(3, 3, cin[n], tqp.cfg.widths[int(n[3])])
                                     for n in ("enc0_conv1", "enc0_conv2", "enc1_conv1",
                                               "dec0_conv2")]
    assert all(c[:3] == (torch.bfloat16, True, torch.bfloat16) and c[4] == torch.float32
               for c in calls)
    for name in cin:                                # K1's kernels: the HWIO ones in bf16
        assert torch.equal(k1._fconv_hwio[name], tqp.fconv[name][0].to(torch.bfloat16))
    seen, _ = one_forward(lib, x)
    for name, prev in FLOAT_CONVS.items():
        v = x.to(torch.bfloat16) if prev is None else seen[prev]
        if v.dtype == torch.int8:
            v = lib._deq(v, tqp.scales[prev])
        got, ref = k1._conv_f(name, v), lib._conv_f(name, v)
        assert got.dtype == ref.dtype == torch.bfloat16 and got.shape == ref.shape, name
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= 2e-2 * max(ref.float().abs().max().item(), 1.0), name
    calls.clear()
    k1.apply(x, stop_after="pool0")
    n = len(calls)
    paired = k1._conv_f("enc0_conv2", torch.cat([seen["enc0_conv1"]] * 2, -1), paired=True)
    assert len(calls) == n and paired.shape[-1] == 2 * tqp.cfg.widths[0]
    ph = tq.QuantInference(tqp, phase_level0="bf16", device="cpu")
    ph._k1 = True
    calls.clear()
    ph.apply(x)
    assert [c[3] for c in calls] == [(3, 3, 8, 16)]          # enc1_conv1 only
