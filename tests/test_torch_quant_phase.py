"""The port's phase-packed int8 serving (``QuantInference(phase_level0=)``,
the k x k library route and the plain version of the fused k x k kernel)
against the JAX package on the CPU, given the same numpy weights and
inputs; and the entry points' device default. evaluate(quant='int8-phase')
is held in test_torch_quant_eval.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from tpu_unet.infer import quant as jq
from tpu_unet.models import UNet as JaxUNet
from tpu_unet.ops import conv_tiles as jct
from tpu_unet_torch.config import DatasetConfig
from tpu_unet_torch.infer import quant as tq
from tpu_unet_torch.infer import quant_research as tqr
from tpu_unet_torch.ops import conv_kxk
from tpu_unet_torch.ops import conv_tiles as tct
from tpu_unet_torch.train import Trainer
from tests.test_torch_model import jax_config
from tests.test_torch_quant import _jnp, _np, nets, one_forward, qparams  # noqa: F401 (fixtures)

# level 0's stages (returned packed) and a few beyond it
STAGES = ["enc0_conv1", "enc0_conv2", "pool0", "enc1_conv2", "bottleneck_conv2", "up1",
          "up0", "dec0_conv1", "dec0_conv2"]


def _int8(rng, shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------- the k x k conv: library, plain


def _kxk_args(seed, shape, k, cout):
    rng = np.random.RandomState(seed)
    x = _int8(rng, shape)
    w = _int8(rng, (k, k, shape[-1], cout))
    alpha = (rng.rand(cout) * 4e-4).astype(np.float32)
    beta = (rng.randn(cout) * 3).astype(np.float32)
    return x, w, alpha, beta


@pytest.mark.parametrize("shape,cout", [((2, 9, 12, 32), 16), ((1, 7, 10, 24), 40)])
def test_library_route_takes_2x2_like_jax(shape, cout, monkeypatch):
    """conv_int8_acc and conv3x3_int8_xla on 2x2 (packed) kernels: bit-equal
    to JAX's conv3x3_int8_xla and its int32 conv, in one im2col block and in
    several; a cropped (strided) input reads in place."""
    x, w, alpha, beta = _kxk_args(1, shape, 2, cout)
    jargs = [jnp.asarray(a) for a in (x, w, alpha, beta)]
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    acc = np.asarray(lax.conv_general_dilated(jargs[0], jargs[1], (1, 1), "VALID",
                                              dimension_numbers=dn,
                                              preferred_element_type=jnp.int32))
    got = tct.conv_int8_acc(_t(x), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), acc)
    for out_kind in ("int8", "bf16"):
        want = _jnp(jct.conv3x3_int8_xla(*jargs, out_kind=out_kind))
        np.testing.assert_array_equal(
            _np(tct.conv3x3_int8_xla(*[_t(a) for a in (x, w, alpha, beta)], out_kind)), want)
    monkeypatch.setattr(tct, "IM2COL_BYTES", 3 * (shape[2] - 1) * 4 * shape[3])
    np.testing.assert_array_equal(tct.conv_int8_acc(_t(x), _t(w)).numpy(), acc)
    big = torch.zeros((shape[0], shape[1] + 4, shape[2] + 2, shape[3]), dtype=torch.int8)
    big[:, 2:-2, 1:-1] = _t(x)
    np.testing.assert_array_equal(tct.conv_int8_acc(big[:, 2:-2, 1:-1], _t(w)).numpy(), acc)
    with pytest.raises(ValueError, match=r"k in \(2, 3\)"):
        tct.conv_int8_acc(_t(x), torch.zeros((1, 1, shape[3], 4), dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\[3, 3, "):      # K3 stays 3x3 only
        tct.conv3x3_fused(*[_t(a) for a in (x, w, alpha, beta)])


@pytest.mark.parametrize("k,shape,cout", [(2, (2, 11, 14, 32), 32), (2, (1, 9, 8, 16), 24),
                                          (3, (2, 10, 13, 16), 8), (3, (1, 8, 9, 24), 40)])
def test_kxk_plain_matches_jax(k, shape, cout):
    """conv_kxk_fused_plain and both wrapper names (the plain version on the
    CPU) against JAX's conv3x3_int8_xla, P2's own oracle: bit for bit, and
    no launch counted."""
    x, w, alpha, beta = _kxk_args(k, shape, k, cout)
    want = _jnp(jct.conv3x3_int8_xla(*[jnp.asarray(a) for a in (x, w, alpha, beta)],
                                     out_kind="int8"))
    assert 0 < (want > 0).mean() < 1
    args = [_t(a) for a in (x, w, alpha, beta)]
    before = conv_kxk.conv_kxk_fused.launches
    outs = [conv_kxk.conv_kxk_fused_plain(*args), conv_kxk.conv_kxk_fused(*args),
            conv_kxk.conv_rows3_col(*args, block_cols=128)]
    if k == 2:
        outs.append(conv_kxk.conv2x2_fused(*args, cout_tile=cout, variant="rows2"))
    for got in outs:
        assert got.dtype == torch.int8 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    assert conv_kxk.conv_kxk_fused.launches == before


def test_kxk_wrappers_check_the_tiling_arguments():
    x, w, alpha, beta = [_t(a) for a in _kxk_args(0, (1, 6, 6, 16), 2, 32)]
    with pytest.raises(ValueError, match="variant"):
        conv_kxk.conv2x2_fused(x, w, alpha, beta, cout_tile=32, variant="taps")
    with pytest.raises(ValueError, match="cout_tile"):
        conv_kxk.conv2x2_fused(x, w, alpha, beta)              # 256 does not divide 32
    with pytest.raises(ValueError, match="cout_tile"):
        conv_kxk.conv_rows3_col(x, w, alpha, beta, cout_tile=24)
    with pytest.raises(ValueError, match="block_rows"):
        conv_kxk.conv2x2_fused(x, w, alpha, beta, cout_tile=32, block_rows=0)
    with pytest.raises(ValueError, match="block_cols"):
        conv_kxk.conv_rows3_col(x, w, alpha, beta, block_cols=0)
    w3 = torch.zeros((3, 3, 16, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match=r"\[2, 2"):
        conv_kxk.conv2x2_fused(x, w3, alpha, beta, cout_tile=32)
    with pytest.raises(TypeError, match="int8"):
        conv_kxk.conv_kxk_fused(x.float(), w.float(), alpha, beta)
    with pytest.raises(ValueError, match="alpha"):
        conv_kxk.conv_rows3_col(x, w, alpha[:8], beta)


# (layer, packed input H = W, Cin, Cout) of the two packed 2x2 int8 convs
# of a full-width 572^2 tile: enc0_conv2 (286 -> 285 -> 284) and dec0_conv2
# (196 -> 195 -> 194).
PACKED_MAIN_PATH = [("enc0_conv2", 285, 256, 256), ("dec0_conv2", 195, 256, 256)]


@pytest.mark.parametrize("name,s,cin,cout", PACKED_MAIN_PATH)
def test_packed_convs_route_to_the_wgmma_loop(name, s, cin, cout):
    x = torch.zeros((1, 3, s, cin), dtype=torch.int8)
    w = torch.zeros((2, 2, cin, cout), dtype=torch.int8)
    assert conv_kxk.conv_kxk_route(x, w) == "sm90"
    assert tct.sm90_block(cout) == (256, 128)


@pytest.mark.parametrize("label,shape,k,cout,dtype,route", [
    ("Cin 16, Cout 16, 3x3", (1, 5, 5, 16), 3, 16, torch.int8, "sm90"),
    ("Cin 3", (1, 5, 5, 3), 3, 16, torch.int8, "simple"),
    ("Cin 24", (1, 5, 5, 24), 2, 16, torch.int8, "simple"),
    ("Cout 5", (1, 5, 5, 16), 2, 5, torch.int8, "simple"),
    ("Cout 40", (1, 5, 5, 16), 2, 40, torch.int8, "simple"),
    ("bf16 x", (1, 5, 5, 16), 2, 16, torch.bfloat16, "simple"),
])
def test_kxk_route_by_dtype_and_channels(label, shape, k, cout, dtype, route):
    x = torch.zeros(shape, dtype=dtype)
    w = torch.zeros((k, k, shape[3], cout), dtype=dtype)
    assert conv_kxk.conv_kxk_route(x, w) == route, label


def test_kxk_route_takes_a_misaligned_x_on_the_simple_kernel():
    buf = torch.zeros(5 * 5 * 16 + 16, dtype=torch.int8)
    off = (-buf.data_ptr()) % 16 + 3
    x = buf[off:off + 5 * 5 * 16].view(1, 5, 5, 16)
    assert x.data_ptr() % 16 == 3
    assert conv_kxk.conv_kxk_route(x, torch.zeros((2, 2, 16, 16), dtype=torch.int8)) == "simple"
    assert conv_kxk.conv_kxk_route(x.clone(), torch.zeros((2, 2, 16, 16),
                                                          dtype=torch.int8)) == "sm90"


def test_kxk_forced_route_refuses_what_its_route_does_not_take():
    x, w, alpha, beta = [_t(a) for a in _kxk_args(1, (1, 6, 6, 24), 2, 16)]
    with pytest.raises(ValueError, match="sm90 route does not take"):
        conv_kxk._conv_kxk_route_forward(x, w, alpha, beta, "sm90")          # Cin 24
    with pytest.raises(ValueError, match="no route"):
        conv_kxk._conv_kxk_route_forward(x, w, alpha, beta, "library")
    with pytest.raises(ValueError, match="cuda"):
        conv_kxk._conv_kxk_route_forward(x, w, alpha, beta, "simple")        # a CPU tensor
    assert conv_kxk.conv_kxk_fused.launches == conv_kxk.conv_kxk_fused.sm90_launches == 0


def test_k3_and_the_kxk_conv_share_one_kernel_source():
    """K3 and the k x k conv launch the kernels of one header: neither
    source holds a kernel or inline PTX of its own."""
    from tpu_unet_torch.ops import _build

    srcs = {os.path.basename(p): open(p).read() for p in _build.sources()}
    for name in ("conv3x3_fused.cu", "conv_kxk_fused.cu"):
        assert '#include "conv_fused.cuh"' in srcs[name]
        assert "__global__" not in srcs[name] and "asm" not in srcs[name]
    header = srcs["conv_fused.cuh"]
    assert header.count("__global__") == 2        # the one-stage kernel and the loop


# ---------------------------------------------------- the phase engine


def _rect(nets):
    """The two test images widened to 188 x 204 (both valid sizes: output
    4 x 20), so that the packed crops run on a rectangle."""
    x = nets["x"]
    return np.concatenate([x, x[:, :, :16]], axis=2)


@pytest.fixture(scope="module")
def jax_phase(nets, qparams):
    """JAX's impl='xla' phase engines, run eagerly: the stages and the
    logits per mode, on the rectangular input."""
    x = jnp.asarray(_rect(nets))
    out = {}
    for mode in ("bf16", "int8"):
        seen, logits = one_forward(jq.QuantInference(qparams[0], impl="xla",
                                                     phase_level0=mode), x)
        out[mode] = {st: np.asarray(seen[st]) for st in STAGES}
        out[mode]["logits"] = np.asarray(logits)
    return out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_phase_engine_matches_jax(nets, qparams, jax_phase, mode, impl):
    """Given the same QuantParams, every stage of the port's phase engine
    equals JAX's eager impl='xla' one bit for bit (the int8 stages, and
    here the bf16 ones too), level 0's packed; the logits at rtol 1e-4. The
    input is rectangular (188 x 204); the square one is held through
    evaluate() in test_torch_quant_eval.py."""
    qi = tq.QuantInference(qparams[1], impl=impl, phase_level0=mode, device="cpu")
    x = torch.from_numpy(_rect(nets))
    n_int8 = 0
    seen, logits = one_forward(qi, x)
    for st in STAGES:
        want = jax_phase[mode][st]
        got = seen[st]
        assert got.shape == want.shape, st
        if want.dtype == np.int8:
            n_int8 += 1
            assert got.dtype == torch.int8, st
        np.testing.assert_array_equal(_np(got), _jnp(want), err_msg=st)
    w0 = nets["cfg"].widths[0]
    assert qi.apply(x, stop_after="enc0_conv2").shape == (2, 92, 100, 4 * w0)   # packed
    assert n_int8 == (6 if mode == "int8" else 3)
    assert logits.shape == (2, 4, 20, 2)
    np.testing.assert_allclose(logits.numpy(), jax_phase[mode]["logits"], rtol=1e-4, atol=1e-5)


def test_phase_engine_checks_like_jax(nets, qparams):
    tqp = qparams[1]
    for bad, match in ((dataclasses.replace(tqp, cfg=dataclasses.replace(
            tqp.cfg, skip_variant="parity")), "paper"),
                       (dataclasses.replace(tqp, cfg=dataclasses.replace(
                           tqp.cfg, in_channels=3)), "1-channel"),
                       (dataclasses.replace(tqp, scales={k: v for k, v in tqp.scales.items()
                                                         if k != "up0"}), "up0")):
        with pytest.raises(ValueError, match=match):
            tq.QuantInference(bad, phase_level0="int8", device="cpu")
    with pytest.raises(ValueError, match="phase_level0 must be"):
        tq.QuantInference(tqp, phase_level0="int4", device="cpu")
    q1 = tq.prepare_quant_params(nets["cfg"], nets["params"], tqp.scales,
                                 tqp.qnames | {"enc0_conv1"})
    with pytest.raises(ValueError, match="enc0_conv1"):
        tq.QuantInference(q1, phase_level0="bf16", device="cpu")
    # the research flags still refuse it; alone it is the production engine
    with pytest.raises(ValueError, match="phase_level0"):
        tqr.ResearchQuantInference(tqp, phase_level0="int8", fused_enc0=True, device="cpu")
    x = torch.from_numpy(nets["x"])
    assert torch.equal(tqr.ResearchQuantInference(tqp, phase_level0="int8",
                                                  device="cpu").apply(x),
                       tq.QuantInference(tqp, phase_level0="int8", device="cpu").apply(x))


def test_calibration_through_the_phase_model(nets, qparams):
    """A model under cfg.phase_level0 is calibrated through its packed
    forward, as JAX's build_quant_inference calibrates one: its level-0
    outputs are the plain model's values in another order, so every scale
    is JAX's at rtol 1e-4 (f32 sums in other orders), and the engine built
    from it serves level 0 phase-packed."""
    from tpu_unet_torch.models import UNet

    model_p = UNet(dataclasses.replace(nets["cfg"], phase_level0=True))
    model_p.load_state_dict(nets["float32"].state_dict())
    x = torch.from_numpy(nets["x"])
    qi = tq.build_quant_inference(model_p, x, min_channels=16, phase_level0="int8")
    want = qparams[0].scales
    assert set(qi.qp.scales) == set(want) and qi.qp.qnames == qparams[0].qnames
    for k, v in want.items():
        assert qi.qp.scales[k] == pytest.approx(v, rel=1e-4), k
    assert qi.qp.cfg.phase_level0 and qi.apply(x, stop_after="enc0_conv2").shape[-1] == 32


@pytest.mark.parametrize("entry", ["QuantInference", "Trainer"])
def test_entry_points_default_to_cuda(qparams, monkeypatch, entry):
    """Without device=, the entry points take the card; where there is none
    they raise, naming device="cpu", and never move to the CPU themselves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if entry == "QuantInference":
            tq.QuantInference(qparams[1])
        else:
            Trainer(DatasetConfig(name="s", crop=20, metric="iou", weight_mode="distance",
                                  goal=1.0, goal_direction="max"), out_dir=os.devnull)
    assert tq.QuantInference(qparams[1], device="cpu").device == torch.device("cpu")
