"""The TransUNet cell: its reference against the repository's, its costs,
its readers on a trace made by hand, its driver's imports, and the cell run
on the CPU at a small size, where `correct` comes out true for the program
and false for the control and for each planted fault. The tests marked
``cuda`` plant the faults at the published size on the card:
``python -m pytest -m cuda benchmarks/tests/test_portbench_transunet.py``."""

import copy
import math
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmarks import costs_transunet, harness
from benchmarks.reference import transunet as rtu

CELL = "serve-transunet-16x512"
#: The published configuration cut to what the CPU runs in seconds: the
#: trunk and the decoder keep their widths (the decoder's, if cut below the
#: skips', would leave the ViT a share of the logits under the fp8
#: control's gap), the trunk takes 1, 1, 2 units, the ViT 2 narrow blocks.
SMALL = {"img_size": 64, "hidden": 64, "heads": 4, "layers": 2, "mlp": 128,
         "resnet_units": [1, 1, 2], "decoder_channels": [256, 128, 64, 16]}


def tiny_cell(frames=3, batch_tiles=2) -> dict:
    """The cell at `SMALL`, 64 x 64 frames, `frames` a request in chunks of
    `batch_tiles` slices (the last one filled up)."""
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell["config"]["model"].update(SMALL)
    cell["traffic"].update(frame_hw=[64, 64], pool_frames=6, frames_per_request=frames,
                           tile_out=64, batch_tiles=batch_tiles, distinct_requests=2)
    return cell


def _run(cell, seed=2 ** 31 + 5, seconds=3.0):
    """The cell's run, a window long enough that both sampled requests (the
    window's first two) are served on a CPU shared with other test workers
    (one never sent reads as never come); (correct, the run's output)."""
    out = harness.load_driver("serve_transunet").run(cell, seed, seconds, False,
                                                     time.perf_counter(), device="cpu")
    ok, checks = harness.judge(out["numbers"], harness.limits(cell))
    return ok and out["failed"] == 0 and out["attempted"] > 0, out


def _readings(cell, seed=2 ** 31 + 5, device="cpu"):
    """control.py's readings: the program's and the control's numbers on
    the sampled requests, with no window; each with whether it is correct."""
    r = harness.load_driver("serve_transunet").readings(cell, seed, cell["config"]["control"],
                                                        device=device)
    return {k: (harness.judge(v, harness.limits(cell))[0], v) for k, v in r.items()}


def test_the_reference_is_the_repository_reference():
    from tpu_unet_torch.config import TransUNetConfig
    from tpu_unet_torch.models import transunet_ref

    m = dict(harness.load_cell(CELL)["config"]["model"], **SMALL)
    params = rtu.make_params(m, 2 ** 31 + 3, "cpu")
    x = torch.rand(2, 64, 64, 1, generator=torch.Generator().manual_seed(1))
    cfg = TransUNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
    with torch.no_grad():
        got = rtu.forward(params, x, m)
    want = transunet_ref.forward(params, x, cfg)
    assert got.shape == (2, 64, 64, 9)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_the_weights_and_statistics_are_a_function_of_the_seed():
    m = dict(harness.load_cell(CELL)["config"]["model"], **SMALL)
    a, b, c = (rtu.make_params(m, s, "cpu") for s in (5, 5, 6))
    assert all(torch.equal(a[k], b[k]) for k in a)
    var = a["decoder.conv_more.1.running_var"]
    assert not torch.equal(a["decoder.conv_more.0.weight"], c["decoder.conv_more.0.weight"])
    assert (var > 0).all() and var.std() > 0.05
    assert a["decoder.conv_more.1.running_mean"].std() > 0.05


def test_every_matrix_is_drawn_as_a_matrix_and_the_residual_branches_small():
    """Convs He-normal and linears of std sqrt(1 / fan-in) at every index,
    the second block's and the second decoder block's too (not drawn as a
    norm's 1 + 0.1 N); each unit's last GroupNorm scale near 0.1."""
    m = dict(harness.load_cell(CELL)["config"]["model"], **SMALL)
    p = rtu.make_params(m, 7, "cpu")
    for name, t in p.items():
        if t.dim() < 2 or "position" in name:
            continue
        fan_in = math.prod(t.shape[1:])
        gain = 1.0 if (t.dim() == 2 or "patch" in name) else 2.0
        assert abs(t.mean().item()) < 0.1 * t.std().item(), name
        assert t.std().item() == pytest.approx(math.sqrt(gain / fan_in), rel=0.2), name
    assert "transformer.encoder.layer.1.attn.query.weight" in p
    assert "decoder.blocks.1.conv1.0.weight" in p
    gn3 = torch.cat([t for k, t in p.items() if k.endswith("gn3.weight")])
    assert gn3.mean().item() == pytest.approx(rtu.RESIDUAL_SCALE, rel=0.05)


def test_costs_are_336_79_gflop_a_slice():
    m = harness.load_cell(CELL)["config"]["model"]
    f = costs_transunet.forward_flops(m)
    assert f["total"] == 336_794_714_112
    assert f["resnet"] == pytest.approx(41.0e9, rel=2e-3)
    assert f["vit"] == pytest.approx(214.2e9, rel=1e-3)
    assert f["attention"] == 12 * 4 * 1024 * 1024 * 768
    assert f["decoder"] == pytest.approx(81.6e9, rel=1e-3)
    convs = costs_transunet.trunk_convs(m)
    assert len(convs) == 1 + 3 * 16 + 3 and convs[1][0] == 127 and convs[-1][0] == 32
    nbytes, ops = costs_transunet.attention_cost((16, 12, 1024, 64), 2)
    assert ops == 16 * 12 * 4 * 1024 * 1024 * 64 and nbytes == 4 * 16 * 12 * 1024 * 64 * 2
    assert costs_transunet.attention_bound_s((16, 12, 1024, 64), "bfloat16") == \
        pytest.approx(ops / 989e12)


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1.0, "tid": 1,
            "args": {"correlation": corr}}


def _op(name, ts, dur, corr):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _trace(program=True):
    """One request: the trunk (10 us), the ViT (20 us, 30 in 'attn' inside
    it) and the decoder (5 us, 40 in 'k1' inside it)."""
    plan = [("transunet.resnet", None, 10), ("transunet.vit", None, 20),
            ("transunet.vit", "attn", 30), ("transunet.decoder", None, 5),
            ("transunet.decoder", "k1", 40)]
    spans, launches, ops = [], [], []
    for k, (name, inner, dur) in enumerate(plan):
        launches.append(_launch(10.0 * k + 1, k))
        ops.append(_op(f"op{k}", 100.0 * k, dur, k))
        if program:
            spans.append(_span(name, 10.0 * k, 5.0))
        if inner:
            spans.append(_span(inner, 10.0 * k + 0.5, 2.0))
    m = harness.load_cell(CELL)["config"]["model"]
    q = ((16, 12, 1024, 64), "bfloat16")
    return harness.Trace(spans + launches + ops, (ops, 0.05), {"requests": 1, "tiles": 16,
                                                              "chips": 1},
                         {"attn": [[q, q, q]]}, {"precision": "bfloat16", "model": m})


def test_the_readers():
    t = _trace()
    read = {n: harness.metric_reader(n) for n in (
        "transunet.resnet_ms", "transunet.vit_ms", "transunet.decoder_ms", "attn_roofline",
        "mfu.serve_transunet")}
    assert read["transunet.resnet_ms"](t) == pytest.approx(0.010)
    assert read["transunet.vit_ms"](t) == pytest.approx(0.050)
    assert read["transunet.decoder_ms"](t) == pytest.approx(0.045)
    bound = 16 * 12 * 4 * 1024 * 1024 * 64 / 989e12
    assert read["attn_roofline"](t) == pytest.approx(100 * bound / 30e-6)
    assert read["mfu.serve_transunet"](t) == pytest.approx(
        100 * 16 * 336_794_714_112 / (0.05 * 989e12))
    parent = _trace(program=False)
    assert read["transunet.resnet_ms"](parent) is None
    assert read["transunet.vit_ms"](parent) == pytest.approx(0.030)   # 'attn' alone


def test_the_driver_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); from benchmarks import harness; "
            "harness.load_driver('serve_transunet'); "
            "import tpu_unet_torch.models.transunet, tpu_unet_torch.infer.tiles; "
            "print(harness.forbidden_modules())" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_cell_runs_and_is_correct():
    ok, out = _run(tiny_cell())
    assert ok, out["numbers"]
    assert out["e2e"]["tiles_per_s"] > 0 and out["numbers"]["map_vs_own_logits"] == 0


@pytest.mark.parametrize("frames,batch_tiles", [(3, 2), (2, 2)], ids=["filled", "whole"])
def test_the_program_is_correct_and_the_control_is_not(frames, batch_tiles):
    r = _readings(tiny_cell(frames, batch_tiles))
    assert r["program"][0], r["program"][1]
    ok, numbers = r["control"]
    assert not ok and numbers["logit_err_vs_control"] == pytest.approx(1.0, rel=1e-3)
    assert numbers["token_err_vs_control"] == pytest.approx(1.0, rel=1e-3)


def _plant(monkeypatch, fault: str) -> None:
    """A fault in the ViT (its position table dropped, or attention scaled
    by 1 / d or by 1 in place of 1 / sqrt(d)) or in the decoder (its
    upsample without aligned corners)."""
    import torch.nn.functional as F

    import tpu_unet_torch.models.transunet as tu

    if fault == "upsample_without_aligned_corners":
        def misaligned(x):
            y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                              align_corners=False)
            return y.permute(0, 2, 3, 1)
        monkeypatch.setattr(tu, "upsample2", misaligned)
    elif fault == "no_position_table":
        prepare = tu.TransUNet.prepare

        def without(self):
            p = prepare(self)
            p.pos = torch.zeros_like(p.pos)
            return p
        monkeypatch.setattr(tu.TransUNet, "prepare", without)
    else:
        def scaled(q, k, v):
            d = q.shape[-1]
            return F.scaled_dot_product_attention(
                q, k, v, scale=1.0 / d if fault == "attention_scale_1_over_d" else 1.0)
        monkeypatch.setattr(tu, "attention", scaled)


FAULTS = ["no_position_table", "attention_scale_1_over_d", "attention_scale_1"]


@pytest.mark.parametrize("fault", FAULTS + ["upsample_without_aligned_corners"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    """Each ViT fault by the tokens' number, the decoder's by the logits'."""
    _plant(monkeypatch, fault)
    cell = tiny_cell()
    ok, numbers = _readings(cell)["program"]
    key = "logit_err_vs_control" if fault.startswith("upsample") else "token_err_vs_control"
    assert not ok and numbers[key] > harness.limits(cell)[key]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_a_fault_in_the_vit_is_not_correct_at_512(card, monkeypatch, fault):
    """The published cell on the card: the program reads correct, and each
    planted fault does not, by the tokens' number."""
    if fault:
        _plant(monkeypatch, fault)
    cell = harness.load_cell(CELL)
    ok, numbers = _readings(cell, 2 ** 31 + 29, device="cuda")["program"]
    print(fault, numbers)
    limit = harness.limits(cell)["token_err_vs_control"]
    assert ok if fault is None else (not ok and numbers["token_err_vs_control"] > limit), numbers


def test_nine_classes_from_the_instances():
    inst = torch.tensor([[0, 1, 8, 9, 17]])
    assert rtu.class_labels(inst, 9).tolist() == [[0, 1, 8, 1, 1]]
    maps = np.array([[[0, 3], [5, 5]]])
    labels = np.array([[[0, 3], [4, 0]]])
    np.testing.assert_allclose(rtu.metrics(maps, labels), [[2 / 3, 0.5]])


def test_the_cell_reports_its_metrics():
    cell = harness.load_cell(CELL)
    assert {m["name"] for m in cell["end_to_end"]} == {"tiles_per_s", "request_p95_ms", "setup_s"}
    assert {"serve.idle_pct", "serve.engine_ms", "k1_roofline", "mfu.serve_transunet",
            "attn_roofline", "transunet.resnet_ms", "transunet.vit_ms",
            "transunet.decoder_ms"} == {m["name"] for m in cell["per_layer"]}
