"""The readers of the program's own spans (`tiles.*`, `quant.*`,
`train.*`), on a small trace made by hand as test_portbench_readers.py
makes its own: each returns its known value, None where the program opens
no such span, and a benchmark span under a program span keeps its
operations."""

import pytest

from benchmarks import harness

NEW = ("serve.engine_ms", "mesh.engine_ms", "quant.convert_ms", "quant.float_ms",
       "train.forward_ms")


def _span(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": 1}


def _launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1.0, "tid": 1,
            "args": {"correlation": corr}}


def _op(name, ts, dur, corr, cat="kernel"):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _serve(program=True):
    """Two requests, each a 'tiles.evaluate' holding an upload, a cut, a
    quant.float and quant.convert forward with K3 inside it, an argmax, a
    stitch and the metrics; the client's readback after each."""
    spans, launches, ops = [], [], []
    for r, t0 in enumerate((0.0, 1000.0)):
        c = 100 * r
        # device: upload 10-20, cut 20-30, float 40-60, K3 60-100, convert 100-130,
        # argmax 150-160, stitch 160-170, metrics 170-180, readback 300-320
        plan = [("tiles.upload", 1, "Memcpy HtoD (Pageable -> Device)", 10, 10, "gpu_memcpy"),
                ("tiles.cut", 2, "reflect_pad", 20, 10, "kernel"),
                ("quant.float", 3, "cudnn_conv", 40, 20, "kernel"),
                ("k3", 4, "conv_int8_kernel", 60, 40, "kernel"),
                ("quant.convert", 5, "clamp", 100, 30, "kernel"),
                ("tiles.argmax", 6, "argmax", 150, 10, "kernel"),
                ("tiles.stitch", 7, "copy", 160, 10, "kernel"),
                ("tiles.metrics", 8, "reduce", 170, 10, "kernel")]
        for name, k, op, ts, dur, cat in plan:
            launches.append(_launch(t0 + k, c + k))
            ops.append(_op(op, t0 + ts, dur, c + k, cat))
            if name == "k3":                       # the harness's span, inside a program one
                spans.append(_span("quant.convert", t0 + k - 0.5, 0.9))
                spans.append(_span("k3", t0 + k - 0.4, 0.8))
            elif program:
                spans.append(_span(name, t0 + k - 0.2, 0.5))
        if program:
            spans.append(_span("tiles.evaluate", t0, 200.0))
        launches.append(_launch(t0 + 250, c + 9))
        ops.append(_op("Memcpy DtoH (Device -> Pageable)", t0 + 300, 20, c + 9, "gpu_memcpy"))
    if not program:
        spans = [s for s in spans if s["name"] == "k3"]
    events = spans + launches + ops
    return harness.Trace(events, (ops, 0.002), {"requests": 2, "tiles": 32, "chips": 1},
                         {"k3": [[((16, 284, 284, 128), "int8"), ((3, 3, 128, 128), "int8")]] * 2},
                         {})


def _train(program=True):
    """One step: the harness's 'augment' and 'weights', then a
    'train.forward'; the backward's operations are launched from another
    thread."""
    spans = [_span("augment", 1.0, 2.0), _span("weights", 4.0, 300.0)]
    if program:
        spans.append(_span("train.forward", 310.0, 5.0))
    launches = [_launch(2.0, 1), _launch(5.0, 2), _launch(300.0, 3), _launch(311.0, 4),
                dict(_launch(320.0, 5), tid=2)]
    ops = [_op("warp", 10, 20, 1), _op("cc_sweep", 30, 20, 2), _op("edt_column_pass", 300, 10, 3),
           _op("conv3x3_kernel", 310, 50, 4), _op("dgrad", 370, 30, 5)]
    return harness.Trace(spans + launches + ops, (ops, 0.0005),
                         {"steps": 1, "crops": 8, "chips": 1}, {}, {})


def read(name, t):
    return harness.metric_reader(name)(t)


def test_engine_convert_and_float_milliseconds():
    t = _serve()
    # upload 10 + cut 10 + argmax 10 + stitch 10 + metrics 10 us a request
    assert read("serve.engine_ms", t) == pytest.approx(0.05)
    assert read("mesh.engine_ms", t) == pytest.approx(0.05)
    assert read("quant.convert_ms", t) == pytest.approx(0.03)
    assert read("quant.float_ms", t) == pytest.approx(0.02)


def test_a_harness_span_under_a_program_span_keeps_its_operations():
    t = _serve()
    assert t.span_device_s("k3") == pytest.approx(80e-6)
    assert harness.metric_reader("k3_roofline")(t) is not None


def test_training_forward():
    t = _train()
    assert read("train.forward_ms", t) == pytest.approx(0.05)
    # the harness's spans keep their operations
    assert harness.metric_reader("train.weights_ms")(t) == pytest.approx(0.03)
    assert harness.metric_reader("train.augment_ms")(t) == pytest.approx(0.02)


@pytest.mark.parametrize("name", NEW)
def test_without_the_program_spans_none(name):
    t = _train(program=False) if name.startswith("train.") else _serve(program=False)
    assert read(name, t) is None
