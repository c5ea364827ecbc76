"""The trace's reduction and the per-layer readers, on a small trace made
by hand: each device operation goes to the span that launched it, and a
reader reads what its layer ran."""

import pytest

from benchmarks import harness


def _trace():
    span = {"cat": "user_annotation", "name": "gather", "ts": 100.0, "dur": 50.0, "tid": 1}
    launch = {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110.0, "dur": 5.0,
              "tid": 1, "args": {"correlation": 7}}
    cat = {"cat": "kernel", "name": "CatArrayBatchedCopy", "ts": 200.0, "dur": 10.0,
           "args": {"correlation": 7}}
    # NCCL launches its kernels itself: no host launch carries their correlation
    nccl = {"cat": "kernel", "name": "ncclDevKernel_AllGather_RING_LL", "ts": 150.0, "dur": 40.0,
            "args": {"correlation": 99}}
    conv = {"cat": "kernel", "name": "conv3x3_kernel", "ts": 300.0, "dur": 100.0,
            "args": {"correlation": 8}}
    events = [span, launch, cat, nccl, conv]
    return harness.Trace(events, ([cat, nccl, conv], 0.0005), {"tiles": 64, "chips": 4},
                         {"gather": [[((16, 388, 388), "int32")]]}, {})


def test_operations_go_to_the_span_that_launched_them():
    t = _trace()
    assert t.span_device_s("gather") == pytest.approx(10e-6)
    assert t.busy_s == pytest.approx(150e-6)
    assert t.top_ops(1) == [["conv3x3_kernel", pytest.approx(100e-6)]]


def test_the_gather_counts_its_collective():
    assert harness.metric_reader("mesh.gather_ms")(_trace()) == pytest.approx(0.05)


def test_the_idle_share():
    assert harness.metric_reader("mesh.idle_pct")(_trace()) == pytest.approx(70.0)
