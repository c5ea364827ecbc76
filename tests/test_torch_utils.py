"""The port's morphology (tpu_unet_torch/ops/morphology.py) against the JAX
package's on seeded inputs, and its timing and debug helpers
(tpu_unet_torch/utils/) on CPU tensors."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_unet.ops.morphology import binary_threshold as jax_binary_threshold
from tpu_unet.ops.morphology import dilate as jax_dilate
from tpu_unet_torch.ops.morphology import binary_threshold, dilate
from tpu_unet_torch.utils import (StepTimer, debug_flags, enable_nan_checks,
                                  measure_roundtrip, timeit_readback, trace_capture)


def _image(dtype, seed, shape=(23, 31)):
    rng = np.random.RandomState(seed)
    if dtype == np.float32:
        return rng.randn(*shape).astype(np.float32)
    return rng.randint(-1000, 1000, size=shape).astype(dtype)


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_dilate_equals_jax(dtype, ksize, iterations):
    x = _image(dtype, seed=ksize * 10 + iterations)
    got = dilate(torch.from_numpy(x), ksize=ksize, iterations=iterations)
    want = np.asarray(jax_dilate(jnp.asarray(x), ksize=ksize, iterations=iterations))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_dilate_binary_mask_and_even_window():
    mask = np.zeros((16, 16), np.float32)
    mask[7, 9] = 255.0
    got = dilate(torch.from_numpy(mask), ksize=5, iterations=2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_dilate(jnp.asarray(mask), 5, 2)))
    assert got.sum() == 255.0 * 81                    # a 9x9 square
    even = dilate(torch.from_numpy(mask), ksize=4).numpy()
    np.testing.assert_array_equal(even, np.asarray(jax_dilate(jnp.asarray(mask), 4)))


@pytest.mark.parametrize("dtype,thresh,maxval", [(np.float32, 0.25, 255.0),
                                                 (np.int32, 10, 255.0),
                                                 (np.uint8, 127, 1.0)])
def test_binary_threshold_equals_jax(dtype, thresh, maxval):
    x = _image(np.float32, seed=2) if dtype == np.float32 else \
        np.random.RandomState(2).randint(0, 256, size=(19, 17)).astype(dtype)
    got = binary_threshold(torch.from_numpy(x), thresh, maxval)
    want = np.asarray(jax_binary_threshold(jnp.asarray(x), thresh, maxval))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_step_timer_on_cpu_tensors():
    timer = StepTimer()
    assert np.isnan(timer.mean) and np.isnan(timer.best())
    x = torch.ones(64, 64)
    for _ in range(3):
        timer.start()
        y = x @ x
        timer.stop(y)
    assert len(timer.times) == 3 and all(t > 0 for t in timer.times)
    assert timer.best() <= timer.p50 and timer.best() <= timer.mean


def test_timeit_readback_on_cpu_tensors():
    calls = []
    x = torch.ones(32, 32)

    def fn(a):
        calls.append(1)
        return a @ a

    s = timeit_readback(fn, x, n=3, reps=4)
    assert s > 0 and len(calls) == 1 + 3 * 4          # one warm-up, n x reps timed
    with pytest.raises(ValueError, match="tensor argument"):
        timeit_readback(fn, 3.0)


def test_measure_roundtrip_on_cpu():
    assert measure_roundtrip(n=3, device="cpu") >= 0.0


def test_trace_capture_writes_a_chrome_trace(tmp_path):
    with trace_capture(str(tmp_path / "trace")):
        torch.ones(8, 8).add_(1)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_trace_capture_without_a_dir_yields_the_profiler(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace_capture() as prof:
        torch.ones(8, 8).add_(1)
    assert any("add_" in ev.key for ev in prof.key_averages())
    assert os.listdir(tmp_path) == []


@pytest.mark.filterwarnings("ignore:Error detected in SqrtBackward0:UserWarning")
@pytest.mark.filterwarnings("ignore:Anomaly Detection has been enabled:UserWarning")
def test_debug_flags_restore_the_anomaly_flag():
    assert not torch.is_anomaly_enabled()
    with debug_flags(nan_checks=True):
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1).sum().backward()
    assert not torch.is_anomaly_enabled()
    with pytest.raises(KeyError):
        with debug_flags(nan_checks=True):
            raise KeyError("restored on an error too")
    assert not torch.is_anomaly_enabled()
    try:
        enable_nan_checks()
        assert torch.is_anomaly_enabled()
        with debug_flags():
            assert torch.is_anomaly_enabled()
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
