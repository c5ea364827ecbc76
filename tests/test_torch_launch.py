"""The port's one kernel launch path, `tpu_unet_torch.ops._build.launch`, on
the CPU: every module launches through it, it raises on a refused launch
with the kernel's name and shapes, and a wrapper counts its launch through
it. The C entries are replaced by stand-ins; nothing here needs a card."""

import ast
import pathlib

import pytest
import torch

from tpu_unet_torch.ops import _build, conv_pallas, gather

PACKAGE = pathlib.Path(__file__).resolve().parents[1] / "tpu_unet_torch"
# the stream and device calls that only the launch helper may make
_STREAM_NAMES = {"current_stream", "cuda_stream"}


def _launch_calls(tree):
    """(line, text) of each call of torch.cuda.device, current_stream or
    .cuda_stream (read or called) in `tree`."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            text = ast.unparse(node)
            if node.attr in _STREAM_NAMES or text == "torch.cuda.device":
                found.append((node.lineno, text))
    return found


def test_only_the_helper_touches_streams_and_devices():
    modules = sorted(PACKAGE.rglob("*.py"))
    assert len(modules) > 20
    offenders = {}
    for path in modules:
        found = _launch_calls(ast.parse(path.read_text()))
        if path.relative_to(PACKAGE).as_posix() == "ops/_build.py":
            assert found, "the helper itself switches devices"
        elif found:
            offenders[path.relative_to(PACKAGE).as_posix()] = found
    assert not offenders, f"launch outside ops/_build.launch: {offenders}"


def test_the_ast_check_finds_the_old_sequence():
    old = ("with torch.cuda.device(x.device):\n"
           "    stream = torch.cuda.current_stream(x.device).cuda_stream\n")
    assert sorted(t for _, t in _launch_calls(ast.parse(old))) == [
        "torch.cuda.current_stream", "torch.cuda.current_stream(x.device).cuda_stream",
        "torch.cuda.device"]


class _FakeLib:
    """A library whose entry records its arguments and returns `rc`."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def entry(self, *args):
        self.calls.append(args)
        return self.rc

    row_gather_f32 = conv3x3_bias_relu_f32 = entry

    @staticmethod
    def tpu_unet_torch_cuda_error_string(code):
        return {9: b"invalid configuration argument"}.get(code, b"unknown error")


@pytest.fixture
def fake_card(monkeypatch):
    """The helper's device and stream lookups, and the library, replaced:
    device 0 is current and its stream handle is 1234."""
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 1234 + index)

    def install(lib):
        monkeypatch.setattr(_build, "_lib", lib)
        return lib
    return install


def test_launch_passes_the_current_stream_last(fake_card):
    lib = fake_card(_FakeLib())
    _build.launch("k", lib.entry, 0, 7, None, 3)
    assert lib.calls == [(7, None, 3, 1234)]


def test_launch_raises_naming_the_kernel_and_shapes(fake_card):
    lib = fake_card(_FakeLib(rc=9))
    x = torch.zeros(2, 3, 5)
    with pytest.raises(RuntimeError) as err:
        _build.launch("edt_column_pass (sm90 route)", lib.entry, 0, 1, 2,
                      shapes=(("g2", x), ("C", 64)))
    msg = str(err.value)
    assert msg.startswith("edt_column_pass (sm90 route) launch failed: CUDA error 9 ")
    assert "invalid configuration argument" in msg and "g2 (2, 3, 5), C 64" in msg
    assert len(lib.calls) == 1                        # launched once, not retried


def test_launch_switches_device_only_when_another_is_current(fake_card, monkeypatch):
    lib = fake_card(_FakeLib())
    entered = []

    class _Device:
        def __init__(self, index):
            entered.append(index)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", _Device)
    _build.launch("k", lib.entry, 0)
    assert entered == []
    _build.launch("k", lib.entry, 1)
    assert entered == [1] and lib.calls == [(1234,), (1235,)]


def _cpu_as_current(monkeypatch):
    """A CPU tensor's get_device() is -1: make that the current device, so
    that a wrapper's launch on CPU stand-ins takes the helper's usual path
    (stream handle 1233)."""
    monkeypatch.setattr(_build, "_current_device", lambda: -1)


def test_row_gather_counts_its_launch_through_the_helper(fake_card, monkeypatch):
    lib = fake_card(_FakeLib())
    _cpu_as_current(monkeypatch)
    monkeypatch.setattr(gather, "_on_cuda", lambda name, *ts: True)
    src, idx = torch.rand(6, 2), torch.tensor([5, 0, -1], dtype=torch.int32)
    before = gather.row_gather.launches
    out = gather.row_gather(src, idx)
    assert gather.row_gather.launches == before + 1 and out.shape == (3, 2)
    (args,) = lib.calls
    assert args[0] == src.data_ptr() and args[1] == idx.data_ptr()
    assert args[2:] == (0, out.data_ptr(), 6, 3, 2, 2, 0, 1233)
    lib.rc = 9
    with pytest.raises(RuntimeError, match=r"row_gather launch failed.*src \(6, 2\), idx \(3,\)"):
        gather.row_gather(src, idx)
    assert gather.row_gather.launches == before + 1      # a refused launch counts nothing


def test_conv_counts_its_launch_through_the_helper(fake_card, monkeypatch):
    lib = fake_card(_FakeLib())
    _cpu_as_current(monkeypatch)
    x, w, b = torch.rand(1, 5, 6, 3), torch.rand(3, 3, 3, 4), torch.rand(4)
    before = conv_pallas.conv3x3_bias_relu.launches
    y = conv_pallas._launch_simple(x, w, b)
    assert conv_pallas.conv3x3_bias_relu.launches == before + 1
    assert y.shape == (1, 3, 4, 4)
    (args,) = lib.calls
    assert args[4:] == (1, 5, 6, 3, 4, 0, 1233)
