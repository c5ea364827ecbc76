"""What every driver of the benchmark shares: finding a cell's files by name,
the seeds, the checks on the card and on the modules loaded, spans around
the program's calls, the reading of a profiler trace, and the result line.

Nothing here imports the program; the drivers do.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import os
import sys
import time
from bisect import bisect_left, bisect_right
from typing import Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: Modules that may not be loaded in a process that prints a result,
#: compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_unet")


class Refused(Exception):
    """A run that must end without a result (exit code 2)."""


# -- the cell's files --------------------------------------------------------

def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_path: Optional[str] = None) -> dict:
    """The workload `name` of BENCHMARK.json with its configuration and
    traffic loaded and its metrics listed: {'name', 'chips', 'config',
    'traffic', 'end_to_end', 'per_layer'}."""
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    return make_cell(bench, cells[name])


def make_cell(bench: dict, w: dict) -> dict:
    """The cell of workload entry `w` ({'name', 'config', 'traffic',
    'chips'}) of `bench`, its files loaded."""
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))

    def mine(metrics):
        return [m for m in metrics if "workloads" not in m or w["name"] in m["workloads"]]

    return {"name": w["name"], "chips": w["chips"], "config": config, "traffic": traffic,
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(name: str):
    return load_file_module(os.path.join(HERE, "drivers", f"{name}.py"), f"bench_driver_{name}")


def metric_reader(name: str) -> Callable:
    """`read(trace)` of the per-layer metric `name` (metrics/<name>.py)."""
    mod = load_file_module(os.path.join(HERE, "metrics", f"{name}.py"),
                           "bench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read


# -- seeds, device, modules ---------------------------------------------------

def sub_seed(seed: int, tag: str) -> int:
    """A seed of its own for each use of the run's `seed` (63 bits)."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def require_cuda(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: this benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} visible")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(count: int, memory_peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak)}


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


# -- spans ---------------------------------------------------------------------

class Spans:
    """Wraps program functions, found as attributes of modules or objects,
    in `torch.profiler.record_function` ranges named after the benchmark's
    layers, and records each call's tensor shapes and dtypes; `restore`
    puts the originals back."""

    def __init__(self):
        self.calls: Dict[str, List[List[Tuple[tuple, str]]]] = {}
        self._saved: List[Tuple[object, str, object, bool]] = []

    def wrap(self, owner, attr: str, span: str) -> None:
        import torch

        fn = getattr(owner, attr)
        calls = self.calls.setdefault(span, [])

        def wrapped(*args, **kwargs):
            calls.append([(tuple(a.shape), str(a.dtype).replace("torch.", ""))
                          for a in args if isinstance(a, torch.Tensor)])
            with torch.profiler.record_function(span):
                return fn(*args, **kwargs)

        own = isinstance(owner, type(sys)) or attr in getattr(owner, "__dict__", {})
        self._saved.append((owner, attr, fn, own))
        setattr(owner, attr, wrapped)

    def restore(self) -> None:
        for owner, attr, fn, own in reversed(self._saved):
            if own:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
        self._saved.clear()


# -- the trace -------------------------------------------------------------------

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _device_ops(events: List[dict], span_of: Dict[int, Tuple[float, str]]) -> list:
    """(start us, end us, name, span or None) of every device operation."""
    ops = []
    for e in events:
        if e.get("cat") in _DEVICE_CATS and e.get("dur", 0) > 0:
            c = e.get("args", {}).get("correlation")
            ops.append((float(e["ts"]), float(e["ts"] + e["dur"]), e["name"],
                        span_of.get(c, (0, None))[1]))
    return sorted(ops)


def _union(ops: list) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b, _, _ in ops:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """What a per-layer metric reads, from two profiles of the same work:
    `plain`, the card's operations alone, whose window, busy time and
    operations give the idle share, the rates and the top operations; and
    `events`, host and card with the benchmark's spans, which says in which
    span each operation was launched (the host profile slows the host, so
    its window is not used). Also the spans' calls and the run's
    counters."""

    def __init__(self, events: List[dict], plain: Tuple[List[dict], float],
                 counters: Dict[str, float], calls: Dict[str, list], context: dict):
        self.window_s = plain[1]
        self.counters = counters
        self.calls = calls
        self.context = context
        spans = sorted((e for e in events if e.get("cat") == "user_annotation"),
                       key=lambda e: e["ts"])
        launches = sorted((e for e in events if e.get("cat") in _LAUNCH_CATS
                           and "correlation" in e.get("args", {})), key=lambda e: e["ts"])
        span_of: Dict[int, Tuple[float, str]] = {}
        starts = [e["ts"] for e in launches]
        for s in spans:
            lo, hi = bisect_left(starts, s["ts"]), bisect_right(starts, s["ts"] + s["dur"])
            for e in launches[lo:hi]:
                if e.get("tid") != s.get("tid"):
                    continue
                c = e["args"]["correlation"]
                if c not in span_of or s["dur"] < span_of[c][0]:
                    span_of[c] = (s["dur"], s["name"])
        self.ops = _device_ops(events, span_of)
        self._host = [(float(e["ts"]), float(e["ts"] + e["dur"]), e["name"])
                      for e in events if e.get("cat") in ("user_annotation", "cpu_op")
                      and e.get("dur", 0) > 0]
        self._busy = _union(self.ops)
        self.plain_ops = _device_ops(plain[0], {})
        self.busy_s = sum(b - a for a, b in _union(self.plain_ops)) / 1e6

    def span_device_s(self, span: str) -> float:
        """Device seconds of the operations launched inside `span`."""
        return sum(b - a for a, b, _, s in self.ops if s == span) / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for a, b, name, _ in self.plain_ops:
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device operations under the host
        profile, each named by the innermost host span or op running at its
        middle."""
        gaps = [(b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(self._busy, self._busy[1:])]
        out = []
        for length, mid in sorted(gaps, reverse=True)[:n]:
            inner = [h for h in self._host if h[0] <= mid <= h[1]]
            name = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "host"
            out.append([name, length / 1e6])
        return out


@contextlib.contextmanager
def profiled(host: bool = True):
    """Profile the enclosed work on the card, and on the host unless
    `host` is False; yields a dict that holds, after the block, 'events'
    (the Chrome trace's events) and 'window_s' (host clock, from the start
    to the card's finish)."""
    import tempfile

    import torch

    out: dict = {}
    acts = [torch.profiler.ProfilerActivity.CPU] if host or not torch.cuda.is_available() else []
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        yield out
        sync()
        out["window_s"] = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["events"] = load_json(path)["traceEvents"]
    finally:
        os.remove(path)


def per_layer(cell: dict, trace: Trace) -> Dict[str, dict]:
    """The cell's per-layer metrics that find something to read."""
    out = {}
    for m in cell["per_layer"]:
        v = metric_reader(m["name"])(trace)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def breakdown(trace: Trace) -> dict:
    return {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}


# -- the result ------------------------------------------------------------------

def limits(cell: dict) -> Dict[str, float]:
    """The limits of the numbers the cell's check compares: the
    configuration's, for the kind of check its traffic names."""
    return cell["config"]["limits"][cell["traffic"]["check"]]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """(every number within its limit, {name: {'value', 'limit'}}); a
    number that is not finite (a sample that never came) fails, and is
    written as a string, which JSON can carry."""
    import math

    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k]) else str(numbers[k]),
                  "limit": limits[k]} for k in limits}
    return ok, checks


def emit(result: dict, checks: dict) -> int:
    """Print the numbers compared to stderr and the result line to stdout,
    unless a forbidden module is loaded; returns the exit code."""
    bad = forbidden_modules()
    if bad:
        print(f"refused: forbidden modules loaded: {bad}", file=sys.stderr, flush=True)
        return 3
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(dict(result, checks=checks), allow_nan=False), flush=True)
    return 0


def log(*args) -> None:
    print("[bench]", *args, file=sys.stderr, flush=True)
