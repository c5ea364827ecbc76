"""BENCHMARK.json holds to the benchmark's contract, every cell resolves
to its files by name, and a cell can be added as data alone."""

import json
import os
import re
import shutil
import time

import pytest

from benchmarks import harness
from benchmarks.tests.tiny import SERVE

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert BENCH["paths"] == ["benchmarks"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmarks/") and _line(c["why"]) and _line(c["source"])
        data = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads_and_the_four_chip_share():
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"]) and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        layers.setdefault(m["layer"], []).append(m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    assert os.path.exists(os.path.join(harness.HERE, "drivers", c["traffic"]["driver"] + ".py"))
    assert c["traffic"]["check"] in c["config"]["limits"]
    reported = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in reported, (m["name"], m["moves"])


def test_quantized_layers_are_those_the_program_quantizes():
    """A tier's `quant.layers` (what the reference puts on integer grids)
    names the convs the program's build quantizes with the same arguments."""
    from tpu_unet_torch.config import ModelConfig
    from tpu_unet_torch.infer.quant import default_quant_names

    tiers = [harness.load_json(os.path.join(harness.ROOT, c["file"])) for c in BENCH["configs"]]
    tiers = [c for c in tiers if "quant" in c]
    assert tiers
    for c in tiers:
        want = default_quant_names(ModelConfig(**c["model"]), c["quant"]["build"]["min_channels"])
        assert set(c["quant"]["layers"]) == set(want), c["name"]


@pytest.mark.parametrize("added", ["traffic", "configuration"])
def test_a_cell_is_added_as_data_alone(tmp_path, monkeypatch, added):
    """A copy of the benchmark gains a traffic mix (and, for
    'configuration', a serving tier built with other arguments) and a cell,
    as files and entries only, and the harness runs the new cell on the
    CPU."""
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    traffic = harness.load_json(os.path.join(harness.HERE, "traffic", "serve-4x512.json"))
    traffic.update(SERVE, frames_per_request=1, batch_tiles=9)
    (root / "benchmarks" / "traffic" / "serve-1x40.json").write_text(json.dumps(traffic))
    config, like = "unet2015-bf16", "serve-bf16-4x512"
    if added == "configuration":
        config, like = "unet2015-int8-xla", "serve-int8-4x512"
        tier = harness.load_json(os.path.join(harness.HERE, "configs", "unet2015-int8.json"))
        tier.update(name=config)
        tier["quant"]["build"]["impl"] = "xla"
        (root / "benchmarks" / "configs" / f"{config}.json").write_text(json.dumps(tier))
        bench["configs"].append({"name": config, "source": "https://arxiv.org/abs/1505.04597",
                                 "file": f"benchmarks/configs/{config}.json", "reduced": [],
                                 "why": "the int8 tier on its plain path"})
    bench["workloads"].append({"name": "serve-new-1x40", "config": config,
                               "traffic": "serve-1x40", "chips": 1, "why": "one frame"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and like in m["workloads"]:
            m["workloads"].append("serve-new-1x40")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", str(root))
    monkeypatch.setattr(harness, "HERE", str(root / "benchmarks"))
    cell = harness.load_cell("serve-new-1x40")
    cell["config"]["model"]["base_width"] = 8
    if "quant" in cell["config"]:
        cell["config"]["quant"]["build"]["min_channels"] = 16
        cell["config"]["quant"]["calibration"]["size"] = 204
    out = harness.load_driver("serve").run(cell, 3, 5.0, False, time.perf_counter(), device="cpu")
    ok, checks = harness.judge(out["numbers"], harness.limits(cell))
    assert ok and out["failed"] == 0 and out["e2e"]["tiles_per_s"] > 0, checks
