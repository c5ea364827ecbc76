"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: the same files and drivers, a base width of 8 and small frames."""

from __future__ import annotations

import copy

from benchmarks import harness

SERVE = {"frame_hw": [40, 40], "pool_frames": 6, "cells_per_frame": 3, "tile_out": 20,
         "distinct_requests": 2}
TRAIN = {"frame_hw": [64, 64], "train_frames": 24, "cells_per_frame": 3,
         "steps_per_epoch": 2}


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(harness.load_cell(name))
    cell["config"]["model"]["base_width"] = 8
    if "quant" in cell["config"]:
        # a width of 8 has the channels of 64 over 8: the same layers
        # reach 16 that reach 128 at the published width
        cell["config"]["quant"]["build"]["min_channels"] = 16
        cell["config"]["quant"]["calibration"]["size"] = 204
    tr = cell["traffic"]
    if tr["driver"] == "train":
        tr.update(TRAIN, crop=20)
    else:
        tr.update(SERVE)
        tr["frames_per_request"] = 2 * cell["chips"]
        tr["pool_frames"] = max(6, tr["frames_per_request"])
        tr["batch_tiles"] = 9 * tr["frames_per_request"]
    return cell
