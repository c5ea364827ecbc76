"""Serving cells: one closed-loop client sends requests of whole frames to
`TileInference.evaluate_batch` and waits for each request's class maps and
metrics on the host before it sends the next.

Set-up makes the weights and a pool of frames from the seed, builds the
engine (and, for the int8 tier, calibrates and quantizes in set-up), and
serves a few requests to warm every shape. The window then serves for
`--seconds`. A few requests drawn from the seed hand their tile logits to
the check, which runs after the window on the reference (serve_check.py).

The serve_mesh driver builds a `Server` on a mesh in each rank process.
"""

from __future__ import annotations

import gc
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmarks import generator, harness
from benchmarks.reference import lowp
from benchmarks.reference import serve_check as sc
from benchmarks.reference import tiles as rt
from benchmarks.reference import unet as ru

#: Requests served in set-up, before the window, to warm every shape.
WARMUP_REQUESTS = 3
#: Requests drawn from the seed, among the first `distinct_requests`,
#: whose outputs the check compares.
SAMPLED_REQUESTS = 2
#: Requests in each of the `--trace 1` run's two profiles.
TRACED_REQUESTS = 20
#: Tiles a reference forward takes at once.
REFERENCE_BLOCK = 8


class Server:
    """The program under test, built from the seed, and the client's
    inputs."""

    def __init__(self, cell: dict, seed: int, device, mesh=None):
        from tpu_unet_torch.config import ModelConfig
        from tpu_unet_torch.infer.tiles import TileInference
        from tpu_unet_torch.models.unet import UNet

        cfg, tr = cell["config"], cell["traffic"]
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.mcfg = cfg["model"]
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from tpu_unet_torch.ops import _build
            _build.load_library()
        harness.log(f"set-up: kernel library {time.perf_counter() - t0:.2f} s")
        self.params = ru.make_params(self.mcfg, harness.sub_seed(seed, "weights"), self.device)
        with torch.device(self.device):
            model = UNet(ModelConfig(**self.mcfg),
                         generator=torch.Generator(device=self.device).manual_seed(0))
        model.load_state_dict(self.params)
        harness.log(f"set-up: weights and model {time.perf_counter() - t0:.2f} s")
        h, w = tr["frame_hw"]
        gen = torch.Generator(device=self.device).manual_seed(harness.sub_seed(seed, "frames"))
        images, inst = generator.make_frames(tr["pool_frames"], h, w, tr["cells_per_frame"], gen)
        labels = generator.separated_targets(inst, tr["cells_per_frame"]) > 0
        self.pool = images.cpu().numpy()
        pool_labels = labels.to(torch.uint8).cpu().numpy()
        del images, inst, labels
        n = tr["frames_per_request"]
        if n > tr["pool_frames"]:
            raise ValueError(f"{n} distinct frames a request from a pool of {tr['pool_frames']}")
        rng = np.random.default_rng(harness.sub_seed(seed, "requests"))
        table = np.argsort(rng.random((tr["distinct_requests"], tr["pool_frames"])), 1)[:, :n]
        # each distinct request laid out once, so the client copies nothing
        # in the window: request i sends block i mod distinct_requests
        self.requests = [(self.pool[idx], pool_labels[idx]) for idx in table]
        self.sampled = set(rng.choice(tr["distinct_requests"], SAMPLED_REQUESTS,
                                      replace=False).tolist())
        harness.log(f"set-up: frames and requests {time.perf_counter() - t0:.2f} s")
        self.apply_fn, self.qp_scales = None, None
        if "quant" in cfg:
            from tpu_unet_torch.infer.quant import build_quant_inference, calibration_batch

            cal = cfg["quant"]["calibration"]
            qi = build_quant_inference(model, calibration_batch(
                self.pool[:cal["frames"]], size=cal["size"], n=cal["frames"]),
                **cfg["quant"]["build"])
            self.apply_fn, self.qp_scales = qi.apply, dict(qi.qp.scales)
            harness.log(f"set-up: calibration {time.perf_counter() - t0:.2f} s")
        self.model = model
        self.engine = TileInference(model, h, w, tile_out=tr["tile_out"],
                                    batch_tiles=tr["batch_tiles"], mesh=mesh,
                                    apply_fn=self.apply_fn)
        self.plan = rt.Plan(h, w, tr["tile_out"], self.mcfg["depth"])
        self.tiles_per_request = n * self.plan.num_tiles
        self.samples: List[dict] = []
        self.latencies: List[float] = []
        self.failed = 0
        self.rank_tiles = None          # this rank's tile ids of a request on a mesh
        if mesh is not None:
            from tpu_unet_torch.parallel.mesh import axis_size

            k = axis_size(mesh, "data")
            per = self.tiles_per_request // k
            r = mesh.get_local_rank("data")
            self.rank_tiles = list(range(r * per, (r + 1) * per))

    def request(self, i: int, keep: bool = True) -> None:
        """Serve request `i` and wait for its maps and metrics on the host."""
        frames, labels = self.requests[i % len(self.requests)]
        captured: Optional[list] = None
        if keep and i in self.sampled:
            captured = []
            forward = self.engine._forward

            def capture(tile_batch):
                out = forward(tile_batch)
                captured.append(out)
                return out
            self.engine._forward = capture
        t = time.perf_counter()
        try:
            metrics, maps = self.engine.evaluate_batch(frames, labels)
            metrics, maps = metrics.cpu().numpy(), maps.cpu().numpy()
        except Exception:                  # a failed request counts, and the run goes on
            self.failed += 1
            traceback.print_exc()
            metrics = maps = None
        finally:
            if captured is not None:
                del self.engine._forward
        if keep:
            self.latencies.append(time.perf_counter() - t)
        if captured is not None and maps is not None:
            ids = self.rank_tiles or list(range(self.tiles_per_request))
            self.samples.append({"i": i, "frames": frames, "labels": labels,
                                 "maps": maps, "metrics": metrics, "tile_ids": ids,
                                 "logits": torch.cat(captured)[:len(ids)]})

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        for s in self.samples:
            s["logits"] = s["logits"].float().cpu().numpy()
        self.engine = self.model = self.apply_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """The numbers `correct` compares, over this process's samples, and
        the readings reported beside them. `control`: the control's logits
        in the program's place."""
        block = REFERENCE_BLOCK
        samples = self.samples
        if len(samples) < len(self.sampled):
            return {k: float("inf") for k in harness.limits(self.cell)}
        cfg = self.cell["config"]
        cal = cfg.get("quant", {}).get("calibration")
        want = cal and sc.calibration_scales(self.params, self.pool[:cal["frames"]], self.mcfg,
                                             self.device, size=cal["size"])
        amax = sc.calibration_amax(want) if want else (None, None)
        quant = lowp.for_config(cfg, cfg["control"], *amax)
        ref_quant = lowp.for_config(cfg, cfg["reference"], *amax)
        if control:
            samples = [sc.control_sample(s, self.params, self.mcfg, self.plan, self.device,
                                         quant, block) for s in samples]
        numbers = sc.judge(samples, self.params, self.mcfg, self.plan, self.device, quant,
                           block, ref_quant)
        if self.qp_scales is not None and not control:
            numbers["calib_rel_err"] = sc.calib_rel_err(self.qp_scales, want)
        return numbers


def spans_for(server: Server, spans: harness.Spans) -> None:
    import tpu_unet_torch.infer.quant as quant
    import tpu_unet_torch.infer.tiles as tiles
    import tpu_unet_torch.models.unet as unet

    spans.wrap(unet, "conv3x3_bias_relu", "k1")
    spans.wrap(quant, "conv3x3_fused", "k3")
    spans.wrap(tiles, "all_gather_cat", "gather")


def serve_window(server: Server, seconds: float, stop=None) -> tuple:
    """Requests back to back until `seconds` have passed (or, on a mesh,
    until `stop(i)` says so for all ranks); (requests, seconds)."""
    i, t0 = 0, time.perf_counter()
    while True:
        server.request(i)
        i += 1
        elapsed = time.perf_counter() - t0
        done = elapsed >= seconds
        if stop is not None:
            done = stop(done)
        if done:
            return i, elapsed


def traced(cell: dict, server: Server, n: int, chips: int, first: int = 0,
           profile: bool = True) -> dict:
    """Profile `n` requests from request `first` twice, on the card alone
    and then on host and card with the spans; the cell's per-layer metrics
    and the breakdown. `profile=False` (the other ranks of a mesh) serves
    the same requests unprofiled and returns nothing."""
    def requests():
        for i in range(first, first + n):
            server.request(i, keep=False)

    if not profile:
        requests()
        requests()
        return {}
    with harness.profiled(host=False) as plain:
        requests()
    spans = harness.Spans()
    spans_for(server, spans)
    try:
        with harness.profiled() as prof:
            requests()
    finally:
        spans.restore()
    counters = {"requests": n, "tiles": n * server.tiles_per_request, "chips": chips}
    trace = harness.Trace(prof["events"], (plain["events"], plain["window_s"]), counters,
                          spans.calls, {"precision": cell["config"]["precision"], "model": server.mcfg,
                                        "tile_in": server.plan.tile_in})
    return {"metrics": harness.per_layer(cell, trace), "breakdown": harness.breakdown(trace),
            "busy_s": trace.busy_s, "window_s": trace.window_s}


def end_to_end(server: Server, n: int, elapsed: float) -> Dict[str, float]:
    done = n - server.failed
    return {"tiles_per_s": done * server.tiles_per_request / elapsed,
            "request_p95_ms": float(np.percentile(server.latencies, 95)) * 1e3}


def run(cell: dict, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", control: Optional[str] = None) -> dict:
    server = Server(cell, seed, device)
    for i in range(WARMUP_REQUESTS):
        server.request(i, keep=False)
    if server.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    harness.log(f"set-up: done {setup_s:.2f} s")
    out: dict = {}
    if trace:
        out = traced(cell, server, TRACED_REQUESTS, 1, first=cell["traffic"]["distinct_requests"])
    n, elapsed = serve_window(server, seconds)
    peak = torch.cuda.max_memory_allocated() if server.device.type == "cuda" else 0
    server.free()
    t = time.perf_counter()
    numbers = server.check(control)
    harness.log(f"check: {time.perf_counter() - t:.2f} s")
    e2e = dict(end_to_end(server, n, elapsed), setup_s=setup_s)
    return {"attempted": n, "failed": server.failed, "e2e": e2e, "numbers": numbers,
            "memory_peak": peak, "trace": out}


def readings(cell: dict, seed: int, control: str, device="cuda") -> dict:
    """The program's numbers and the control's on the sampled requests of
    `seed`, without a window (control.py)."""
    server = Server(cell, seed, device)
    for i in range(max(server.sampled) + 1):
        server.request(i)
    server.free()
    return {"program": server.check(), "control": server.check(control)}
