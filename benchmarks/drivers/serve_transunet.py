"""TransUNet serving cells: the serve driver's closed-loop client, its
`Server.request`, `serve_window` and `end_to_end` (imported, not copied),
in front of `TileInference.evaluate_batch` over
`models.transunet.TransUNet`, which serves each slice whole as one tile.

Set-up makes the weights (reference/transunet.py's draw, BatchNorm
statistics included) and a pool of frames from the seed, labels of the
configuration's classes made from the frames' instance ids, builds the
engine, and serves a few requests to warm every shape. The window then
serves for `--seconds`. A few requests drawn from the seed hand their slice
logits to the check, which runs after the window on the f32 reference
(reference/transunet_check.py), and their input slices, whose encoded
tokens the model computes (`TransUNet.encode`) once the window is over.

The `--trace 1` run profiles its requests twice: on the card alone as the
window serves them (a replayed CUDA graph a chunk), then on host and card
with the model's `cuda_graphs` cleared, so that its eager forward opens the
spans the per-layer readers attribute by. That second pass wraps
`models.transunet.conv3x3_bias_relu` as 'k1' and
`models.transunet.attention` as 'attn', and records their launches among
the counters.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from benchmarks import generator, harness
from benchmarks.reference import lowp
from benchmarks.reference import transunet as rtu
from benchmarks.reference import transunet_check as tc

serve = harness.load_driver("serve")


class Server(serve.Server):
    """The program under test, a `TransUNet` built from the seed behind a
    whole-frame `TileInference`, and the client's inputs."""

    def __init__(self, cell: dict, seed: int, device):
        from tpu_unet_torch.config import TransUNetConfig
        from tpu_unet_torch.infer.tiles import TileInference
        from tpu_unet_torch.models.transunet import TransUNet

        cfg, tr = cell["config"], cell["traffic"]
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.mcfg = cfg["model"]
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from tpu_unet_torch.ops import _build
            _build.load_library()
        harness.log(f"set-up: kernel library {time.perf_counter() - t0:.2f} s")
        self.params = rtu.make_params(self.mcfg, harness.sub_seed(seed, "weights"), self.device)
        mcfg = {k: tuple(v) if isinstance(v, list) else v for k, v in self.mcfg.items()}
        with torch.device(self.device):
            model = TransUNet(TransUNetConfig(**mcfg),
                              generator=torch.Generator(device=self.device).manual_seed(0))
        model.load_state_dict(self.params)
        harness.log(f"set-up: weights and model {time.perf_counter() - t0:.2f} s")
        h, w = tr["frame_hw"]
        gen = torch.Generator(device=self.device).manual_seed(harness.sub_seed(seed, "frames"))
        images, inst = generator.make_frames(tr["pool_frames"], h, w, tr["cells_per_frame"], gen)
        labels = rtu.class_labels(inst, self.mcfg["num_classes"])
        self.pool = images.cpu().numpy()
        pool_labels = labels.to(torch.uint8).cpu().numpy()
        del images, inst, labels
        n = tr["frames_per_request"]
        if n > tr["pool_frames"]:
            raise ValueError(f"{n} distinct frames a request from a pool of {tr['pool_frames']}")
        rng = np.random.default_rng(harness.sub_seed(seed, "requests"))
        table = np.argsort(rng.random((tr["distinct_requests"], tr["pool_frames"])), 1)[:, :n]
        self.requests = [(self.pool[idx], pool_labels[idx]) for idx in table]
        self.sampled = set(rng.choice(tr["distinct_requests"], serve.SAMPLED_REQUESTS,
                                      replace=False).tolist())
        harness.log(f"set-up: frames and requests {time.perf_counter() - t0:.2f} s")
        self.model, self.apply_fn = model, None
        self.engine = TileInference(model, h, w, tile_out=tr["tile_out"],
                                    batch_tiles=tr["batch_tiles"])
        self.tiles_per_request = n * self.engine.plan.num_tiles
        self.samples, self.latencies, self.failed, self.rank_tiles = [], [], 0, None

    def request(self, i: int, keep: bool = True) -> None:
        """`serve.Server.request`, which keeps a sampled request's logits;
        this keeps its input slices too, as the engine hands them to the
        model."""
        if not (keep and i in self.sampled):
            return super().request(i, keep)
        batches, forward, n = [], self.engine._forward, len(self.samples)

        def capture(tile_batch):
            batches.append(tile_batch.clone())
            return forward(tile_batch)
        self.engine._forward = capture      # wrapped again there, both dropped after
        super().request(i, keep)
        if len(self.samples) > n:
            self.samples[-1]["batch"] = torch.cat(batches)[:self.tiles_per_request]

    def free(self) -> None:
        """The sampled slices' encoded tokens, then `serve.Server.free`."""
        for s in self.samples:
            s["tokens"] = self.model.encode(s.pop("batch")).float().cpu().numpy()
        super().free()

    def check(self, control: Optional[str] = None) -> Dict[str, float]:
        """The numbers `correct` compares, over this process's samples, and
        the readings reported beside them. `control`: the control's logits
        in the program's place."""
        if len(self.samples) < len(self.sampled):
            return {k: float("inf") for k in harness.limits(self.cell)}
        cfg, block = self.cell["config"], serve.REFERENCE_BLOCK
        quant = lowp.for_config(cfg, cfg["control"])
        samples = self.samples
        if control:
            samples = [tc.control_sample(s, self.params, self.mcfg, self.device, quant, block)
                       for s in samples]
        return tc.judge(samples, self.params, self.mcfg, self.device, quant, block)


def traced(cell: dict, server: Server, n: int, first: int = 0) -> dict:
    """Profile `n` requests from request `first` twice, on the card alone
    and then on host and card with the spans; the cell's per-layer metrics
    and the breakdown."""
    import tpu_unet_torch.models.transunet as tu
    from tpu_unet_torch.ops.conv_pallas import conv3x3_bias_relu

    def requests():
        for i in range(first, first + n):
            server.request(i, keep=False)

    with harness.profiled(host=False) as plain:
        requests()
    attn_fn = tu.attention
    launched = (attn_fn.launches, conv3x3_bias_relu.launches)
    spans = harness.Spans()
    spans.wrap(tu, "conv3x3_bias_relu", "k1")
    spans.wrap(tu, "attention", "attn")
    server.model.cuda_graphs = False
    try:
        with harness.profiled() as prof:
            requests()
    finally:
        server.model.cuda_graphs = True
        spans.restore()
    counters = {"requests": n, "tiles": n * server.tiles_per_request, "chips": 1,
                "attn_launches": attn_fn.launches - launched[0],
                "k1_launches": conv3x3_bias_relu.launches - launched[1]}
    trace = harness.Trace(prof["events"], (plain["events"], plain["window_s"]), counters,
                          spans.calls, {"precision": cell["config"]["precision"],
                                        "model": server.mcfg,
                                        "tile_in": server.engine.plan.tile_in_hw[0]})
    return {"metrics": harness.per_layer(cell, trace), "breakdown": harness.breakdown(trace),
            "busy_s": trace.busy_s, "window_s": trace.window_s}


def run(cell: dict, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", control: Optional[str] = None) -> dict:
    server = Server(cell, seed, device)
    for i in range(serve.WARMUP_REQUESTS):
        server.request(i, keep=False)
    if server.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    harness.log(f"set-up: done {setup_s:.2f} s")
    out: dict = {}
    if trace:
        out = traced(cell, server, serve.TRACED_REQUESTS,
                     first=cell["traffic"]["distinct_requests"])
    n, elapsed = serve.serve_window(server, seconds)
    peak = torch.cuda.max_memory_allocated() if server.device.type == "cuda" else 0
    server.free()
    t = time.perf_counter()
    numbers = server.check(control)
    harness.log(f"check: {time.perf_counter() - t:.2f} s")
    e2e = dict(serve.end_to_end(server, n, elapsed), setup_s=setup_s)
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
