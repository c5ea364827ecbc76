"""Serving across cards: the serve driver's client and check in one rank
process per card, over a `torch.distributed` mesh of the data axis
(NCCL on the card), so that `TileInference(mesh=)` spreads each request's
tiles over the ranks and gathers the class ids back to every rank.

This process starts the ranks (this file, run with ``--rank``), hands them
the cell through a file, waits for each and merges what they report: rank
0's client numbers, every rank's check, the fullest card's memory. Rank 0
decides when the window ends and tells the others over a gloo group, so
every rank serves the same requests.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
MARK = "RANK_RESULT "
#: A rank not done by then is stopped and the run fails.
RANK_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell: dict, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", control: Optional[str] = None) -> dict:
    world = cell["chips"]
    start_wall = time.time() - (time.perf_counter() - t0)
    fd, spec = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump({"cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
                   "device": device, "control": control, "world": world,
                   "port": _free_port()}, f)
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), spec],
                              stdout=subprocess.PIPE, text=True, env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, RANK_TIMEOUT_S - (time.time() - start_wall)))
            if p.returncode != 0:
                raise RuntimeError(f"a rank exited with {p.returncode}")
            outs.append(json.loads([ln for ln in out.splitlines() if ln.startswith(MARK)][-1]
                                   [len(MARK):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        os.remove(spec)
    bad = sorted({m for o in outs for m in o["forbidden"]})
    if bad:
        raise RuntimeError(f"a rank loaded forbidden modules: {bad}")
    r0 = outs[0]
    numbers = {k: max(o["numbers"][k] for o in outs) for k in r0["numbers"]}
    # the mesh's rates are their own end-to-end metrics, with their own bounds
    e2e = {f"mesh_{k}": v for k, v in r0["e2e"].items()}
    e2e["setup_s"] = max(o["window_wall"] for o in outs) - start_wall
    return {"attempted": r0["attempted"], "failed": max(o["failed"] for o in outs),
            "e2e": e2e, "numbers": numbers,
            "memory_peak": max(o["memory_peak"] for o in outs), "trace": r0["trace"]}


def rank_main(rank: int, spec_path: str) -> None:
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from benchmarks import harness
    from tpu_unet_torch.parallel.distributed import initialize_multihost
    from tpu_unet_torch.parallel.mesh import make_mesh

    with open(spec_path) as f:
        spec = json.load(f)
    cell, world = spec["cell"], spec["world"]
    serve = harness.load_driver("serve")
    dev = spec["device"]
    initialize_multihost(f"localhost:{spec['port']}", world, rank, device=dev,
                         backend="nccl" if dev == "cuda" else "gloo")
    mesh = make_mesh(axes=("data",), shape=(world,), device=dev)
    host = dist.new_group(backend="gloo")
    device = torch.device(f"cuda:{rank}") if dev == "cuda" else torch.device("cpu")
    server = serve.Server(cell, spec["seed"], device, mesh=mesh)
    for i in range(serve.WARMUP_REQUESTS):
        server.request(i, keep=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dist.barrier(group=host)
    window_wall = time.time()
    out: dict = {}
    if spec["trace"]:
        out = serve.traced(cell, server, serve.TRACED_REQUESTS, world,
                           first=cell["traffic"]["distinct_requests"], profile=rank == 0)

    def agree(done: bool) -> bool:
        flag = torch.tensor([int(done)])
        dist.broadcast(flag, src=0, group=host)
        return bool(flag.item())

    n, elapsed = serve.serve_window(server, spec["seconds"], stop=agree)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    server.free()
    # every rank's argmax of its own tiles, so each rank holds its whole
    # returned maps to the logits of the rank that ran each tile
    from benchmarks.reference.serve_check import tile_ids

    mine = [tile_ids(s["tile_ids"], s["logits"]) for s in server.samples]
    every = [None] * world
    dist.all_gather_object(every, mine, group=host)
    for k, s in enumerate(server.samples):
        s["ids"] = {t: a for r in every if k < len(r) for t, a in r[k].items()}
    numbers = server.check(spec["control"])
    result = {"attempted": n, "failed": server.failed, "numbers": numbers,
              "e2e": serve.end_to_end(server, n, elapsed), "memory_peak": peak,
              "trace": out, "window_wall": window_wall,
              "forbidden": harness.forbidden_modules()}
    dist.barrier(group=host)
    dist.destroy_process_group()
    print(MARK + json.dumps(result), flush=True)


def readings(cell: dict, seed: int, control: str, device="cuda") -> dict:
    """The program's numbers and the control's, each the worst over the
    ranks, from a short window (control.py)."""
    t0 = time.perf_counter()
    prog = run(cell, seed, 3.0, False, t0, device)
    ctrl = run(cell, seed, 3.0, False, t0, device, control)
    return {"program": prog["numbers"], "control": ctrl["numbers"]}


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("spec")
    a = p.parse_args()
    rank_main(a.rank, a.spec)
