"""The port's data-parallel layer (tpu_unet_torch/parallel/mesh.py,
distributed.py, and TileInference(mesh=)) against the JAX package's on the
same numpy inputs and weights.

The port side runs in one spawn of 4 gloo CPU ranks (a `data` mesh of 4),
which computes every check and saves each rank's results; the JAX side runs
the JAX parallel functions on the conftest's 8-device virtual CPU mesh, at
tests/test_parallel.py's sizes (base width 2, 188^2 inputs, 72^2 images
with tile_out 36). The ranks never import JAX: it is imported only inside
the reference fixtures.

`spawn_ranks` is shared with tests/test_torch_halo.py.
"""

import dataclasses
import datetime
import importlib
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpu_unet_torch.config import ModelConfig, OptimConfig
from tpu_unet_torch.convert import params_from_state_dict
from tpu_unet_torch.infer import TileInference
from tpu_unet_torch.infer.quant import QuantInference, build_quant_inference
from tpu_unet_torch.losses.weights import class_balance
from tpu_unet_torch.models import UNet
from tpu_unet_torch.parallel import (initialize_multihost, make_dp_tile_forward,
                                     make_dp_train_step, make_mesh, replicate, shard_batch)
from tpu_unet_torch.parallel import distributed
from tpu_unet_torch.train.optimizer import make_optimizer

WORLD = 4
CFG = ModelConfig(base_width=2)
RANK_TIMEOUT = datetime.timedelta(seconds=120)


# ---------------------------------------------------------------- the ranks

def _rank_main(rank, world, out_dir, module, fn_name):
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    joined = initialize_multihost(f"file://{os.path.join(out_dir, 'rendezvous')}",
                                  backend="gloo", device="cpu", timeout=RANK_TIMEOUT)
    payload = torch.load(os.path.join(out_dir, "payload.pt"), weights_only=False)
    results = getattr(importlib.import_module(module), fn_name)(payload)
    results["joined"] = (joined, initialize_multihost(backend="gloo", device="cpu"),
                         dist.get_rank(), dist.get_world_size())
    results["jax_loaded"] = sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "tpu_unet"))
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(fn, payload, out_dir, world=WORLD):
    """Run fn(payload) in `world` gloo CPU ranks joined through
    `initialize_multihost` (a file:// rendezvous in `out_dir`, the rank and
    world size from torchrun's variables); each rank's results, in rank
    order. The payload goes through a file: as a spawn argument it would
    be piped to one rank after another, each start waiting for the last."""
    out_dir = str(out_dir)
    torch.save(payload, os.path.join(out_dir, "payload.pt"))
    mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                       args=(world, out_dir, fn.__module__, fn.__name__))
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def port_model(cfg, state):
    model = UNet(cfg)
    model.load_state_dict(state)
    return model


def raised(exc, fn, *args, **kwargs):
    try:
        fn(*args, **kwargs)
    except exc as e:
        return str(e)
    return None


def replicated_step(cfg, state, mesh):
    """A model and optimizer equal on every rank after `replicate`: ranks
    other than 0 start from perturbed weights, which replicate overwrites."""
    model = port_model(cfg, state)
    if dist.get_rank():
        with torch.no_grad():
            for p in model.parameters():
                p.add_(float(dist.get_rank()))
    replicate(model, mesh)
    return model, make_optimizer(model.parameters(), OptimConfig())


def step_state(model, opt):
    return {"params": {k: v.clone() for k, v in model.state_dict().items()},
            "momentum": [opt.state[p]["momentum_buffer"].clone()
                         for p in model.parameters()]}


def _data_checks(p):
    rank = dist.get_rank()
    mesh = make_mesh(axes=("data",), device="cpu")
    out = {"bad_num_devices": raised(ValueError, make_mesh, WORLD // 2, device="cpu")}
    inp, gt = torch.from_numpy(p["inp"]), torch.from_numpy(p["gt"])
    for name, cfg in (("dp", CFG), ("dp_phase", p["phase_cfg"])):
        model, opt = replicated_step(cfg, p["state"], mesh)
        step = make_dp_train_step(model, class_balance, "intended", opt, mesh)
        loss, metrics = step(shard_batch(inp, mesh), shard_batch(gt, mesh))
        out[name] = {"loss": loss, "metrics": metrics, **step_state(model, opt)}

    model = port_model(CFG, p["state"])
    tiles = torch.from_numpy(p["tiles"])
    out["tile_forward"] = make_dp_tile_forward(model, mesh)(shard_batch(tiles, mesh))
    img, imgs, labels = (torch.from_numpy(p[k]) for k in ("img", "imgs", "labels"))
    engines = {"float": None}
    for tier, qp, phase in (("int8", p["qp8"], None), ("int8-phase", p["qp8"], "int8"),
                            ("int4-phase", p["qp4"], "int8")):
        engines[tier] = QuantInference(qp, device="cpu", phase_level0=phase).apply
    for tier, apply_fn in engines.items():
        runs = {}
        for where, m in (("meshed", mesh), ("single", None)):
            if where == "single" and rank:
                continue
            eng = TileInference(model, 72, 72, tile_out=36, batch_tiles=4, mesh=m,
                                apply_fn=apply_fn)
            whole = TileInference(model, 72, 72, mesh=m, apply_fn=apply_fn)
            runs[where] = {"logits": eng.predict_logits(img), "ids": eng.predict(img),
                           "eval": eng.evaluate_batch(imgs, labels),
                           "eval_small": whole.evaluate_batch(imgs[:1], labels[:1]),
                           "batch_tiles": eng.batch_tiles}
        out[tier] = runs
    return out


# ------------------------------------------------------------- the fixtures

@pytest.fixture(scope="module")
def inputs():
    """Weights drawn by numpy_params and the inputs of tests/test_parallel.py's
    cases, plus the quantized serving parameters the ranks serve."""
    from tests.test_torch_model import numpy_params, jax_config
    from tpu_unet.models import UNet as JaxUNet
    from tpu_unet_torch.convert import state_dict_from_jax_params

    params = numpy_params(JaxUNet(jax_config(CFG)), 188, seed=0)
    rng = np.random.RandomState(0)
    p = {
        "state": state_dict_from_jax_params(params),
        "phase_cfg": dataclasses.replace(CFG, phase_level0=True),
        "inp": rng.rand(4, 188, 188, 1).astype(np.float32),
        "gt": (rng.rand(4, 4, 4) < 0.5).astype(np.int32),
        "tiles": np.random.RandomState(1).rand(8, 188, 188, 1).astype(np.float32),
        "img": np.random.RandomState(11).rand(72, 72).astype(np.float32),
    }
    rng = np.random.RandomState(12)
    p["imgs"] = rng.rand(2, 72, 72).astype(np.float32)
    p["labels"] = (rng.rand(2, 72, 72) > 0.5).astype(np.uint8)
    model = port_model(CFG, p["state"])
    calib = torch.from_numpy(np.pad(p["img"][None, :64, :64], ((0, 0), (62, 62), (62, 62)),
                                    mode="reflect")[..., None])
    p["qp8"] = build_quant_inference(model, calib, min_channels=4).qp
    p["qp4"] = build_quant_inference(model, calib, min_channels=4, int4=True).qp
    assert p["qp8"].qnames and p["qp4"].q4names
    return params, p


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return spawn_ranks(_data_checks, inputs[1], tmp_path_factory.mktemp("data_mesh"))


@pytest.fixture(scope="module")
def jax_ref(inputs):
    """The JAX parallel functions on the virtual mesh, same weights and inputs."""
    import jax
    import jax.numpy as jnp

    from tests.test_torch_model import jax_config
    from tpu_unet.config import OptimConfig as JaxOptimConfig
    from tpu_unet.infer import TileInference as JaxTileInference
    from tpu_unet.losses.weights import class_balance as jax_class_balance
    from tpu_unet.models import UNet as JaxUNet
    from tpu_unet.parallel import (make_dp_tile_forward as jax_tile_forward,
                                   make_dp_train_step as jax_dp_step,
                                   make_mesh as jax_mesh, replicate as jax_replicate,
                                   shard_batch as jax_shard)
    from tpu_unet.train.optimizer import make_optimizer as jax_optimizer
    from tpu_unet.train.trainer import TrainState

    params, p = inputs
    mesh = jax_mesh(WORLD)
    tx = jax_optimizer(JaxOptimConfig())
    ref = {}
    for name, cfg in (("dp", CFG), ("dp_phase", p["phase_cfg"])):
        jmodel = JaxUNet(jax_config(cfg))
        step = jax_dp_step(jmodel, jax_class_balance, "intended", tx, mesh)
        state, loss, metrics = step(jax_replicate(TrainState(params, tx.init(params)), mesh),
                                    jax_shard(jnp.asarray(p["inp"]), mesh),
                                    jax_shard(jnp.asarray(p["gt"]), mesh))
        ref[name] = {"loss": float(loss), "metrics": np.asarray(metrics),
                     "params": jax.tree.map(np.asarray, state.params)}
    jmodel = JaxUNet(jax_config(CFG))
    rparams = jax_replicate(params, mesh)
    ref["tile_forward"] = np.asarray(jax_tile_forward(jmodel, mesh)(
        rparams, jax_shard(jnp.asarray(p["tiles"]), mesh)))
    eng = JaxTileInference(jmodel, 72, 72, tile_out=36, batch_tiles=4, mesh=mesh)
    whole = JaxTileInference(jmodel, 72, 72, mesh=mesh)
    ref["logits"] = np.asarray(eng.predict_logits(rparams, p["img"]))
    ref["eval"] = [np.asarray(a) for a in eng.evaluate_batch(rparams, p["imgs"], p["labels"])]
    ref["eval_small"] = [np.asarray(a) for a in whole.evaluate_batch(
        rparams, p["imgs"][:1], p["labels"][:1])]
    ref["batch_tiles"] = eng.batch_tiles
    return ref


def assert_params_close(state, jax_params):
    got = params_from_state_dict(state)["params"]
    want = jax_params["params"]
    assert got.keys() == want.keys()
    for name in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_allclose(got[name][leaf], want[name][leaf], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name}.{leaf}")


def assert_equal_across_ranks(values):
    first = values[0]
    for other in values[1:]:
        if isinstance(first, dict):
            assert first.keys() == other.keys()
            for k in first:
                assert_equal_across_ranks([first[k], other[k]])
        elif isinstance(first, (list, tuple)):
            assert len(first) == len(other)
            for a, b in zip(first, other):
                assert_equal_across_ranks([a, b])
        elif torch.is_tensor(first):
            assert torch.equal(first, other), "ranks differ"
        else:
            assert first == other


# ---------------------------------------------------------------- the tests

@pytest.mark.parametrize("name", ["dp", "dp_phase"])
def test_dp_train_step_matches_jax(ranks, jax_ref, name):
    """make_dp_train_step over 4 ranks = JAX's over a 4-device mesh: the
    global-batch loss, the per-sample metrics in global order, the updated
    parameters (plain model and the phase-packed level 0)."""
    got, ref = ranks[0][name], jax_ref[name]
    np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=1e-5)
    assert tuple(got["metrics"].shape) == (4, 2)
    np.testing.assert_allclose(got["metrics"].numpy(), ref["metrics"], rtol=1e-5)
    assert_params_close(got["params"], ref["params"])


@pytest.mark.parametrize("name", ["dp", "dp_phase"])
def test_dp_replicated_state_is_bit_equal_across_ranks(ranks, name):
    """Ranks 1-3 start from other weights; after replicate and one step every
    rank holds rank 0's parameters and momentum bit for bit, and the same
    loss and metrics."""
    assert_equal_across_ranks([r[name] for r in ranks])


def test_dp_tile_forward_matches_jax(ranks, jax_ref):
    for r in ranks:
        assert tuple(r["tile_forward"].shape) == (8, 4, 4)
        np.testing.assert_array_equal(r["tile_forward"].numpy(), jax_ref["tile_forward"])


def test_meshed_predict_logits_matches_jax(ranks, jax_ref):
    """Each chunk of 4 tiles spread over the 4 ranks: JAX's meshed logits at
    the cross-framework bar (test_torch_infer's), the port's single-process
    engine's bit for bit, on every rank."""
    single = ranks[0]["float"]["single"]
    assert ranks[0]["float"]["meshed"]["batch_tiles"] == jax_ref["batch_tiles"] == 4
    for r in ranks:
        got = r["float"]["meshed"]
        np.testing.assert_allclose(got["logits"].numpy(), jax_ref["logits"], rtol=1e-4,
                                   atol=1e-5)
        assert torch.equal(got["logits"], single["logits"])
        assert torch.equal(got["ids"], single["ids"])


@pytest.mark.parametrize("key", ["eval", "eval_small"])
def test_meshed_evaluate_batch_matches_jax(ranks, jax_ref, key):
    """evaluate_batch over the mesh: 2 images of 4 tiles, and one whole-image
    tile, fewer tiles than ranks (the chunk is filled up by cycling)."""
    want_metrics, want_preds = jax_ref[key]
    single = ranks[0]["float"]["single"][key]
    for r in ranks:
        metrics, preds = r["float"]["meshed"][key]
        np.testing.assert_array_equal(preds.numpy(), want_preds)
        np.testing.assert_allclose(metrics.numpy(), want_metrics, rtol=1e-6, atol=1e-7)
        assert torch.equal(preds, single[1]) and torch.equal(metrics, single[0])


@pytest.mark.parametrize("tier", ["int8", "int8-phase", "int4-phase"])
def test_meshed_quant_serving_equals_single_process(ranks, tier):
    """Quantized engines as TileInference's apply_fn over the mesh: logits,
    class maps and metrics equal the port's single-process engine (itself
    held to JAX's eager run) bit for bit, on every rank."""
    single = ranks[0][tier]["single"]
    assert_equal_across_ranks([r[tier]["meshed"] for r in ranks] + [single])


def test_ranks_join_from_torchrun_env(ranks):
    """Each rank joined with its RANK and WORLD_SIZE read from the
    environment; a second call finds the group up; the mesh refuses a
    num_devices other than the world size; no rank loaded JAX or the JAX
    package."""
    for i, r in enumerate(ranks):
        assert r["joined"] == (True, True, i, WORLD)
        assert r["jax_loaded"] == []
        assert "whole world of 4" in r["bad_num_devices"]


def test_initialize_multihost_reads_torchrun_env(monkeypatch):
    calls = []
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    for name, value in (("MASTER_ADDR", "10.0.0.7"), ("MASTER_PORT", "29411"),
                        ("WORLD_SIZE", "8"), ("RANK", "5"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(name, value)
    assert initialize_multihost(device="cpu") is True
    backend, kw = calls[-1]
    assert backend == "gloo"
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://10.0.0.7:29411", 8, 5)
    assert initialize_multihost("h:1", 2, 0, backend="nccl", device="cpu") is True
    assert calls[-1][0] == "nccl" and calls[-1][1]["init_method"] == "tcp://h:1"
    # no card here: the default device names the CPU way out
    with pytest.raises(RuntimeError, match='device="cpu"'):
        initialize_multihost()


def test_initialize_multihost_single_process(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_multihost() is False
    assert not dist.is_initialized()


def test_make_mesh_needs_a_card_or_cpu():
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_mesh()
    with pytest.raises(ValueError, match="device must be"):
        make_mesh(device="tpu")
