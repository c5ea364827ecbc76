"""The port's halo exchange (tpu_unet_torch/parallel/halo.py) and its
data-parallel step on a 2-D mesh against the JAX package's, on the same
numpy inputs and weights.

Two spawns of 4 gloo CPU ranks: a `spatial` mesh of 4 (halo inference and
the halo train step on a 464 x 116 image in strips of 116) and a
`data` x `spatial` mesh of 2 x 2 (the 2-D step on 4 images of 232 x 116,
and the data-parallel step with the 'parity' broadcast at data = 2). The
JAX side runs the JAX parallel functions on the conftest's virtual CPU mesh,
at tests/test_parallel.py's sizes.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_unet_torch.losses.weights import class_balance
from tpu_unet_torch.parallel import (halo_strip_inference, make_dp_halo_train_step,
                                     make_dp_train_step, make_halo_train_step, make_mesh,
                                     shard_batch)
from tests.test_torch_parallel import (CFG, assert_equal_across_ranks, assert_params_close,
                                       port_model, raised, replicated_step, spawn_ranks,
                                       step_state)

STRIP, WIDTH = 116, 116
N_D, N_S, BATCH = 2, 2, 4


def _spatial_checks(p):
    mesh = make_mesh(axes=("spatial",), device="cpu")
    model = port_model(CFG, p["state"])
    img = torch.from_numpy(p["img"])
    out = {"too_small": raised(ValueError, halo_strip_inference, model, mesh, 36, WIDTH),
           "logits": halo_strip_inference(model, mesh, STRIP, WIDTH)(
               shard_batch(img, mesh, "spatial"))}
    if dist.get_rank() == 0:
        # the single-process oracle: each strip's mirror-padded window
        with torch.no_grad():
            out["windows"] = model(torch.from_numpy(p["windows"])).reshape(-1, WIDTH, 2)
    model, opt = replicated_step(CFG, p["state"], mesh)
    step = make_halo_train_step(model, opt, mesh, STRIP, WIDTH)
    loss, metrics = step(shard_batch(torch.from_numpy(p["train_img"]), mesh, "spatial"),
                         shard_batch(torch.from_numpy(p["train_gt"]), mesh, "spatial"))
    out["halo_step"] = {"loss": loss, "metrics": metrics, **step_state(model, opt)}
    return out


def _shard_2d(x, mesh):
    """P('data', 'spatial', None): images by the data coordinate, rows by the
    spatial one."""
    return shard_batch(shard_batch(x, mesh, "data").transpose(0, 1), mesh,
                       "spatial").transpose(0, 1)


def _mesh_2d_checks(p):
    mesh = make_mesh(axes=("data", "spatial"), shape=(N_D, N_S), device="cpu")
    model, opt = replicated_step(CFG, p["state"], mesh)
    step = make_dp_halo_train_step(model, opt, mesh, STRIP, WIDTH)
    loss, metrics = step(_shard_2d(torch.from_numpy(p["imgs"]), mesh),
                         _shard_2d(torch.from_numpy(p["gts"]), mesh))
    out = {"dp_halo_step": {"loss": loss, "metrics": metrics, **step_state(model, opt)}}
    # the data-parallel step over the mesh's data axis (2), replicated over
    # its spatial axis: the 'parity' broadcast couples the two samples
    model, opt = replicated_step(CFG, p["state"], mesh)
    step = make_dp_train_step(model, class_balance, "parity", opt, mesh)
    loss, metrics = step(shard_batch(torch.from_numpy(p["inp"]), mesh),
                         shard_batch(torch.from_numpy(p["gt"]), mesh))
    out["dp_parity"] = {"loss": loss, "metrics": metrics, **step_state(model, opt)}
    return out


@pytest.fixture(scope="module")
def inputs():
    from tests.test_torch_model import numpy_params, jax_config
    from tpu_unet.models import UNet as JaxUNet
    from tpu_unet_torch.convert import state_dict_from_jax_params

    params = numpy_params(JaxUNet(jax_config(CFG)), 188, seed=0)
    img = np.random.RandomState(3).rand(4 * STRIP, WIDTH).astype(np.float32)
    padded = np.pad(img, 92, mode="reflect")
    rng = np.random.RandomState(5)
    train_img = rng.rand(4 * STRIP, WIDTH).astype(np.float32)
    train_gt = (rng.rand(4 * STRIP, WIDTH) < 0.3).astype(np.int32)
    rng = np.random.RandomState(7)
    imgs = rng.rand(BATCH, N_S * STRIP, WIDTH).astype(np.float32)
    gts = (rng.rand(BATCH, N_S * STRIP, WIDTH) < 0.3).astype(np.int32)
    rng = np.random.RandomState(2)
    p = {"state": state_dict_from_jax_params(params), "img": img,
         "windows": np.stack([padded[i * STRIP:i * STRIP + STRIP + 184]
                              for i in range(4)])[..., None],
         "train_img": train_img, "train_gt": train_gt, "imgs": imgs, "gts": gts,
         "inp": rng.rand(2, 188, 188, 1).astype(np.float32),
         "gt": (rng.rand(2, 4, 4) < 0.5).astype(np.int32)}
    return params, p


@pytest.fixture(scope="module")
def spatial_ranks(inputs, tmp_path_factory):
    return spawn_ranks(_spatial_checks, inputs[1], tmp_path_factory.mktemp("spatial_mesh"))


@pytest.fixture(scope="module")
def mesh_2d_ranks(inputs, tmp_path_factory):
    return spawn_ranks(_mesh_2d_checks, inputs[1], tmp_path_factory.mktemp("mesh_2d"))


@pytest.fixture(scope="module")
def jax_ref(inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tests.test_torch_model import jax_config
    from tpu_unet.config import OptimConfig as JaxOptimConfig
    from tpu_unet.losses.weights import class_balance as jax_class_balance
    from tpu_unet.models import UNet as JaxUNet
    from tpu_unet.parallel import (halo_strip_inference as jax_halo_inference,
                                   make_dp_halo_train_step as jax_dp_halo_step,
                                   make_dp_train_step as jax_dp_step,
                                   make_halo_train_step as jax_halo_step,
                                   make_mesh as jax_mesh, replicate as jax_replicate,
                                   shard_batch as jax_shard)
    from tpu_unet.train.optimizer import make_optimizer as jax_optimizer
    from tpu_unet.train.trainer import TrainState

    params, p = inputs
    jmodel = JaxUNet(jax_config(CFG))
    tx = jax_optimizer(JaxOptimConfig())

    def result(state, loss, metrics):
        return {"loss": float(loss), "metrics": np.asarray(metrics),
                "params": jax.tree.map(np.asarray, state.params)}

    def state0(mesh):
        return jax_replicate(TrainState(params, tx.init(params)), mesh)

    ref = {}
    mesh = jax_mesh(4, axes=("spatial",))
    fwd = jax_halo_inference(jmodel, mesh, STRIP, WIDTH)
    ref["logits"] = np.asarray(fwd(jax_replicate(params, mesh),
                                   jax_shard(jnp.asarray(p["img"]), mesh, axis="spatial")))
    step = jax_halo_step(jmodel, tx, mesh, STRIP, WIDTH)
    state, loss, metrics = step(state0(mesh),
                                jax_shard(jnp.asarray(p["train_img"]), mesh, axis="spatial"),
                                jax_shard(jnp.asarray(p["train_gt"]), mesh, axis="spatial"))
    ref["halo_step"] = result(state, loss, metrics)

    mesh = jax_mesh(N_D * N_S, axes=("data", "spatial"), shape=(N_D, N_S))
    sh = NamedSharding(mesh, P("data", "spatial", None))
    step = jax_dp_halo_step(jmodel, tx, mesh, STRIP, WIDTH)
    ref["dp_halo_step"] = result(*step(state0(mesh), jax.device_put(jnp.asarray(p["imgs"]), sh),
                                       jax.device_put(jnp.asarray(p["gts"]), sh)))
    mesh = jax_mesh(N_D)
    step = jax_dp_step(jmodel, jax_class_balance, "parity", tx, mesh)
    ref["dp_parity"] = result(*step(state0(mesh), jax_shard(jnp.asarray(p["inp"]), mesh),
                                    jax_shard(jnp.asarray(p["gt"]), mesh)))
    return ref


def test_halo_inference_matches_jax(spatial_ranks, jax_ref):
    """halo_strip_inference over 4 ranks: JAX's logits at the cross-framework
    bar, and the single-process forward of each strip's mirror-padded window
    bit for bit, the whole image on every rank."""
    for r in spatial_ranks:
        assert tuple(r["logits"].shape) == (4 * STRIP, WIDTH, 2)
        np.testing.assert_allclose(r["logits"].numpy(), jax_ref["logits"], rtol=1e-4, atol=1e-5)
        assert torch.equal(r["logits"], spatial_ranks[0]["windows"])


def test_halo_strip_too_small_raises(spatial_ranks):
    # 36 + 184 = 220 is a valid input size, but 36 < the 92-row halo
    for r in spatial_ranks:
        assert "strip height 36 <= halo 92" in r["too_small"]


@pytest.mark.parametrize("name,layout", [("halo_step", "spatial"),
                                         ("dp_halo_step", "2d"), ("dp_parity", "2d")])
def test_step_matches_jax(spatial_ranks, mesh_2d_ranks, jax_ref, name, layout):
    """The halo step (one image's rows over 4 ranks), the 2-D step (2 x 2)
    and the data-parallel 'parity' step (data 2): loss, IoU and pixel error
    (or the per-sample metrics) and the updated parameters equal JAX's."""
    got = (spatial_ranks if layout == "spatial" else mesh_2d_ranks)[0][name]
    ref = jax_ref[name]
    np.testing.assert_allclose(float(got["loss"]), ref["loss"], rtol=1e-5)
    metrics = (torch.stack(got["metrics"]) if isinstance(got["metrics"], tuple)
               else got["metrics"])
    np.testing.assert_allclose(metrics.numpy(), ref["metrics"], rtol=1e-5)
    assert_params_close(got["params"], ref["params"])


@pytest.mark.parametrize("name,layout", [("halo_step", "spatial"),
                                         ("dp_halo_step", "2d"), ("dp_parity", "2d")])
def test_step_state_is_bit_equal_across_ranks(spatial_ranks, mesh_2d_ranks, name, layout):
    ranks = spatial_ranks if layout == "spatial" else mesh_2d_ranks
    assert_equal_across_ranks([r[name] for r in ranks])
