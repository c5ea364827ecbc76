"""The port's own copies of the JAX package's host modules against the
originals: the configuration dataclasses and presets (tpu_unet_torch/config.py),
the valid-conv size arithmetic and tile planner (core/geometry.py), and the
layer-name map and weight-layout transforms (convert.py)."""

import dataclasses

import numpy as np
import pytest

from tpu_unet import config as jcfg
from tpu_unet import convert as jconvert
from tpu_unet.core import geometry as jgeo
from tpu_unet_torch import config as tcfg
from tpu_unet_torch import convert as tconvert
from tpu_unet_torch.core import geometry as tgeo

CLASSES = ["ModelConfig", "AugmentConfig", "LossConfig", "OptimConfig", "TrainConfig",
           "DatasetConfig", "Config"]


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = dataclasses.asdict(f.default_factory())
        else:
            out[f.name] = None
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_and_defaults_match(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    assert [str(f.type) for f in dataclasses.fields(tc)] == \
        [str(f.type) for f in dataclasses.fields(jc)]
    assert _defaults(tc) == _defaults(jc)
    assert tc.__dataclass_params__.frozen and jc.__dataclass_params__.frozen


@pytest.mark.parametrize("kw", [{}, {"base_width": 8, "depth": 3, "width_mult": 2},
                                {"skip_variant": "parity", "compute_dtype": "bfloat16",
                                 "conv_impl": "pallas", "upconv_impl": "matmul"}])
def test_model_config_crosses_both_ways(kw):
    """asdict of either package's ModelConfig rebuilds the other's (the
    quantized-serving .npz stores its config that way), widths included."""
    j, t = jcfg.ModelConfig(**kw), tcfg.ModelConfig(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tcfg.ModelConfig(**dataclasses.asdict(j)) == t
    assert jcfg.ModelConfig(**dataclasses.asdict(t)) == j
    assert t.widths == j.widths


def test_dataset_presets_match():
    assert list(tcfg.DATASETS) == list(jcfg.DATASETS)
    for name, ds in jcfg.DATASETS.items():
        port = tcfg.DATASETS[name]
        assert dataclasses.asdict(port) == dataclasses.asdict(ds)
        assert dataclasses.asdict(port.augment()) == dataclasses.asdict(ds.augment())
        assert port.augment().input_size == ds.augment().input_size
        assert dataclasses.asdict(port.loss(w0=5.0)) == dataclasses.asdict(ds.loss(w0=5.0))
    c, jc = tcfg.Config(dataset="ISBI2012"), jcfg.Config(dataset="ISBI2012")
    assert dataclasses.asdict(c.dataset_config()) == dataclasses.asdict(jc.dataset_config())


@pytest.mark.parametrize("depth", [2, 3, 4, 5])
def test_geometry_sizes_match_at_random_sizes(depth):
    rng = np.random.RandomState(depth)
    assert tgeo.context_for_depth(depth) == jgeo.context_for_depth(depth)
    assert (tgeo.DEPTH, tgeo.CONTEXT) == (jgeo.DEPTH, jgeo.CONTEXT)
    for n in rng.randint(1, 900, 40).tolist():
        for fn in ("input_size_for_output", "output_size_for_input", "input_size_compute"):
            got, want = [], []
            for mod, out in ((tgeo, got), (jgeo, want)):
                try:
                    out.append(getattr(mod, fn)(n, depth))
                except Exception as e:           # the same sizes are refused
                    out.append(type(e))
            assert got == want, (fn, n, depth)
    for lowest in rng.randint(1, 40, 10).tolist():
        assert tgeo.valid_sizes(lowest, depth) == jgeo.valid_sizes(lowest, depth)


def test_plan_tiles_matches_at_random_sizes():
    rng = np.random.RandomState(7)
    for _ in range(60):
        h, w = rng.randint(16, 1300, 2).tolist()
        # valid output sizes are 16 l + 4 (4, 20, ..., 388, ...)
        tile, tile_w = (16 * rng.randint(1, 40, 2) + 4).tolist()
        tile_out = (tile, tile_w) if rng.rand() < 0.3 else tile
        got, want = tgeo.plan_tiles(h, w, tile_out), jgeo.plan_tiles(h, w, tile_out)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (h, w, tile_out)
        assert got.num_tiles == want.num_tiles
        assert got.tile_in_hw == want.tile_in_hw and got.tile_out_hw == want.tile_out_hw
    assert tgeo.plan_tiles(512, 512, 388) == tgeo.plan_tiles(512, 512, 388)


def test_name_map_and_layout_transforms_match():
    assert tconvert.NAME_MAP == jconvert.NAME_MAP
    rng = np.random.RandomState(3)
    k = rng.randn(3, 2, 5, 7).astype(np.float32)
    for name in ("kernel_to_conv_weight", "kernel_to_convtranspose_weight",
                 "conv_weight_to_kernel", "convtranspose_weight_to_kernel"):
        np.testing.assert_array_equal(getattr(tconvert, name)(k),
                                      getattr(jconvert, name)(k), err_msg=name)
    # the transposed conv keeps its spatial flip, and each transform inverts
    np.testing.assert_array_equal(tconvert.kernel_to_convtranspose_weight(k)[:, :, 0, 0],
                                  k[-1, -1])
    for fwd, inv in (("kernel_to_conv_weight", "conv_weight_to_kernel"),
                     ("kernel_to_convtranspose_weight", "convtranspose_weight_to_kernel")):
        np.testing.assert_array_equal(getattr(tconvert, inv)(getattr(tconvert, fwd)(k)), k)


def test_params_round_trip_through_the_state_dict():
    rng = np.random.RandomState(4)
    params = {"params": {
        "enc0_conv1": {"kernel": rng.randn(3, 3, 1, 4).astype(np.float32),
                       "bias": rng.randn(4).astype(np.float32)},
        "up0": {"kernel": rng.randn(2, 2, 8, 4).astype(np.float32),
                "bias": rng.randn(4).astype(np.float32)},
        "head": {"kernel": rng.randn(1, 1, 4, 2).astype(np.float32),
                 "bias": rng.randn(2).astype(np.float32)}}}
    back = tconvert.params_from_state_dict(tconvert.state_dict_from_jax_params(params))
    assert set(back["params"]) == set(params["params"])
    for name, leaves in params["params"].items():
        for leaf, want in leaves.items():
            np.testing.assert_array_equal(back["params"][name][leaf], want,
                                          err_msg=f"{name}.{leaf}")
