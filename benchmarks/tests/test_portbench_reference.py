"""The references hold to the program's CPU paths at small sizes: the
f32 U-Net, the tile plan, the augmentation and the weight maps. (The
references import nothing of the program; these tests import both.)"""

import numpy as np
import pytest
import torch

from benchmarks import generator
from benchmarks.reference import augment as ra
from benchmarks.reference import tiles as rt
from benchmarks.reference import unet as ru
from benchmarks.reference.weightmap import weight_map

SMALL = {"in_channels": 1, "num_classes": 2, "base_width": 8, "width_mult": 1, "depth": 4,
         "compute_dtype": "float32", "conv_impl": "xla"}


def _program_model(params):
    from tpu_unet_torch.config import ModelConfig
    from tpu_unet_torch.models.unet import UNet

    model = UNet(ModelConfig(**SMALL))
    model.load_state_dict(params)
    return model


def test_reference_forward_matches_the_program_at_base_width_8():
    params = ru.make_params(SMALL, 2 ** 31 + 3, "cpu")
    x = torch.rand(2, 204, 204, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = _program_model(params)(x)
    got = ru.forward(params, x, SMALL)
    assert got.shape == want.shape == (2, 20, 20, 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_weights_are_a_function_of_the_seed():
    a, b = ru.make_params(SMALL, 5, "cpu"), ru.make_params(SMALL, 5, "cpu")
    c = ru.make_params(SMALL, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc0_conv1.weight"], c["enc0_conv1.weight"])
    assert float(a["head.bias"].abs().max()) > 0.0


@pytest.mark.parametrize("hw,tile_out", [((512, 512), 388), ((40, 52), 20), ((520, 696), 388)])
def test_tile_plan_matches_the_program(hw, tile_out):
    from tpu_unet_torch.core.geometry import plan_tiles

    want = plan_tiles(*hw, tile_out)
    got = rt.Plan(*hw, tile_out, 4)
    assert list(got.origins) == list(want.out_origins)
    assert got.tile_in == want.tile_in and got.pad == want.pad
    assert got.canvas == (want.canvas_h, want.canvas_w)


def test_reference_tiles_match_the_program_tiles():
    from tpu_unet_torch.infer.tiles import TileInference

    params = ru.make_params(SMALL, 9, "cpu")
    frames = np.random.default_rng(0).random((2, 40, 40)).astype(np.float32) * 200
    eng = TileInference(_program_model(params), 40, 40, tile_out=20, batch_tiles=18)
    want = eng._flat_tiles(torch.from_numpy(frames)).numpy()
    got = rt.Plan(40, 40, 20, 4).tiles(frames)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_crop_input_is_the_programs_augment_input():
    from tpu_unet_torch.config import AugmentConfig

    for crop in (20, 196, 388):
        assert rt.crop_input(crop, 4) == AugmentConfig(crop=crop).input_size


def test_reference_augmentation_matches_the_program():
    from tpu_unet_torch.config import AugmentConfig
    from tpu_unet_torch.data.augment import AugmentPipeline

    gen = torch.Generator().manual_seed(4)
    images, inst = generator.make_frames(3, 64, 64, 3, gen)
    targets = generator.separated_targets(inst, 3)
    logp, pairs = generator.crop_distribution(targets, 20)
    aug = AugmentConfig(crop=20)
    size = aug.input_size
    inp, gt = AugmentPipeline(aug)(images, targets, logp, pairs, [2, 0],
                                   torch.Generator().manual_seed(ra.batch_seed(7, 1, 0)))
    g = torch.Generator().manual_seed(ra.batch_seed(7, 1, 0))
    for k, i in enumerate([2, 0]):
        d = ra.draw(g, logp[i], size, aug.rotate_step_deg, aug.crop_grid_skip)
        a, lab = ra.augment_one(images[i].numpy(), targets[i].numpy(), pairs.numpy(), d, 20,
                                size, aug.elastic_alpha, aug.elastic_sigma)
        np.testing.assert_allclose(a, inp[k, ..., 0].numpy(), atol=1e-4)
        assert (lab != gt[k].numpy()).sum() <= 2


def test_reference_weight_map_matches_the_program():
    from tpu_unet_torch.losses.weights import weighted_map

    _, inst = generator.make_frames(2, 48, 48, 6, torch.Generator().manual_seed(3))
    labels = (generator.separated_targets(inst, 6) > 0).int()
    want = weighted_map(labels, 20.0, 25.0, 32).numpy()
    for k in range(2):
        got = weight_map(labels[k].numpy(), 20.0, 25.0, 32)
        np.testing.assert_allclose(got, want[k], rtol=1e-5, atol=1e-5)
