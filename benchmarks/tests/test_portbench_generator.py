"""generator.py: the frozen frame generator is a function of its seed."""

import torch

from benchmarks import generator


def _frames(seed):
    gen = torch.Generator().manual_seed(seed)
    return generator.make_frames(3, 64, 80, 5, gen)


def test_same_seed_same_frames_other_seed_other_frames():
    (a, la), (b, lb), (c, lc) = _frames(2 ** 31 + 5), _frames(2 ** 31 + 5), _frames(7)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c)
    assert a.shape == (3, 64, 80) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) <= 255.0
    assert set(torch.unique(la).tolist()) <= set(range(6)) and int(la.max()) > 0


def test_targets_keep_cells_apart_and_crop_distribution_sums_to_one():
    img, lab = _frames(11)
    t = generator.separated_targets(lab, 5)
    assert set(torch.unique(t).tolist()) <= {0.0, 255.0}
    assert bool(((t > 0) <= (lab > 0)).all())
    logp, pairs = generator.crop_distribution(t, 20)
    assert logp.shape == (3, pairs.shape[0]) and pairs.dtype == torch.int32
    assert torch.allclose(torch.exp(logp.double()).sum(1), torch.ones(3, dtype=torch.float64))
    assert int(pairs[:, 0].max()) < 64 - 20 and int(pairs[:, 1].max()) < 80 - 20
