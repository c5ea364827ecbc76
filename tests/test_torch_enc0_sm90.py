"""K4's sm90 route on the CPU: the walk it takes (`enc0_plan`, `enc0_tile`,
the arithmetic csrc/enc0_chain.cu checks and decodes), its routes
(`enc0_chain_route`, `_enc0_chain_route_forward`), and `enc0_chain` against
the JAX package's Pallas kernel in interpret mode at the strip's edge widths
(Wo 2, 88, 90 and 178 around the 88-column tile; Ho 2 and 6; C 8, 24 and
64). On the CPU every route runs the plain version; the CUDA kernels are
held to it on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from tests.test_torch_fused_level0 import _assert_last_bit, _enc0_inputs, _run_both, _skip_scale
from tpu_unet_torch.ops import fused_level0 as tfl


def _walk(bsz, h, w):
    """Every tile of the plan, decoded as the kernel decodes it."""
    plan = tfl.enc0_plan(bsz, h, w)
    return plan, [tfl.enc0_tile(plan, t) for t in range(plan.tiles)]


@pytest.mark.parametrize("seed", range(8))
def test_enc0_plan_covers_every_output_once(seed):
    """Seeded random (B, H, W) with H - 4 and W - 4 even: the tiles cover
    every skip pixel and every pooled pixel exactly once, no pool window
    straddles two tiles, and there are B * Ho/2 * ceil(Wo/88) of them."""
    rng = np.random.RandomState(seed)
    bsz = int(rng.randint(1, 4))
    ho, wo = 2 * int(rng.randint(1, 40)), 2 * int(rng.randint(1, 160))
    plan, tiles = _walk(bsz, ho + 4, wo + 4)
    th, tw = tfl.ENC0_TILE
    assert plan.tiles == len(tiles) == bsz * (ho // 2) * -(-wo // tw)
    skip = np.zeros((bsz, ho, wo), np.int64)
    pooled = np.zeros((bsz, ho // 2, wo // 2), np.int64)
    for b, oy, ox0 in tiles:
        assert 0 <= b < bsz and oy % 2 == 0 and ox0 % 2 == 0 and 0 <= oy < ho and 0 <= ox0 < wo
        cols = slice(ox0, min(ox0 + tw, wo))
        skip[b, oy:oy + th, cols] += 1
        # the tile's pool windows: rows oy, oy + 1 and whole column pairs
        assert cols.stop % 2 == 0
        pooled[b, oy // 2, ox0 // 2:cols.stop // 2] += 1
    assert (skip == 1).all() and (pooled == 1).all()


@pytest.mark.parametrize("shape", [(1, 6, 6), (16, 572, 572), (3, 8, 96), (2, 10, 182)])
def test_enc0_plan_at_the_edges(shape):
    """Ho = 2, the serving chunk (31,808 tiles, the last column tile 40
    wide), Wo = 92 (a last tile of 4 columns) and Wo = 178 (of 2); the tile
    order walks row pairs, then column tiles, then images, as the kernel
    does; the grid's blocks take contiguous ranges that cover the walk."""
    plan, tiles = _walk(*shape)
    bsz, h, w = shape
    assert plan.tiles_c == -(-(w - 4) // 88) and plan.tiles_img == (h - 4) // 2 * plan.tiles_c
    assert tiles == [(b, oy, ox) for b in range(bsz) for ox in range(0, w - 4, 88)
                     for oy in range(0, h - 4, 2)]
    if shape == (16, 572, 572):
        assert plan.tiles == 31808 and w - 4 - tiles[-1][2] == 40
    for blocks in (1, min(7, plan.tiles), min(132, plan.tiles)):   # the grid: at most the tiles
        ranges = [tfl.enc0_block_tiles(plan, blocks, i) for i in range(blocks)]
        assert [t for r in ranges for t in r] == list(range(plan.tiles))
        assert all(len(r) >= 1 for r in ranges)


@pytest.mark.parametrize("bsz,h,w", [(0, 8, 8), (1, 5, 8), (1, 8, 7), (1, 4, 8), (1, 8, 4)])
def test_enc0_plan_refuses_what_the_kernel_does_not_take(bsz, h, w):
    with pytest.raises(ValueError):
        tfl.enc0_plan(bsz, h, w)


def test_enc0_chain_route_takes_every_shape_the_kernels_take():
    """"sm90" for C a multiple of 8 up to 64 and H - 4, W - 4 even and
    positive, whatever the dtype; ValueError elsewhere."""
    for c in (8, 16, 24, 64):
        for shape in ((1, 6, 6, 1), (16, 572, 572, 1), (3, 10, 94, 1)):
            for dt in (torch.float32, torch.bfloat16):
                assert tfl.enc0_chain_route(torch.zeros(shape, dtype=dt), c) == "sm90"
    for c, shape in ((12, (1, 6, 6, 1)), (72, (1, 6, 6, 1)), (0, (1, 6, 6, 1)),
                     (8, (1, 7, 6, 1)), (8, (1, 6, 9, 1)), (8, (1, 4, 8, 1))):
        with pytest.raises(ValueError):
            tfl.enc0_chain_route(torch.zeros(shape), c)


@pytest.mark.parametrize("skip_kind", ["bf16", "int8"])
def test_every_route_runs_the_plain_version_on_the_cpu(skip_kind):
    """Both routes, forced, return `enc0_chain_plain`'s maps on a CPU tensor
    and count no launch; an unknown route raises ValueError, on any device."""
    args = [torch.from_numpy(a) for a in _enc0_inputs(4, (2, 10, 94), 8)]
    scale = 0.02 if skip_kind == "int8" else 0.0
    want = tfl.enc0_chain_plain(*args, skip_scale=scale)
    before = (tfl.enc0_chain.launches, tfl.enc0_chain.sm90_launches)
    for route in tfl.ENC0_ROUTES:
        got = tfl._enc0_chain_route_forward(*args, route, skip_scale=scale)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(tfl.enc0_chain(*args, skip_scale=scale), want))
    assert (tfl.enc0_chain.launches, tfl.enc0_chain.sm90_launches) == before
    for route in ("fast", "SM90", None):
        with pytest.raises(ValueError, match="no route"):
            tfl._enc0_chain_route_forward(*args, route, skip_scale=scale)


# (Wo, C): every edge width with every C; Ho alternates 2 and 6 and the skip
# kind alternates over the cases.
EDGE_CASES = [(wo, c) for wo in (2, 88, 90, 178) for c in (8, 24, 64)]


@pytest.mark.parametrize("k", range(len(EDGE_CASES)))
def test_enc0_chain_matches_jax_at_the_strip_edges(k):
    """bf16 x and weights, as the research forward runs it, at the widths
    around the sm90 route's 88-column tile (one tile of 2 columns, exactly
    one, one and a 2-column tile, two and a 2-column tile): the skip and the
    pooled map equal the Pallas kernel's but for a last-bit flip
    (`_assert_last_bit`, test_torch_fused_level0.py's bar)."""
    wo, c = EDGE_CASES[k]
    ho = (2, 6)[k % 2]
    skip_kind = ("bf16", "int8")[(k // 2) % 2]
    args = _enc0_inputs(100 + k, (1, ho + 4, wo + 4), c)
    scale = _skip_scale(args, True) if skip_kind == "int8" else 0.0
    (jskip, jpool), (skip, pooled) = _run_both(args, True, skip_scale=scale)
    assert skip.shape == (1, ho, wo, c) and pooled.shape == (1, ho // 2, wo // 2, c)
    assert skip.dtype == (torch.int8 if scale else torch.bfloat16)
    _assert_last_bit(skip, jskip)
    _assert_last_bit(pooled, jpool)
