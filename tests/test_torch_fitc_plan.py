"""The FITC kernel's host-side plan (``ops/fitc.py::fitc_plan``): the tile
grid of beta and dQ and the N-split of the SYRK that ``csrc/fitc.cu`` runs.
Pure arithmetic on the CPU; the kernel itself is held against the plan on
the card (``tests/test_torch_cuda.py``)."""

import pytest

from erl_gaussian_process_tpu_torch.ops.fitc import (
    LAUNCHES,
    SYRK_BLOCKS_PER_SM,
    TILE,
    fitc_plan,
    lower_tile,
)

# the 3D map's (1152, 2048) and the 2D map's (1024, 2048: 961 pseudo
# points padded), ragged and small shapes
SHAPES = [(1152, 2048), (1024, 2048), (1089, 1500), (70, 33), (1152, 2000),
          (64, 64), (1, 1), (300, 4992), (2500, 100)]


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("m,n", SHAPES)
def test_plan_covers_every_lower_tile_once(m, n, sms):
    plan = fitc_plan(m, n, sms)
    rb = -(-m // TILE)
    assert plan.row_blocks == rb and plan.col_blocks == -(-n // TILE)
    tiles = [lower_tile(b) for b in range(plan.tiles)]
    assert len(set(tiles)) == len(tiles)
    assert set(tiles) == {(r, c) for r in range(rb) for c in range(r + 1)}


@pytest.mark.parametrize("sms", [132, 20])
@pytest.mark.parametrize("m,n", SHAPES)
def test_plan_splits_cover_every_sample_once(m, n, sms):
    plan = fitc_plan(m, n, sms)
    assert plan.chunk % TILE == 0 and plan.splits >= 1
    covered = [j for s in range(plan.splits) for j in plan.split_range(s, n)]
    assert covered == list(range(n))
    assert all(len(plan.split_range(s, n)) > 0 for s in range(plan.splits))
    assert plan.launches == LAUNCHES == 3


@pytest.mark.parametrize("sms", [132, 114, 20])
def test_plan_stays_within_one_wave_at_the_hotel0_shape(sms):
    """171 lower tiles of dQ: as many splits as keep the SYRK within
    SYRK_BLOCKS_PER_SM blocks per SM, and no more; two splits of 1024
    samples on an H100 (342 blocks)."""
    plan = fitc_plan(1152, 2048, sms)
    assert plan.tiles * plan.splits <= max(plan.tiles,
                                           SYRK_BLOCKS_PER_SM * sms)
    assert plan.tiles * (plan.splits + 1) > SYRK_BLOCKS_PER_SM * sms
    if sms == 132:
        assert (plan.tiles, plan.splits, plan.chunk) == (171, 2, 1024)


@pytest.mark.parametrize("m,n", [(70, 33), (64, 1000), (4992, 4992)])
def test_plan_never_splits_past_a_panel_or_below_one(m, n):
    """Few tiles split down to one 64-sample panel a split at most; many
    tiles keep one split."""
    plan = fitc_plan(m, n, 132)
    assert plan.splits <= plan.col_blocks
    if plan.tiles >= SYRK_BLOCKS_PER_SM * 132:
        assert plan.splits == 1 and plan.chunk >= n
