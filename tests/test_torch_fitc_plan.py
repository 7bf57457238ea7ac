"""The FITC kernel's host-side plan (``ops/fitc.py::fitc_plan``): the tile
grid of beta and dQ and the SYRK's division of the samples that
``csrc/fitc.cu`` runs. Pure arithmetic on the CPU; the kernel itself is held
against the plan on the card (``tests/test_torch_cuda.py``)."""

import pytest

from erl_gaussian_process_tpu_torch.ops.fitc import (
    LAUNCHES,
    SYRK_BLOCKS_PER_SM,
    SYRK_EDGE,
    SYRK_MAX_SPAN,
    TILE,
    fitc_plan,
    lower_tile,
)

# the 3D map's update at one, two and four poses (1152 x 2048, 4096, 8192;
# two poses are a gloo rank's shard of four), the 2D map's (1024, 2048:
# 961 pseudo points padded), ragged and small shapes
SHAPES = [(1152, 2048), (1024, 2048), (1152, 8192), (1152, 4096),
          (1089, 1500), (64, 64), (1, 1), (70, 33), (1152, 2000),
          (300, 4992), (2500, 100)]
SMS = [132, 114, 20]


def _lower(edge, m):
    rows = -(-m // edge)
    return {(r, c) for r in range(rows) for c in range(r + 1)}


# The float32 SYRK's division of the units among its blocks, as
# csrc/fitc.cu's StreamGrid computes it: the oracle the plan's blocks and
# span are held to.
def _units(plan):
    return plan.super_tiles * plan.col_blocks


def _block_units(plan, b):
    """The (super-tile, panel) units block b takes (StreamGrid::first_unit)."""
    return range(b * _units(plan) // plan.blocks,
                 (b + 1) * _units(plan) // plan.blocks)


def _block_of(plan, u):
    """The block whose units hold unit u (StreamGrid::block_of)."""
    return ((u + 1) * plan.blocks - 1) // _units(plan)


def _slot(plan, b, t):
    """The workspace slot of super-tile t's segment in block b
    (StreamGrid::slot)."""
    return b * plan.span + t - _block_units(plan, b).start // plan.col_blocks


def _segments(plan, b):
    """[(super-tile, range of its panels)] of block b, in order."""
    units = _block_units(plan, b)
    out, u = [], units.start
    while u < units.stop:
        t = u // plan.col_blocks
        end = min(units.stop, (t + 1) * plan.col_blocks)
        out.append((t, range(u - t * plan.col_blocks,
                             end - t * plan.col_blocks)))
        u = end
    return out


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n", SHAPES)
def test_plan_covers_every_lower_tile_once(m, n, sms):
    """The float32 SYRK's 128 x 128 super-tiles and the float64 SYRK's
    64 x 64 tiles each cover dQ's lower triangle once."""
    plan = fitc_plan(m, n, sms)
    assert plan.row_blocks == -(-m // TILE)
    assert plan.col_blocks == -(-n // TILE)
    for count, edge in ((plan.super_tiles, SYRK_EDGE), (plan.tiles, TILE)):
        tiles = [lower_tile(b) for b in range(count)]
        assert len(set(tiles)) == len(tiles)
        assert set(tiles) == _lower(edge, m)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n", SHAPES)
def test_plan_splits_cover_every_sample_once(m, n, sms):
    """Float32: each super-tile's segments cover its panels once, in block
    order, none empty, each in a workspace slot of its own, found where the
    kernel finds it (StreamGrid's block_of, slot); float64: the splits cover every
    sample once, none empty."""
    plan = fitc_plan(m, n, sms)
    covered = {t: [] for t in range(plan.super_tiles)}
    slots = set()
    for b in range(plan.blocks):
        segments = _segments(plan, b)
        assert 1 <= len(segments) <= plan.span <= SYRK_MAX_SPAN
        for t, panels in segments:
            assert len(panels) > 0
            covered[t].append((b, panels))
            slots.add(_slot(plan, b, t))
            assert 0 <= _slot(plan, b, t) < plan.blocks * plan.span
    assert len(slots) == sum(len(v) for v in covered.values())
    for t, parts in covered.items():
        panels = [p for _, ps in parts for p in ps]
        assert panels == list(range(plan.col_blocks))
        assert [b for b, _ in parts] == list(range(
            _block_of(plan, t * plan.col_blocks),
            _block_of(plan, (t + 1) * plan.col_blocks - 1) + 1))
    assert plan.chunk % TILE == 0 and plan.splits >= 1
    samples = [j for s in range(plan.splits) for j in plan.split_range(s, n)]
    assert samples == list(range(n))
    assert all(len(plan.split_range(s, n)) > 0 for s in range(plan.splits))
    assert plan.launches == LAUNCHES == 3


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,n", SHAPES)
def test_plan_is_a_pure_function(m, n, sms):
    """The plan depends on (m, n, SMs) alone: computed afresh it is the
    cached one, field for field."""
    assert fitc_plan.__wrapped__(m, n, sms) == fitc_plan(m, n, sms)
    assert fitc_plan.__wrapped__(m, n, sms) == fitc_plan.__wrapped__(m, n,
                                                                     sms)


@pytest.mark.parametrize("m,n", SHAPES)
def test_plan_takes_the_copy_engine_where_rows_start_on_16_bytes(m, n):
    """The plan lets the float32 SYRK's copy engine feed its strips exactly
    where kmn's rows start on 16 bytes (n % 4 == 0), as its tensor maps
    want; the ragged rest through cp.async. The plan's choice is the
    shape's alone."""
    for sms in SMS:
        assert fitc_plan(m, n, sms).copy_engine == (n % 4 == 0)


@pytest.mark.parametrize("sms", [132, 114, 20])
def test_plan_stays_within_one_wave_at_the_hotel0_shape(sms):
    """The float32 SYRK at the map's M = 1152 (N = 2048, 4096, 8192: one
    pose, a gloo rank's two, four): one wave of a block an SM, each
    block's share of the super-tiles x panels within one panel of the
    others (no SM under ~75% of the busiest), so no SM waits on a wave that
    the 45 super-tiles fill in part."""
    for n in (2048, 4096, 8192):
        plan = fitc_plan(1152, n, sms)
        assert plan.super_tiles == 45
        assert plan.blocks == SYRK_BLOCKS_PER_SM * sms
        shares = [len(_block_units(plan, b)) for b in range(plan.blocks)]
        assert max(shares) - min(shares) <= 1
        assert min(shares) >= 0.75 * max(shares)
        assert sum(shares) == plan.super_tiles * plan.col_blocks


@pytest.mark.parametrize("m,n", [(70, 33), (64, 1000), (4992, 4992)])
def test_plan_never_splits_past_a_panel_or_below_one(m, n):
    """Float64: few tiles split down to one 64-sample panel a split at
    most, many tiles keep one split; float32: no more blocks than units,
    no more super-tiles a block than the kernel holds."""
    plan = fitc_plan(m, n, 132)
    assert 1 <= plan.splits <= plan.col_blocks
    if plan.tiles >= 3 * 132:
        assert plan.splits == 1 and plan.chunk >= n
    assert 1 <= plan.blocks <= plan.super_tiles * plan.col_blocks
    assert plan.span <= SYRK_MAX_SPAN
