"""lidar3d_query_mfu: the routed test's share of the card's peak, in %:
the device operations the traced queries need (``work.routed_test_flops``)
over the seconds those queries took on the host clock, from the call to
the answer on the host, and the TF32 peak."""

from portbench import work


def read(ctx):
    if ctx.traced is None or not hasattr(ctx.cell, "routed_query_shapes"):
        return None
    shapes = ctx.cell.routed_query_shapes()
    seconds = sum(ctx.traced["latencies"])
    if not shapes or seconds <= 0:
        return None
    flops = sum(work.routed_test_flops(q, d) for q, _, d in shapes)
    return 100.0 * flops / seconds / work.PEAK_FLOPS
