"""exact_query_mfu: the exact GP's test's share of the card's peak, in %:
the device operations the traced queries need
(``exact_work.exact_query_flops``: the cross gram, the mean, the whitening
and the variance) over the seconds those queries took on the host clock,
from the call to the answers on the host, and the TF32 peak."""

from portbench import exact_work, work


def read(ctx):
    if ctx.traced is None or not hasattr(ctx.cell, "exact_query_shapes"):
        return None
    shapes = ctx.cell.exact_query_shapes()
    seconds = sum(ctx.traced["latencies"])
    if not shapes or seconds <= 0:
        return None
    flops = sum(exact_work.exact_query_flops(n, m, d) for n, m, d in shapes)
    return 100.0 * flops / seconds / work.PEAK_FLOPS
