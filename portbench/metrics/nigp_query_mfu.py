"""nigp_query_mfu: the noisy-input GP's test's share of the card's peak, in
%: the device operations the traced queries need
(``nigp_work.nigp_query_flops``: the cross gram with gradient columns, the
mean and the gradient, the whitening, the variances and covariances) over
the seconds those queries took on the host clock, from the call to the
answers on the host, and the TF32 peak."""

from portbench import nigp_work, work


def read(ctx):
    if ctx.traced is None or not hasattr(ctx.cell, "nigp_query_shapes"):
        return None
    shapes = ctx.cell.nigp_query_shapes()
    seconds = sum(ctx.traced["latencies"])
    if not shapes or seconds <= 0:
        return None
    flops = sum(nigp_work.nigp_query_flops(n, m, d) for n, m, d in shapes)
    return 100.0 * flops / seconds / work.PEAK_FLOPS
