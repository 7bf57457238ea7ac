"""nigp_test_host_ms: the host's ms a query in the noisy-input GP's test:
the spans ``egp.nigp.test`` (the feed and the test graph's replay
launch), ``egp.nigp.mean``, ``egp.nigp.gradient`` and
``egp.nigp.variance`` (the variance graph's replay launch) less the copies
to the host nested in them (``egp.nigp.readback``, which wait for the card
and lie only inside those spans), summed over the traced slice and divided
by its queries. Nothing when the program records no such span."""

from portbench.metrics import spans

SPANS = ("egp.nigp.test", "egp.nigp.mean", "egp.nigp.gradient",
         "egp.nigp.variance")


def read(ctx):
    if ctx.trace is None or not ctx.traced["queries"]:
        return None
    s = spans.seconds(ctx.trace, SPANS)
    if s is None:
        return None
    s -= spans.seconds(ctx.trace, ("egp.nigp.readback",)) or 0.0
    return 1e3 * s / ctx.traced["queries"]
