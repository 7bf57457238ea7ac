"""routed_test_host_ms: the host's own ms a query in the routed test's
numpy phases: the self time of ``egp.rsgp.route`` (directions to the
frame, the member of each), ``egp.bank.group`` (the grouping into the
bucket, the trained mask read back) and ``egp.bank.scatter`` (the answers
into the outputs), summed over the traced slice and divided by its
queries. Nothing when the program records no such span."""

from portbench.metrics.spans import self_seconds

SPANS = ("egp.rsgp.route", "egp.bank.group", "egp.bank.scatter")


def read(ctx):
    if ctx.trace is None or not ctx.traced["queries"]:
        return None
    s = self_seconds(ctx.trace, SPANS)
    return None if s is None else 1e3 * s / ctx.traced["queries"]
