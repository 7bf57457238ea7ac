"""device_idle.query: the share of the traced slice in which no operation
ran on the card, in %, in a cell whose end-to-end metrics are query
latencies. Every counted wrapper's kernels are held to its launches first:
a trace that lost kernels is reported, since it reads as idle time."""

from portbench.metrics.idle import idle_share


def read(ctx):
    return idle_share(ctx, "device_idle.query")
