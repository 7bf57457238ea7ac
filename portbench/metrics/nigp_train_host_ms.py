"""nigp_train_host_ms: the host's ms a fit inside the noisy-input GP's
``train``: the span ``egp.nigp.train`` (the reset and the padded host
arrays, the graph's feed and replay launch) less the jitter retry's
finite check nested in it (``egp.fit.check``, which waits for the card),
summed over the traced slice and divided by its fits. In this cell every
``egp.fit.check`` lies inside an ``egp.nigp.train``. Nothing when the
program records no such span."""

from portbench.metrics import spans


def read(ctx):
    if ctx.trace is None or not ctx.traced["updates"]:
        return None
    s = spans.seconds(ctx.trace, ("egp.nigp.train",))
    if s is None:
        return None
    s -= spans.seconds(ctx.trace, ("egp.fit.check",)) or 0.0
    return 1e3 * s / ctx.traced["updates"]
