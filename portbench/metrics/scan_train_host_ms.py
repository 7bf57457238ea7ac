"""scan_train_host_ms: the host's ms a train inside the sensor GP's scan
train, the span ``egp.rsgp.train`` (``RangeSensorGaussianProcess3D.train``:
the frame and the mapping, the graph's feed and replay launch), summed
over the traced slice and divided by its updates. Nothing when the program
records no such span."""

from portbench.metrics.spans import seconds


def read(ctx):
    if ctx.trace is None or not ctx.traced["updates"]:
        return None
    s = seconds(ctx.trace, ("egp.rsgp.train",))
    return None if s is None else 1e3 * s / ctx.traced["updates"]
