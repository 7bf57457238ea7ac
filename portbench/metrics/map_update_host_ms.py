"""map_update_host_ms: the host's ms a pose inside the map's update, the
span ``egp.map.update`` (``SpGpOccupancyMap.update_batch``: the inputs,
the graph's feed and replay launch, a session's first capture), summed
over the traced slice and divided by its updates. Nothing when the
program records no such span."""

from portbench.metrics.spans import seconds


def read(ctx):
    if ctx.trace is None or not ctx.traced["updates"]:
        return None
    s = seconds(ctx.trace, ("egp.map.update",))
    return None if s is None else 1e3 * s / ctx.traced["updates"]
