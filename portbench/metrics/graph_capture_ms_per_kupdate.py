"""graph_capture_ms_per_kupdate: the host's ms spent capturing CUDA
graphs (each capture's eager warm-up and the capture, the program's
``graph.capture_ms``) per 1000 updates, over the window and the traced
slice: a map session's first pose captures its update graph. Nothing when
the program does not count them."""

from portbench.metrics.counters import counted, snapshot


def install(ctx):
    ctx.capture_before = snapshot()


def read(ctx):
    ms = counted(ctx.capture_before, "graph.capture_ms")
    updates = ctx.window["updates"] + (ctx.traced["updates"]
                                       if ctx.traced else 0)
    if ms is None or not updates:
        return None
    return 1e3 * ms / updates
