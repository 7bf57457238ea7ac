"""The device's idle share of a traced slice, shared by the
``device_idle.*`` readers."""

from portbench import work


def idle_share(ctx, name: str):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    launches = dict(ctx.traced["launches"])
    launches["gram"] = launches.get("gram", 0) + launches.pop(
        "gram_batched", 0)
    for wrapper, (patterns, per_launch) in work.KERNELS.items():
        expected = launches.get(wrapper, 0) * per_launch
        traced = ctx.trace.kernel_count(patterns)
        if traced < expected:
            ctx.warn(f"{name}: the trace holds {traced} {wrapper} kernels "
                     f"of the {expected} launched; lost kernels read as "
                     "idle time")
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
