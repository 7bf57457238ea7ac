"""gram_roofline.query: the routed test's gram kernel's share of its
roofline in the traced slice, in %: the least time for the gram each
traced query needs (every valid direction against the hits of the member
that answers it, ``work.routed_gram_flops``/``routed_gram_bytes``) over
the traced device time of the gram kernel (``work.KERNELS["gram"]``).
Padding to the routed bucket's shape is work the roofline does not count.
Nothing when the slice traced no gram kernel; a warning when it traced
fewer than the wrappers launched."""

from portbench import work


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.cell, "routed_query_shapes"):
        return None
    patterns, per_launch = work.KERNELS["gram"]
    seconds = ctx.trace.kernel_seconds(patterns)
    if seconds <= 0:
        return None
    traced = ctx.trace.kernel_count(patterns)
    launches = ctx.traced["launches"]
    expected = (launches.get("gram", 0) + launches.get("gram_batched", 0)) \
        * per_launch
    if traced < expected:
        ctx.warn(f"gram_roofline.query: the trace holds {traced} gram "
                 f"kernels of the {expected} launched; the share is over "
                 "the traced ones")
    least = sum(work.least_seconds(work.routed_gram_flops(q, d),
                                   work.routed_gram_bytes(q, m, d))
                for q, m, d in ctx.cell.routed_query_shapes())
    return 100.0 * least * traced / max(expected, traced) / seconds
