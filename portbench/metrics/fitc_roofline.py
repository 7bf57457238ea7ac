"""fitc_roofline: the FITC kernels' share of their roofline in the traced
slice, in %: the least time the card could take for the increments of the
traced updates (``work.fitc_flops``/``fitc_bytes`` at the samples each pose
used, the map's own count) over the traced device time of the kernels that
compute them (``work.KERNELS["fitc"]``). Nothing when the slice traced no
FITC kernel; a warning when it traced fewer than the wrapper launched."""

from portbench import work


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.cell, "fitc_shapes"):
        return None
    patterns, per_launch = work.KERNELS["fitc"]
    seconds = ctx.trace.kernel_seconds(patterns)
    if seconds <= 0:
        return None
    traced = ctx.trace.kernel_count(patterns)
    expected = ctx.traced["launches"].get("fitc", 0) * per_launch
    if traced < expected:
        ctx.warn(f"fitc_roofline: the trace holds {traced} FITC kernels of "
                 f"the {expected} launched; the share is over the traced ones")
    shapes = ctx.cell.fitc_shapes()
    least = sum(work.least_seconds(work.fitc_flops(*s), work.fitc_bytes(*s))
                for s in shapes)
    return 100.0 * least * traced / max(expected, traced) / seconds
