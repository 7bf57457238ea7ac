"""bank_fit_roofline: the bank-fit kernel's share of its roofline in the
traced slice, in %: the least time for the fits of the traced trains
(``work.bank_fit_flops``/``bank_fit_bytes``, each member at its own hit
count, the bank's padded layout written) over the traced device time of
the kernel (``work.KERNELS["bank_fit"]``). Nothing when the slice traced
none; a warning when it traced fewer than the wrapper launched."""

from portbench import work


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.cell, "bank_fit_shapes"):
        return None
    patterns, per_launch = work.KERNELS["bank_fit"]
    seconds = ctx.trace.kernel_seconds(patterns)
    if seconds <= 0:
        return None
    traced = ctx.trace.kernel_count(patterns)
    expected = ctx.traced["launches"].get("bank_fit", 0) * per_launch
    if traced < expected:
        ctx.warn(f"bank_fit_roofline: the trace holds {traced} bank-fit "
                 f"kernels of the {expected} launched; the share is over "
                 "the traced ones")
    least = sum(work.least_seconds(work.bank_fit_flops(counts, d),
                                   work.bank_fit_bytes(len(counts), width, d))
                for width, counts, d in ctx.cell.bank_fit_shapes())
    return 100.0 * least * traced / max(expected, traced) / seconds
