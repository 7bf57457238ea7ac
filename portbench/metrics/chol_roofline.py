"""chol_roofline: the gram-fused Cholesky's share of its roofline in the
traced slice, in %: the least time for the factorizations of the traced
fits (``exact_work.chol_gram_flops``/``chol_gram_bytes`` at the sets'
samples, the TF32 peak and HBM3's rate) over the traced device time of the
kernels of the ``chol_gram`` wrapper (its updates, diagonal factors and
applies, ``exact_work.CHOL_KERNELS``), counted once where the update of
one column runs beside the diagonal and apply of another on a second
stream. The kernel's updates are 3xTF32 (three TF32 products each), so
its design caps the share at a third. Nothing when the slice traced none;
a warning when it traced fewer than the wrapper launched."""

import copy

from portbench import exact_work, work


def busy_seconds(trace, patterns) -> float:
    """The union of the spans of the kernels whose names hold one of
    ``patterns``: ``Trace.busy_s`` over those kernels alone."""
    kernels = copy.copy(trace)
    kernels.device = [k for k in trace.device
                      if any(p in k[0] for p in patterns)]
    return kernels.busy_s


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.cell, "exact_fit_shapes"):
        return None
    shapes = ctx.cell.exact_fit_shapes()
    patterns = exact_work.CHOL_KERNELS
    seconds = busy_seconds(ctx.trace, patterns)
    if not shapes or seconds <= 0:
        return None
    traced = ctx.trace.kernel_count(patterns)
    expected = ctx.traced["launches"].get("chol_gram", 0) \
        * exact_work.chol_kernels(shapes[0][0])
    if traced < expected:
        ctx.warn(f"chol_roofline: the trace holds {traced} Cholesky "
                 f"kernels of the {expected} launched; the share is over "
                 "the traced ones")
    least = sum(work.least_seconds(exact_work.chol_gram_flops(n, d),
                                   exact_work.chol_gram_bytes(n, d))
                for n, d in shapes)
    return 100.0 * least * traced / max(expected, traced) / seconds
