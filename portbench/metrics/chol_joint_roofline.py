"""chol_joint_roofline: the noisy-input GP's joint-gram Cholesky's share of
its roofline in the traced slice, in %: the least time for the
factorizations of the traced fits (``nigp_work.chol_joint_flops``/
``chol_joint_bytes`` at the samples the sets hold, the TF32 peak and
HBM3's rate) over the traced device time of the Cholesky's kernels
(``exact_work.CHOL_KERNELS``: its updates, diagonal factors and applies),
counted once where the update of one column runs beside the diagonal and
apply of another on a second stream. Launches are those of the
``chol_gram_joint`` wrapper, ``exact_work.chol_kernels`` of the joint
system's padded rows each. The updates are 3xTF32, so the design caps the
share at a third. Nothing when the slice traced none; a warning when it
traced fewer than the wrapper launched."""

from portbench import exact_work, nigp_work, work
from portbench.metrics.chol_roofline import busy_seconds


def read(ctx):
    if ctx.trace is None or not hasattr(ctx.cell, "nigp_fit_shapes"):
        return None
    shapes = ctx.cell.nigp_fit_shapes()
    patterns = exact_work.CHOL_KERNELS
    seconds = busy_seconds(ctx.trace, patterns)
    if not shapes or seconds <= 0:
        return None
    traced = ctx.trace.kernel_count(patterns)
    expected = ctx.traced["launches"].get("chol_gram_joint", 0) \
        * exact_work.chol_kernels(shapes[0][2])
    if traced < expected:
        ctx.warn(f"chol_joint_roofline: the trace holds {traced} Cholesky "
                 f"kernels of the {expected} launched; the share is over "
                 "the traced ones")
    least = sum(work.least_seconds(nigp_work.chol_joint_flops(n, d),
                                   nigp_work.chol_joint_bytes(n, d))
                for n, d, _ in shapes)
    return 100.0 * least * traced / max(expected, traced) / seconds
