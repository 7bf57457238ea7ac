"""nigp_fit_mfu: the noisy-input GP's fit's share of the card's peak, in %:
the operations a fit needs (``nigp_work.nigp_fit_flops``: the joint gram,
the Cholesky and the two substitutions) times the fits of the measured
window, over the window's seconds and the TF32 peak."""

from portbench import nigp_work, work


def read(ctx):
    if ctx.traced is None or not hasattr(ctx.cell, "nigp_fit_shapes"):
        return None
    shapes = ctx.cell.nigp_fit_shapes()
    if not shapes or ctx.window["seconds"] <= 0:
        return None
    per_fit = sum(nigp_work.nigp_fit_flops(n, d) for n, d, _ in shapes) \
        / len(shapes)
    rate = ctx.window["updates"] / ctx.window["seconds"]
    return 100.0 * per_fit * rate / work.PEAK_FLOPS
