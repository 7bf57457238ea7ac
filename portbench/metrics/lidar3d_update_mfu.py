"""lidar3d_update_mfu: the whole scan train's share of the card's peak, in
%: the bank fit's operations a train needs (``work.bank_fit_flops``,
averaged over the traced trains) times the trains of the measured window,
over the window's seconds and the TF32 peak."""

from portbench import work


def read(ctx):
    if ctx.traced is None or not hasattr(ctx.cell, "bank_fit_shapes"):
        return None
    shapes = ctx.cell.bank_fit_shapes()
    if not shapes or ctx.window["seconds"] <= 0:
        return None
    per_update = sum(work.bank_fit_flops(c, d) for _, c, d in shapes) \
        / len(shapes)
    rate = ctx.window["updates"] / ctx.window["seconds"]
    return 100.0 * per_update * rate / work.PEAK_FLOPS
