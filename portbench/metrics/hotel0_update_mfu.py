"""hotel0_update_mfu: the whole map update's share of the card's peak, in
%: the FITC operations an update needs (``work.fitc_flops`` at the samples
the traced poses used, averaged over them) times the updates of the
measured window, over the window's seconds and the TF32 peak. It bounds a
gain however the update is computed, fused or not."""

from portbench import work


def read(ctx):
    if ctx.traced is None or not hasattr(ctx.cell, "fitc_shapes"):
        return None
    shapes = ctx.cell.fitc_shapes()
    if not shapes or ctx.window["seconds"] <= 0:
        return None
    per_update = sum(work.fitc_flops(*s) for s in shapes) / len(shapes)
    rate = ctx.window["updates"] / ctx.window["seconds"]
    return 100.0 * per_update * rate / work.PEAK_FLOPS
