"""Model: the traced rounds' useful model FLOPs (active local steps only,
no recomputed forward) over the traced window at the card's float32 peak:
the whole step's share of the chip, which bounds what any one kernel's
roofline can give."""

from bench import flops


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peaks is None or tr.window_s <= 0:
        return None
    t = ctx.traffic
    useful = flops.window_flops(ctx.config, t["seq"], tr.active_steps * t["batch"], 0)
    return 100.0 * useful / tr.window_s / ctx.peaks["fp32_flops_per_s"]
