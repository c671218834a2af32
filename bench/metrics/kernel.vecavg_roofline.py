"""Kernels: the vecavg reduce's share of its roofline: the bytes its two
calls a round need (the cohort's [C, D] float32 rows read, [D] written, p,
the norms and, for the global step, the divisors), over the card's memory
bandwidth, against the traced mean time of a ``vecavg_kernel``."""

from bench import flops


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.peaks is None:
        return None
    s, n = tr.kernel_seconds(lambda name: "vecavg_kernel" in name)
    if not n:
        return None
    C, D = ctx.traffic["cohort"], ctx.params
    need = (flops.vecavg_bytes(C, D, div=True) + flops.vecavg_bytes(C, D, div=False)) / 2
    return 100.0 * (need / ctx.peaks["hbm_bytes_per_s"]) / (s / n)
