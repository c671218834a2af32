"""Kernels: device milliseconds of the rmsnorm kernel (``rmsnorm_kernel``)
a traced round: 4L + 1 forward launches a local step under remat, each
over the cohort's batch x seq rows."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s, n = tr.kernel_seconds(lambda name: "rmsnorm_kernel" in name)
    return 1e3 * s / tr.rounds if n else None
