"""Model: device milliseconds of matrix-product kernels (by name) a
traced round."""

NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    s, n = tr.kernel_seconds(lambda name: any(w in name.lower() for w in NAMES))
    return 1e3 * s / tr.rounds if n else None
