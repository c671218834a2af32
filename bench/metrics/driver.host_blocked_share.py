"""Driver: the share of the window the host spent blocked on the deferred
device-to-host reads (``TrainDriver.host_blocked_s``). Near 0: the host
sets the pace; near 100: the device does."""


def read(ctx):
    return 100.0 * ctx.host_blocked_s / ctx.window_s
