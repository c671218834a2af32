"""Driver: host milliseconds inside the round calls a round
(``TrainDriver.dispatch_s`` over the window's rounds): issuing a round's
launches."""


def read(ctx):
    return 1e3 * ctx.dispatch_s / ctx.rounds
