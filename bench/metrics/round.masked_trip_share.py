"""Round: the share of the fixed-trip local loop's trips that were masked
no-ops, 1 - sum of the cohorts' taus / (rounds x cohort x tau_max), from
the driver's ``tau_all``. Valid while the loop runs tau_max trips for
every client."""


def read(ctx):
    t = ctx.traffic
    return 100.0 * (1.0 - ctx.active_steps / (ctx.rounds * t["cohort"] * t["tau_max"]))
