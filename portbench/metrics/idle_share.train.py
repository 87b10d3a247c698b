"""Share of the profiled stretch in which no operation ran on the card: 1 −
the union of the device operations' intervals over the stretch's wall time
(one card)."""


def read(ctx):
    return 100.0 * (1.0 - ctx.profile.busy_s() / ctx.profile.wall_s)
