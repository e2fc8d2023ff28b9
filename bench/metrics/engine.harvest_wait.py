"""Share of the window the server's engine thread spent blocked on the
card for a step's tokens (EngineStats.harvest_wait_s)."""


def read(ctx):
    s0, s1 = ctx.drive.stats0, ctx.drive.stats1
    return 100.0 * (s1.harvest_wait_s - s0.harvest_wait_s) / ctx.window_s
