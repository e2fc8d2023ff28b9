"""Tokens streamed to the clients in the window, per second of it (host
clock, at each client)."""


def read(ctx):
    d = ctx.drive
    n = sum(1 for r in d.records for t in r.times if d.t0 <= t <= d.t1)
    return n / ctx.window_s
