"""90th percentile, over every request whose first token reached its
client in the window, of the time from the client's submit to that token
(host clock)."""

from harness.stats import percentile


def read(ctx):
    d = ctx.drive
    return percentile([(r.times[0] - r.t_submit) * 1e3 for r in d.records
                       if r.times and d.t0 <= r.times[0] <= d.t1], 90)
