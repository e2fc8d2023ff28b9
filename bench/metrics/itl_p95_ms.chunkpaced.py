"""95th percentile of every gap between consecutive tokens of a request
that both reached its client in the window (host clock), where that tail
is paced by the prefill chunks: a step's length is set by how many
question chunks the scheduler puts into it, so the gaps sit on levels a
chunk apart and the percentile jumps by a level from run to run.  It is
read per layer, with no bound, in the cells where it is so."""

from harness.stats import percentile


def read(ctx):
    d = ctx.drive
    gaps = [(b - a) * 1e3 for r in d.records
            for a, b in zip(r.times, r.times[1:]) if d.t0 <= a and b <= d.t1]
    return percentile(gaps, 95)
