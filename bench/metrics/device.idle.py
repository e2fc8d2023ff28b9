"""Share of the traced slice in which no operation ran on the device: one
less the union of its operations' time over the slice (torch.profiler)."""


def read(ctx):
    t = ctx.drive.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
