"""The model FLOPs the window's computed tokens need (the benchmark's own
count, ``harness.counts``: 2 x active parameters a token, attention over
its keys, the head where logits are used; prefix hits not counted), over
the window's seconds and the card's bf16 peak.  From the traced run's
record of every device program dispatched in the window."""


def read(ctx):
    d, c = ctx.drive, ctx.counts
    flops = 0
    for t, op, info in d.launches:
        if not d.t0 <= t <= d.t1:
            continue
        if op == "decode":
            flops += c.decode_flops(ctx.cfg, info[0])
        elif op == "chunk":
            flops += c.chunk_flops(ctx.cfg, *info)
    if flops == 0:
        return None
    return 100.0 * flops / ctx.window_s / c.PEAK_BF16_FLOPS
