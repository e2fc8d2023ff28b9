"""The paged attention kernel's share of its roofline over the traced
slice: the least time its launches could take (each layer of each decode
step and prompt chunk dispatched in the slice: the larger of its bytes
over the HBM bandwidth and its operations over the bf16 peak,
``harness.counts``) over the device time of every ``paged_attention_kernel``
launch in the slice's trace."""

KERNEL = "paged_attention_kernel"


def read(ctx):
    d, c = ctx.drive, ctx.counts
    if d.trace is None:
        return None
    kernel_s = sum(s for name, s in d.trace.op_s.items() if KERNEL in name)
    if kernel_s <= 0:
        return None
    a, b = d.slice_launches
    ps = ctx.settings["page_size"]
    least = 0.0
    for _t, op, info in d.launches[a:b]:
        if op == "decode":
            least += c.least_time(*c.paged_decode_cost(ctx.cfg, info[0], ps))
        elif op == "chunk":
            least += c.least_time(*c.paged_prefill_cost(ctx.cfg, info[0],
                                                        info[1], ps))
    return 100.0 * least * ctx.n_layers / kernel_s
