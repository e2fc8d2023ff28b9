"""Share of the window's prompt tokens served from the prefix cache: the
hits over the hits plus the tokens pushed through prefill chunks
(EngineStats).  Nothing to read where the cell runs no prefix cache."""


def read(ctx):
    if not ctx.settings["prefix_cache"]:
        return None
    s0, s1 = ctx.drive.stats0, ctx.drive.stats1
    hit = s1.prefix_hit_tokens - s0.prefix_hit_tokens
    pushed = s1.prompt_tokens - s0.prompt_tokens
    if hit + pushed <= 0:
        return None
    return 100.0 * hit / (hit + pushed)
