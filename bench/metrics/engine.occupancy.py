"""Share of the decode batch's slots that decoded a token: the window's
decode tokens over its decode steps times the slots (EngineStats)."""


def read(ctx):
    s0, s1 = ctx.drive.stats0, ctx.drive.stats1
    steps = s1.steps - s0.steps
    if steps <= 0:
        return None
    return 100.0 * (s1.decode_tokens - s0.decode_tokens) / (
        steps * ctx.settings["n_slots"])
