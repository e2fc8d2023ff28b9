"""Seconds from the process's start to the window's: imports, the CUDA
context, the weights, the engine, the kernels' build where it is not yet
built, the documents' prefill and the warm-up of the closed loop."""


def read(ctx):
    return ctx.setup_s
