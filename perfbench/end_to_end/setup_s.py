"""Seconds from the process's start to the first timed unit: the
interpreter, torch and the CUDA context, the program and its kernel
library (built on a checkout's first run), the inputs, the stack, the
warm-up of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
