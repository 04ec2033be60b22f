"""Episodes x steps of every sweep call completed in the window, over the
window (each call ends with its outcomes on the host)."""


def read(ctx):
    win = ctx.window
    return win.solves / win.seconds
